"""grid_tpu_torch threshold dipCN against grid_tpu's XLA formulation and its
Pallas kernel (interpret mode) on forced-tie inputs.

Tolerances: ``ok`` exact. dipCN float64 at 1e-9 (docs/parity.md); float32
at 1e-6 relative — the take-set is the same, only the order of the masked
row sum differs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grid_tpu.ops.knn import d2_matrix as j_d2_matrix
from grid_tpu.ops.pallas_select import dipcn_from_distances_pallas as j_dipcn_pallas
from grid_tpu.ops.select import dipcn_from_distances as j_dipcn
from grid_tpu.ops.select import dipcn_from_distances_multi as j_dipcn_multi
from grid_tpu.ops.select import smallest_k_mask as j_smallest_k_mask
from grid_tpu_torch.ops.gpu_select import dipcn_from_distances_gpu
from grid_tpu_torch.ops.knn import sorted_smallest_k
from grid_tpu_torch.ops.select import dipcn_from_distances, smallest_k_mask


def _tie_inputs(dt, seed=1, n=97, r=16):
    """The forced-tie case of tests/test_pallas_kernels.py:86-91: z rounded
    to 1/4, so many distances tie exactly."""
    rng = np.random.default_rng(seed)
    zp = (np.round(rng.normal(size=(n, r)) * 4) / 4).astype(dt)
    rnorm = rng.uniform(0.5, 2.0, n).astype(dt)
    usable = rng.random(n) > 0.2
    valid = rng.random(n) > 0.1
    d2 = np.array(j_d2_matrix(jnp.asarray(zp), row_valid=jnp.asarray(valid)))  # writable copy
    return d2, rnorm, usable, valid


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("k", [1, 20, 96])
def test_smallest_k_mask(dt, k):
    d2, _, _, _ = _tie_inputs(dt)
    got = smallest_k_mask(torch.from_numpy(d2), k).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_smallest_k_mask(jnp.asarray(d2), k)))
    assert (got.sum(axis=1) == k).all()
    # per-row k, including rows that take nothing
    k_rows = np.arange(d2.shape[0]) % 5
    got = smallest_k_mask(torch.from_numpy(d2), torch.from_numpy(k_rows)).numpy()
    want = np.asarray(j_smallest_k_mask(jnp.asarray(d2), jnp.asarray(k_rows, jnp.int32)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dt,rtol", [(np.float64, 1e-9), (np.float32, 1e-6)])
@pytest.mark.parametrize("k,n_nbr", [(20, 7), (60, 50), (96, 300)])
def test_dipcn_matches_xla_formulation(dt, rtol, k, n_nbr):
    d2, rnorm, usable, valid = _tie_inputs(dt)
    want, wok = j_dipcn(jnp.asarray(d2), jnp.asarray(rnorm), jnp.asarray(rnorm),
                        jnp.asarray(usable), jnp.asarray(usable), k=k, n_nbr=n_nbr)
    got, gok = dipcn_from_distances(*_torch(d2, rnorm, rnorm, usable, usable), k=k, n_nbr=n_nbr)
    wok = np.asarray(wok)
    np.testing.assert_array_equal(gok.numpy(), wok)
    np.testing.assert_allclose(got.numpy()[wok], np.asarray(want)[wok], rtol=rtol)


@pytest.mark.parametrize("row_block", [32, 97, 128])
def test_dipcn_matches_pallas_kernel(row_block):
    d2, rnorm, usable, valid = _tie_inputs(np.float32)
    want, wok = j_dipcn_pallas(jnp.asarray(d2), jnp.asarray(rnorm), jnp.asarray(rnorm),
                               jnp.asarray(usable), jnp.asarray(usable), k=20, n_nbr=7,
                               row_block=row_block, interpret=True)
    args = _torch(d2, rnorm, rnorm, usable, usable)
    before = dipcn_from_distances_gpu.launches
    got, gok = dipcn_from_distances_gpu(*args, k=20, n_nbr=7)
    assert dipcn_from_distances_gpu.launches == before  # CPU tensors: the plain route
    wok = np.asarray(wok)
    np.testing.assert_array_equal(gok.numpy(), wok)
    np.testing.assert_allclose(got.numpy()[wok], np.asarray(want)[wok], rtol=1e-6)


def test_dipcn_no_usable_neighbor_is_not_ok():
    d2, rnorm, usable, valid = _tie_inputs(np.float64)
    usable[:] = False
    _, ok = dipcn_from_distances(*_torch(d2, rnorm, rnorm, usable, valid), k=20, n_nbr=7)
    assert not ok.any()


# ---------------------------------------------------------------------------
# The arithmetic of csrc/dipcn_select.cu, emulated row by row in numpy. The
# kernel runs only on the card; this is where its algorithm meets the
# reference on the CPU. The emulation ships on no path.
# ---------------------------------------------------------------------------

_THREADS = 128  # kThreads
_DIGIT_BITS = 8  # kDigitBits
_BIG_KEY = 0x7F7FFFFF  # finfo(float32).max as int32
_INT_MAX = 2**31 - 1


def _radix_select(keys, lo, span, rank, cap=0):
    """The kernel's select_rank: the rank-th smallest key in [lo, lo+span]
    by 8-bit digits of key - lo from the top of span; once a round leaves
    at most ``cap`` keys in play, later rounds see only those. Returns (t,
    count of in-range keys < t, histogram rounds)."""
    bits, base, below, rounds = int(span).bit_length(), 0, 0, 0
    while bits > 0:
        d = min(_DIGIT_BITS, bits)
        shift = bits - d
        v = keys - lo
        rel = v - base
        play = (keys >= lo) & (v <= span) & (rel >= 0) & ((rel >> shift) < (1 << d))
        hist = np.bincount((rel[play] >> shift).astype(np.int64), minlength=1 << _DIGIT_BITS)
        cum = np.cumsum(hist)
        b = int(np.searchsorted(cum, rank - below))  # first bin whose prefix reaches the rank
        below += int(cum[b] - hist[b])
        base += b << shift
        bits, rounds = shift, rounds + 1
        if bits > 0 and hist[b] <= cap:  # the gather: the keys still in play
            keys = keys[play & ((rel >> shift) == b)]
            assert keys.size == hist[b]
            cap = 0
    return lo + base, below, rounds


def _chunks(n, threads):
    """Each thread's contiguous [c0, c1) of n entries (odd chunk length)."""
    chunk = -(-n // threads) | 1
    return [(min(t * chunk, n), min(t * chunk + chunk, n)) for t in range(threads)]


def _emulate_compaction(lst, lk, t2, need2):
    """Step 5m of the multi-weight form: rounds of _THREADS list entries,
    one exclusive scan of (tie, below) per round, each taken entry moved to
    its place in the same list. Returns the list's first entries, the
    take-set in list order."""
    lst = lst.copy()
    ties_before = below_before = 0
    for i0 in range(0, len(lst), _THREADS):
        idx = np.arange(i0, min(i0 + _THREADS, len(lst)))
        tie, below = lk[idx] == t2, lk[idx] < t2
        pre_tie, pre_below = np.cumsum(tie) - tie, np.cumsum(below) - below
        cols = lst[idx].copy()  # the round's reads end at the scan's barrier
        for a, i in enumerate(idx):
            rank = ties_before + pre_tie[a]
            if below[a] or (tie[a] and rank < need2):
                place = below_before + pre_below[a] + min(rank, need2)
                assert place <= i  # an entry never moves up
                lst[place] = cols[a]
        ties_before += int(tie.sum())
        below_before += int(below.sum())
    return lst[:below_before + min(ties_before, need2)]


def _emulate_dipcn_kernel(d2, rnorm, nbr_w, usable, valid, k, n_nbr):
    """(dipcn, ok, k-set mask, histogram rounds per row) as the kernel
    computes them; with [W, L] ``nbr_w`` (rnorm and valid [N, L]) as its
    multi-weight form does, from the same take-set."""
    n, w = d2.shape
    keys_all = d2.view(np.int32).astype(np.int64)
    multi = nbr_w.ndim == 2
    dip = np.zeros(rnorm.shape, np.float32)
    ok = np.zeros(rnorm.shape, bool)
    in_k = np.zeros((n, w), bool)
    rounds = np.zeros(n, int)
    for row in range(n):
        keys = keys_all[row]
        body = keys < _BIG_KEY
        n_body = int(body.sum())
        lo = int(keys[body].min()) if n_body else _BIG_KEY
        cap = min(k, w)  # the list buffer, free during the first select
        if k <= n_body:
            t, below, r1 = _radix_select(keys, lo, int(keys[body].max()) - lo, k, cap)
        else:
            t, below, r1 = _radix_select(keys, _BIG_KEY, _INT_MAX - _BIG_KEY, k - n_body, cap)
            below += n_body
        need = k - below
        assert 1 <= need
        # one exclusive scan of (ties, usable below, usable ties) per chunk
        chunks = _chunks(w, _THREADS)
        counts = np.array([[int((keys[a:b] == t).sum()),
                            int(((keys[a:b] < t) & usable[a:b]).sum()),
                            int(((keys[a:b] == t) & usable[a:b]).sum())] for a, b in chunks])
        pre = np.cumsum(counts, axis=0) - counts
        n_below_usable = int(counts[:, 1].sum())
        lst = np.full(min(k, w), -1)
        list_len = None
        for (a, b), (ties, pos_below, pos_tie) in zip(chunks, pre):
            pos_tie += n_below_usable
            for j in range(a, b):
                if keys[j] < t:
                    in_k[row, j] = True
                    if usable[j]:
                        lst[pos_below] = j
                        pos_below += 1
                elif keys[j] == t:
                    ties += 1
                    if ties <= need:
                        in_k[row, j] = True
                        if usable[j]:
                            lst[pos_tie] = j
                            pos_tie += 1
                        if ties == need:
                            list_len = pos_tie
        lst = lst[:list_len]
        assert (lst >= 0).all() and (np.diff(lst[:n_below_usable]) > 0).all()
        m_eff = min(list_len, n_nbr)
        r2 = 0
        if m_eff == list_len:  # take the whole list
            take = np.ones(list_len, bool)
            taken = lst
        else:
            lk = keys[lst]
            t2, below2, r2 = _radix_select(lk, lo, t - lo, m_eff)
            need2 = m_eff - below2
            # the ties at t2 by tie rank in list order, through a chunk scan
            take = np.zeros(list_len, bool)
            c2 = _chunks(list_len, _THREADS)
            tie_pre = np.cumsum([int((lk[a:b] == t2).sum()) for a, b in c2])
            for (a, b), ties2 in zip(c2, np.concatenate([[0], tie_pre[:-1]])):
                for i in range(a, b):
                    if lk[i] < t2:
                        take[i] = True
                    elif lk[i] == t2:
                        ties2 += 1
                        take[i] = ties2 <= need2
            taken = _emulate_compaction(lst, lk, t2, need2)
        np.testing.assert_array_equal(taken, lst[take])  # compacted in list order
        rounds[row] = r1 + r2
        if multi:  # one float64 sum per locus over the compacted list, in its order
            total = nbr_w[taken].astype(np.float64).sum(axis=0).astype(np.float32)
            dip[row] = rnorm[row].astype(np.float32) / (total / np.float32(max(m_eff, 1)))
            ok[row] = valid[row] & (m_eff > 0)
            continue
        total = np.float32(nbr_w[lst[take]].sum(dtype=np.float32))
        dip[row] = np.float32(rnorm[row]) / (total / np.float32(max(m_eff, 1)))
        ok[row] = valid[row] and m_eff > 0
    return dip, ok, in_k, rounds


def _narrow_band_inputs(seed=3, n=97):
    """Distances in a narrow band, as in the 1000G-scale cohort (every
    off-diagonal distance in 3,830-5,185, so the keys differ only in their
    low ~22 bits), with some exact ties and the finfo.max of self and of
    invalid rows."""
    rng = np.random.default_rng(seed)
    d2 = rng.uniform(3830, 5185, (n, n)).astype(np.float32)
    d2[:, 7] = d2[:, 3]  # exact ties between two columns
    valid = rng.random(n) > 0.1
    d2[:, ~valid] = np.finfo(np.float32).max
    np.fill_diagonal(d2, np.finfo(np.float32).max)
    rnorm = rng.uniform(0.5, 2.0, n).astype(np.float32)
    return d2, rnorm, rng.random(n) > 0.2, valid


def _all_equal_inputs(seed=4, n=97):
    """z all zero: every off-diagonal distance is 0."""
    rng = np.random.default_rng(seed)
    valid = rng.random(n) > 0.1
    d2 = np.array(j_d2_matrix(jnp.zeros((n, 16), jnp.float32), row_valid=jnp.asarray(valid)))
    return d2, rng.uniform(0.5, 2.0, n).astype(np.float32), rng.random(n) > 0.2, valid


_KERNEL_INPUTS = {
    "forced-tie": lambda: _tie_inputs(np.float32),
    "narrow-band": _narrow_band_inputs,
    "all-equal": _all_equal_inputs,
}


@pytest.mark.parametrize("case", sorted(_KERNEL_INPUTS))
@pytest.mark.parametrize("k,n_nbr", [(20, 7), (60, 50), (96, 300), (97, 40)])
def test_dipcn_kernel_arithmetic(case, k, n_nbr):
    """Histogram select from the row's own range, one-scan tie cut and the
    second select on the compacted list, against the Pallas kernel
    (interpret mode) and grid_tpu's smallest_k_mask."""
    d2, rnorm, usable, valid = _KERNEL_INPUTS[case]()
    got, gok, in_k, rounds = _emulate_dipcn_kernel(d2, rnorm, rnorm, usable, valid, k, n_nbr)
    np.testing.assert_array_equal(in_k, np.asarray(j_smallest_k_mask(jnp.asarray(d2), k)))
    want, wok = j_dipcn_pallas(jnp.asarray(d2), jnp.asarray(rnorm), jnp.asarray(rnorm),
                               jnp.asarray(usable), jnp.asarray(valid), k=k, n_nbr=n_nbr,
                               interpret=True)
    wok = np.asarray(wok)
    np.testing.assert_array_equal(gok, wok)
    np.testing.assert_allclose(got[wok], np.asarray(want)[wok], rtol=1e-6)
    # where the k-th key lies in a narrow band (~21 bits), each select takes
    # 3 histogram rounds (the header's count), not 31 bisection rounds; at
    # most 4 each over a full 32-bit span
    assert rounds.max() <= 8
    if case == "narrow-band":
        in_band = (d2 < np.finfo(np.float32).max).sum(axis=1) >= k
        assert rounds[in_band].max(initial=0) <= 6


@pytest.mark.parametrize("case", sorted(_KERNEL_INPUTS))
@pytest.mark.parametrize("k,n_nbr", [(20, 7), (60, 50), (97, 40)])
def test_dipcn_multi_kernel_arithmetic(case, k, n_nbr):
    """The multi-weight form's in-place compaction of the take-set and its
    per-locus sums, against grid_tpu's dipcn_from_distances_multi (float32)
    on 6 loci."""
    d2, _, usable, _ = _KERNEL_INPUTS[case]()
    n, w = d2.shape
    rng = np.random.default_rng(n + k)
    rnorm = rng.uniform(0.5, 2.0, (n, 6)).astype(np.float32)
    nbr_w = rng.uniform(0.5, 2.0, (w, 6)).astype(np.float32)
    valid = rng.random((n, 6)) > 0.1
    got, gok, _, _ = _emulate_dipcn_kernel(d2, rnorm, nbr_w, usable, valid, k, n_nbr)
    want, wok = j_dipcn_multi(jnp.asarray(d2), jnp.asarray(rnorm), jnp.asarray(nbr_w),
                              jnp.asarray(usable), jnp.asarray(valid), k=k, n_nbr=n_nbr)
    wok = np.asarray(wok)
    np.testing.assert_array_equal(gok, wok)
    np.testing.assert_allclose(got[wok], np.asarray(want)[wok], rtol=1e-6)


# ---------------------------------------------------------------------------
# The arithmetic of csrc/knn_select.cu (exact sorted k-smallest selection),
# emulated row by row in numpy: the row split into the slices of a cluster's
# blocks, the radix select over the blocks' summed histograms (each block
# gathering its own keys once few are in play), the tie cut and compaction
# by warp walks with ballot ranks behind the counts of the slices before,
# into a list of entries key * 2^32 + column, and the bitonic sort of that
# list with a lane's 4 entries in registers, the strides within a warp by
# shuffles and only the widest through shared memory. Held exactly, values
# and positions, to grid_tpu's sorted_smallest_k and to lax.top_k.
# ---------------------------------------------------------------------------

_WARPS = _THREADS // 32
_E = 4  # kE: list entries a lane holds
_SPAN = 32 * _E  # kSpan: entries a warp sorts in registers
_SLICE_TARGET = 8192  # kSliceTarget
_MAX_CLUSTER = 8  # kMaxCluster
_WIDE_GATHER = 2048  # kWideGather
_PAD = np.uint64(2**64 - 1)


def _knn_cluster(w):
    """default_cluster: the least power of two <= 8 that keeps a slice
    within 8,192 columns."""
    c = 1
    while c < _MAX_CLUSTER and -(-w // c) > _SLICE_TARGET:
        c *= 2
    return c


def _knn_slices(w, c):
    """slice_of: block r of a cluster of c holds columns [r*s, (r+1)*s),
    s a multiple of 4 where c > 1 (some trailing blocks may hold none)."""
    s = w if c == 1 else -(-(-(-w // c)) // 4) * 4
    return [(min(r * s, w), min(r * s + s, w)) for r in range(c)]


def _cluster_select(slices, lo, span, rank, cap, extra=0):
    """select_rank over a cluster: each block counts the keys of its own
    slice, the C histograms are summed. Once the row holds at most ``cap``
    keys at or below the chosen bin (``extra`` keys lie below lo), each
    block keeps those of its own, and later rounds count only them.
    Returns (t, count of the row's keys < t, count equal to t (-1 where no
    round ran), whether the blocks gathered, histogram rounds)."""
    bits, base, below, ties, rounds = int(span).bit_length(), 0, 0, -1, 0
    gathered = False
    while bits > 0:
        d = min(_DIGIT_BITS, bits)
        shift = bits - d
        hist = np.zeros(1 << _DIGIT_BITS, np.int64)
        for keys in slices:
            v = keys - lo
            rel = v - base
            play = (keys >= lo) & (v <= span) & (rel >= 0) & ((rel >> shift) < (1 << d))
            hist += np.bincount((rel[play] >> shift).astype(np.int64), minlength=1 << _DIGIT_BITS)
        cum = np.cumsum(hist)
        b = int(np.searchsorted(cum, rank - below))  # first bin whose prefix reaches the rank
        below += int(cum[b] - hist[b])
        base += b << shift
        ties = int(hist[b])
        bits, rounds = shift, rounds + 1
        if bits > 0 and not gathered and extra + below + hist[b] <= cap:
            # each block gathers its keys at or below the bin
            end = base + (1 << bits)
            slices = [keys[(keys < lo) | ((keys - lo <= span) & (keys - lo < end))]
                      for keys in slices]
            assert sum(map(len, slices)) == extra + below + hist[b]
            gathered = True
    return lo + base, extra + below, ties, gathered, rounds


def _knn_compact(keys, slices, t, n_below, need, lst):
    """compact: per block, each warp's quarter of its slice counted, the
    counts of the slices and warps before as its prefix, then 32 columns a
    step placed by ballot rank (below t at the running count, the first
    ``need`` ties after the n_below entries below t)."""
    segs = []
    for j0, j1 in slices:
        n = j1 - j0
        q = -(-(-(-n // _WARPS)) // 32) * 32
        segs += [(j0 + min(wp * q, n), j0 + min(wp * q + q, n)) for wp in range(_WARPS)]
    counts = np.array([[int((keys[a:b] == t).sum()), int((keys[a:b] < t).sum())]
                       for a, b in segs])
    pre = np.cumsum(counts, axis=0) - counts
    for (a, b), (ties, pos_below) in zip(segs, pre):
        for j0 in range(a, b, 32):
            js = np.arange(j0, min(j0 + 32, b))
            kb, tie = keys[js] < t, keys[js] == t
            rank_b = pos_below + np.cumsum(kb) - kb  # ballot rank among the step's lanes
            rank_t = ties + np.cumsum(tie) - tie
            ent = (keys[js].astype(np.uint64) << np.uint64(32)) | js.astype(np.uint64)
            lst[rank_b[kb]] = ent[kb]
            take = tie & (rank_t < need)
            lst[n_below + rank_t[take]] = ent[take]
            ties += int(tie.sum())
            pos_below += int(kb.sum())


def _knn_sort(lst):
    """sort_list on a power-of-two list (>= 128 entries): the kernel's
    bitonic network with its lane layout, entry seg + lane * 4 + e in
    register e of lane `lane`. Strides of 4-64 pair lanes (shuffles),
    strides 2 and 1 registers; strides of 128 or more run on the flat list
    (shared memory, a block barrier each). Returns the sorted list and the
    count of shared-memory steps."""
    size_l = len(lst)
    idx = np.arange(size_l).reshape(-1, 32, _E)
    lanes = np.arange(32)[None, :, None]
    x = lst.reshape(-1, 32, _E).copy()

    def warp_stages(x, size, top):
        s = top
        while s >= _E:  # a shuffle with lane ^ (s / 4), the same register
            m = s // _E
            y = x[:, lanes[0, :, 0] ^ m, :]
            keep_min = ((lanes & m) == 0) == ((idx & size) == 0)
            x = np.where(keep_min, np.minimum(x, y), np.maximum(x, y))
            s //= 2
        for s in (2, 1):  # two of a lane's registers
            if s > top:
                continue
            for e in (0, 1, 2, 3):
                if e & s:
                    continue
                a, b = x[:, :, e].copy(), x[:, :, e | s].copy()
                swap = (a > b) == ((idx[:, :, e] & size) == 0)
                x[:, :, e], x[:, :, e | s] = np.where(swap, b, a), np.where(swap, a, b)
        return x

    for size in (2, 4, 8, 16, 32, 64, 128):
        x = warp_stages(x, size, size // 2)
    smem_steps = 0
    size = 2 * _SPAN
    while size <= size_l:
        flat = x.reshape(-1)
        i = np.arange(size_l // 2)
        s = size // 2
        while s >= _SPAN:
            a = 2 * i - (i & (s - 1))
            p, q = flat[a].copy(), flat[a + s].copy()
            swap = (p > q) == ((a & size) == 0)
            flat[a], flat[a + s] = np.where(swap, q, p), np.where(swap, p, q)
            smem_steps += 1
            s //= 2
        x = warp_stages(flat.reshape(-1, 32, _E), size, _SPAN // 2)
        size *= 2
    return x.reshape(-1), smem_steps


def _emulate_knn_select(d2, k, mode="shared", cluster=0):
    """(vals [N, k], pos [N, k], stats) as the kernel computes them: in its
    shared mode over a cluster of ``cluster`` blocks (0: the kernel's
    choice from W), or in its wide mode (one block, int32 indices). stats:
    histogram rounds per row, the sort's shared-memory steps, the rows that
    placed their gathered keys."""
    n, w = d2.shape
    keys_all = d2.view(np.int32).astype(np.int64)
    size_l = max(1 << (k - 1).bit_length(), _SPAN)
    wide = mode == "wide"
    c = 1 if wide else (cluster or _knn_cluster(w))
    slices = _knn_slices(w, c)
    cap = max(size_l, _WIDE_GATHER) if wide else 2 * size_l  # the gather buffer
    vals = np.empty((n, k), np.float32)
    pos = np.empty((n, k), np.int32)
    stats = {"rounds": np.zeros(n, int), "smem_steps": 0, "placed": 0}
    rng = np.random.default_rng(n * w + k)
    for row in range(n):
        keys = keys_all[row]
        body = keys < _BIG_KEY
        n_body = int(body.sum())
        parts = [keys[a:b] for a, b in slices]
        if k <= n_body:
            lo = int(keys[body].min())
            t, below, ties, gathered, stats["rounds"][row] = _cluster_select(
                parts, lo, int(keys[body].max()) - lo, k, cap)
        else:
            t, below, ties, gathered, stats["rounds"][row] = _cluster_select(
                parts, _BIG_KEY, _INT_MAX - _BIG_KEY, k - n_body, cap, extra=n_body)
        assert 1 <= k - below and below == int((keys < t).sum())
        lst = np.full(size_l, _PAD, np.uint64)
        if gathered and below + ties <= size_l:
            # place_gathered: every key <= t, in whatever order the remote
            # atomics give; the sort takes the lowest columns of the ties
            assert ties == int((keys == t).sum())
            js = np.flatnonzero(keys <= t)
            js = js[rng.permutation(js.size)]
            lst[:js.size] = (keys[js].astype(np.uint64) << np.uint64(32)) | js.astype(np.uint64)
            stats["placed"] += 1
        else:
            _knn_compact(keys, slices, t, below, k - below, lst)
            assert (lst[:k] != _PAD).all() and (lst[k:] == _PAD).all()
        lst, stats["smem_steps"] = _knn_sort(lst)
        assert (lst[1:] >= lst[:-1]).all()
        vals[row] = (lst[:k] >> np.uint64(32)).astype(np.uint32).view(np.float32)
        pos[row] = (lst[:k] & np.uint64(0xFFFFFFFF)).astype(np.int32)
    return vals, pos, stats


def _past_body_inputs(seed=5, n=40, w=300):
    """Rows whose k reaches past the body: 60% of the columns at finfo.max,
    a few at inf, quantized distances that tie."""
    rng = np.random.default_rng(seed)
    d2 = (rng.integers(0, 50, (n, w)) * 0.5).astype(np.float32)
    d2[rng.random((n, w)) < 0.6] = np.finfo(np.float32).max
    d2[:, 5] = np.inf
    return d2


def _wide_row_inputs(seed=6, n=3, w=70_000):
    """Rows past column 65,535: quantized distances whose nearest columns
    and a tie group lie past it."""
    rng = np.random.default_rng(seed)
    d2 = (rng.integers(4, 400, (n, w)) * 0.25).astype(np.float32)
    d2[:, rng.random(w) < 0.05] = np.finfo(np.float32).max
    d2[:, 65_540:65_560] = 0.0
    d2[:, 65_536:65_540] = 0.25
    d2[0, 10:20] = 0.25
    return d2


def _ring_merge_inputs(seed=8, b=50, k=40, block=120):
    """The ring merge's [best | d2] rows: the k best so far (ascending,
    finfo.max where the row has met fewer), then a visiting block's
    distances, with values equal to the best's."""
    rng = np.random.default_rng(seed)
    best = np.sort((rng.integers(0, 60, (b, k)) * 0.5).astype(np.float32), axis=1)
    best[: b // 3, k // 2:] = np.finfo(np.float32).max
    d2 = (rng.integers(0, 60, (b, block)) * 0.5).astype(np.float32)
    d2[:, ::7] = np.finfo(np.float32).max
    return np.ascontiguousarray(np.concatenate([best, d2], axis=1))


_SELECT_INPUTS = {
    **{case: (lambda make=make: make()[0]) for case, make in _KERNEL_INPUTS.items()},
    "past-body": _past_body_inputs,
    "ring-merge": _ring_merge_inputs,
}


def _want_sorted_smallest(d2, k):
    """grid_tpu's exact sorted_smallest_k and lax.top_k of -d2 (ties to the
    lower index), which must agree."""
    import jax

    from grid_tpu.ops.select import sorted_smallest_k as j_sorted_smallest_k

    want_v, want_i = (np.asarray(a) for a in j_sorted_smallest_k(jnp.asarray(d2), k))
    top_v, top_i = (np.asarray(a) for a in jax.lax.top_k(-jnp.asarray(d2), k))
    np.testing.assert_array_equal(top_i, want_i)
    np.testing.assert_array_equal(-top_v, want_v)
    return want_v, want_i


_SELECT_MODES = {"resident": ("shared", 1), "cluster2": ("shared", 2), "cluster8": ("shared", 8),
                 "wide": ("wide", 0)}


@pytest.mark.parametrize("mode", list(_SELECT_MODES))
@pytest.mark.parametrize("case", sorted(_SELECT_INPUTS))
@pytest.mark.parametrize("k", [1, 20, 60, 96, "w"])
def test_knn_select_kernel_arithmetic(case, k, mode):
    """knn_select's radix select over the summed histograms of a cluster's
    slices, its compaction behind the slices before and its bitonic sort
    in registers, shuffles and shared memory give exactly grid_tpu's
    sorted_smallest_k (and lax.top_k) on ties, all-equal rows and keys past
    the body, k = 1, k = W and k not a power of two: in one block, split
    over 2 and 8 blocks (trailing blocks of 8 may hold no column), and in
    the wide mode; the port's plain version too."""
    d2 = _SELECT_INPUTS[case]()
    k = d2.shape[1] if k == "w" else k
    want_v, want_i = _want_sorted_smallest(d2, k)
    got_v, got_i, stats = _emulate_knn_select(d2, k, *_SELECT_MODES[mode])
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(got_v, want_v)
    assert stats["rounds"].max() <= 4  # at most 4 digits over a full 32-bit span
    plain_v, plain_i = sorted_smallest_k(torch.from_numpy(d2), k)
    np.testing.assert_array_equal(plain_i.numpy(), want_i)
    np.testing.assert_array_equal(plain_v.numpy(), want_v)


@pytest.mark.parametrize("k", [1, 500, 777])
def test_knn_select_kernel_arithmetic_past_column_65535(k):
    """The int32 columns past 65,535 on 70,000-column rows, exactly
    grid_tpu's lists: in the cluster mode the kernel picks there (8 blocks
    of 8,752 columns, the last of 8,736) and in the wide mode (its larger
    gather buffer). A list of 512 entries (k=500) takes 3 shared-memory
    steps of its 45."""
    d2 = _wide_row_inputs()
    want_v, want_i = _want_sorted_smallest(d2, k)
    assert _knn_cluster(d2.shape[1]) == 8
    for mode in ("shared", "wide"):
        got_v, got_i, stats = _emulate_knn_select(d2, k, mode)
        np.testing.assert_array_equal(got_i, want_i)
        np.testing.assert_array_equal(got_v, want_v)
        assert (got_i >= 65_536).any()
        assert stats["smem_steps"] == {1: 0, 500: 3, 777: 6}[k]


@pytest.mark.parametrize("k", [9000, 16384])
def test_knn_select_kernel_arithmetic_at_large_k(k):
    """Lists of 16,384 entries on 70,000-column rows, exactly grid_tpu's
    lists: in the wide mode, whose gather buffer holds only L indices so
    that the list and the buffer fit a block at k = 16,384 (the rows at
    k=9000 still place their gathered keys; at k = L the ties at t leave no
    room beside the list and the tie cut runs), and over 8 blocks."""
    d2 = _wide_row_inputs(n=2)
    want_v, want_i = _want_sorted_smallest(d2, k)
    for mode in ("shared", "wide"):
        got_v, got_i, stats = _emulate_knn_select(d2, k, mode)
        np.testing.assert_array_equal(got_i, want_i)
        np.testing.assert_array_equal(got_v, want_v)
        assert stats["smem_steps"] == 28  # the shared-memory steps of a list of 2^14
        if mode == "wide":
            assert stats["placed"] == {9000: 2, 16384: 0}[k]


def test_knn_select_placement_paths():
    """Rows whose ties at t fit the list beside the entries below t place
    their gathered keys with no tie cut (the narrow band); rows with no
    histogram round (all distances equal) or more ties than the list holds
    (two values a row) take the two walks and the tie cut. Both give
    grid_tpu's lists, in one block and over 8."""
    rng = np.random.default_rng(11)
    two_values = (rng.integers(0, 2, (30, 300)) * 1.0).astype(np.float32)
    for d2, k, fast_rows in ((_SELECT_INPUTS["narrow-band"](), 20, 97),
                             (_SELECT_INPUTS["all-equal"](), 20, 0),
                             (two_values, 20, 0)):
        want_v, want_i = _want_sorted_smallest(d2, k)
        for cluster in (1, 8):
            got_v, got_i, stats = _emulate_knn_select(d2, k, cluster=cluster)
            np.testing.assert_array_equal(got_i, want_i)
            np.testing.assert_array_equal(got_v, want_v)
            assert stats["placed"] == fast_rows


def test_knn_select_ring_merge_positions_keep_top_k_ties():
    """On the ring merge's [best | d2] rows the kernel's positions are
    lax.top_k's: an equal distance keeps the lower position, i.e. the best
    so far before the visiting block."""
    d2 = _ring_merge_inputs()
    k = 40
    _, pos, _ = _emulate_knn_select(d2, k)
    vals = np.take_along_axis(d2, pos.astype(np.int64), axis=1)
    for row in range(d2.shape[0]):
        for v in np.unique(vals[row]):
            at = pos[row][vals[row] == v]
            assert (np.diff(at) > 0).all()  # ties in position order
            # a tie past the best part is taken only once every equal best entry is
            if (at >= k).any():
                assert set(np.flatnonzero(d2[row, :k] == v)) <= set(at)


def test_knn_select_wrapper_takes_the_plain_route_on_cpu():
    from grid_tpu_torch.ops.gpu_select import sorted_smallest_k_gpu

    d2 = torch.from_numpy(_ring_merge_inputs())
    before = sorted_smallest_k_gpu.launches
    got = sorted_smallest_k_gpu(d2, 40)
    assert sorted_smallest_k_gpu.launches == before
    want = sorted_smallest_k(d2, 40)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert got[1].dtype == torch.int32
