"""The port's Smith-Waterman op (``grid_tpu_torch/ops/align.py``) against
grid_tpu's on the CPU, and a numpy model of the hand kernel's arithmetic.

Exact everywhere: the scores are int32 and both packages compute the same
integers. The plain version equals grid_tpu's ``sw_scores`` (its XLA scan),
and on reads made of ACGT also the host oracle ``sw_score_host`` (which
scores a mismatch at a read's N, where the scan carries the row). The
kernel's card tests are in ``tests/test_torch_gpu.py``.
"""

import threading

import numpy as np
import pytest
import torch

from grid_tpu.ops import align as jax_align
from grid_tpu_torch.ops import align
from grid_tpu_torch.ops.gpu_align import (
    GROUP_LANES, MAX_STRIP, REGISTER_MAX_LR, STRIP_STEP, overflow_free, packed_fits, strip,
    sw_scores_gpu, sw_shape,
    units)

SCORES = [(2, -1, -2), (3, -2, -3), (2, -1, 0)]


def _random_seqs(rng, n, lo, hi, alphabet="ACGT"):
    return ["".join(rng.choice(list(alphabet), size=int(rng.integers(lo, hi + 1))))
            for _ in range(n)]


def _jax_scores(queries, refs, match, mismatch, gap):
    return np.asarray(jax_align.sw_scores(queries, refs, match=match, mismatch=mismatch, gap=gap))


def _plain(queries, refs, match, mismatch, gap):
    return align.sw_scores(torch.as_tensor(queries), torch.as_tensor(refs), match=match,
                           mismatch=mismatch, gap=gap).numpy()


# ---- encode_seqs -------------------------------------------------------------

ENCODE_CASES = {
    "acgt": (["ACGT", "TTGCA", "G"], None),
    "lowercase": (["acgtACGT", "gattaca"], None),
    "n-and-iupac": (["ACNNGT", "RYKMSWBDHVN", "A-C.G*T"], None),
    "empty-reads": (["", "ACG", ""], None),
    "longer-than-length": (["ACGTACGTAC", "acg", "TTTTTTTT"], 6),
    "longer-all-cut": (["ACGTACGTAC", "GGGGGGGG"], 4),
    "pad-to-length": (["AC", "G"], 9),
    "zero-length": (["ACGT", ""], 0),
    "no-reads": ([], None),
    "non-ascii": (["ACGT", "aÇgt", "ÅCG"], None),
    "non-ascii-cut": (["ACGT", "éACGT"], 3),
    "equal-lengths": (["ACGTN", "acgtn", "RRRRR"], 5),
}


@pytest.mark.parametrize("case", sorted(ENCODE_CASES))
def test_encode_seqs_matches_grid_tpu(case):
    seqs, length = ENCODE_CASES[case]
    got, want = align.encode_seqs(seqs, length), jax_align.encode_seqs(seqs, length)
    assert got.dtype == want.dtype == np.int8
    np.testing.assert_array_equal(got, want)


def test_encode_seqs_non_ascii_that_grows_raises_as_grid_tpu():
    """``"ß".upper()`` is "SS": both packages write past the row and raise."""
    seqs = ["ACGT", "ßAC"]
    with pytest.raises(IndexError):
        jax_align.encode_seqs(seqs, 3)
    with pytest.raises(IndexError):
        align.encode_seqs(seqs, 3)


def test_encode_seqs_random_reads():
    rng = np.random.default_rng(5)
    seqs = _random_seqs(rng, 300, 0, 160, alphabet="ACGTacgtNRY")
    for length in (None, 150, 40):
        np.testing.assert_array_equal(align.encode_seqs(seqs, length),
                                      jax_align.encode_seqs(seqs, length))


# ---- the plain sw_scores against grid_tpu's scan -----------------------------

def _reads_and_refs(rng, n_reads, read_len, ref_lens, n_frac=0.0):
    refs = [str(s) for s in (_random_seqs(rng, 1, n, n)[0] for n in ref_lens)]
    reads = []
    for i in range(n_reads):
        ref = refs[i % len(refs)]
        if i % 3 == 0 or len(ref) < read_len:  # unrelated read
            read = _random_seqs(rng, 1, read_len, read_len)[0]
        else:
            start = int(rng.integers(0, len(ref) - read_len + 1))
            read = list(ref[start:start + read_len])
            for _ in range(int(rng.integers(0, 4))):
                read[int(rng.integers(read_len))] = str(rng.choice(list("ACGT")))
            read = "".join(read)
        if n_frac:
            read = "".join("N" if rng.random() < n_frac else b for b in read)
        reads.append(read)
    return reads, refs


@pytest.mark.parametrize("scores", SCORES, ids=["2,-1,-2", "3,-2,-3", "gap0"])
@pytest.mark.parametrize("shape", ["lq<lr", "lq>lr", "ragged-n-lower"])
def test_sw_scores_plain_equals_grid_tpu(scores, shape):
    rng = np.random.default_rng({"lq<lr": 1, "lq>lr": 2, "ragged-n-lower": 3}[shape])
    if shape == "lq<lr":
        reads, refs = _reads_and_refs(rng, 40, 30, (61, 45, 70))
    elif shape == "lq>lr":
        reads, refs = _reads_and_refs(rng, 40, 50, (33, 20, 41))
    else:
        reads, refs = _reads_and_refs(rng, 45, 36, (40, 55, 37), n_frac=0.05)
        reads = [r.lower() if i % 4 == 1 else r for i, r in enumerate(reads)]
        reads += ["", "N" * 20, _random_seqs(rng, 1, 9, 9)[0]]
    queries, ref_codes = align.encode_seqs(reads), align.encode_seqs(refs)
    got = _plain(queries, ref_codes, *scores)
    assert got.dtype == np.int32 and got.shape == (len(reads), len(refs))
    np.testing.assert_array_equal(got, _jax_scores(queries, ref_codes, *scores))


@pytest.mark.parametrize("scores", SCORES, ids=["2,-1,-2", "3,-2,-3", "gap0"])
def test_sw_scores_plain_equals_host_oracle_on_acgt(scores):
    rng = np.random.default_rng(8)
    reads, refs = _reads_and_refs(rng, 12, 25, (31, 22, 40))
    reads[3] = reads[3][:17]  # a shorter read (pad at its end)
    got = _plain(align.encode_seqs(reads), align.encode_seqs(refs), *scores)
    # refs of different lengths are padded with code 4 inside the [T, Lr]
    # array: the oracle sees each reference at that padded length
    lr = max(map(len, refs))
    for i, read in enumerate(reads):
        for t, ref in enumerate(refs):
            want = align.sw_score_host(read, ref.ljust(lr, "N"), *scores)
            assert got[i, t] == want == jax_align.sw_score_host(read, ref.ljust(lr, "N"), *scores)


def test_sw_scores_uint8_and_int8_agree():
    rng = np.random.default_rng(3)
    reads, refs = _reads_and_refs(rng, 20, 30, (35, 28), n_frac=0.05)
    q, r = align.encode_seqs(reads), align.encode_seqs(refs)
    np.testing.assert_array_equal(_plain(q.view(np.uint8), r.view(np.uint8), 2, -1, -2),
                                  _plain(q, r, 2, -1, -2))


@pytest.mark.parametrize("q,t,lq,lr", [(0, 3, 10, 10), (4, 0, 10, 10), (4, 3, 0, 10),
                                       (4, 3, 10, 0), (0, 0, 0, 0)])
def test_sw_scores_empty_shapes_give_zeros(q, t, lq, lr):
    queries = torch.full((q, lq), 1, dtype=torch.int8)
    refs = torch.full((t, lr), 1, dtype=torch.int8)
    before = sw_scores_gpu.launches
    got = align.sw_scores(queries, refs)
    assert got.dtype == torch.int32 and tuple(got.shape) == (q, t) and not got.any()
    assert sw_scores_gpu.launches == before


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    rng = np.random.default_rng(4)
    reads, refs = _reads_and_refs(rng, 10, 20, (24, 30))
    q, r = torch.as_tensor(align.encode_seqs(reads)), torch.as_tensor(align.encode_seqs(refs))
    before = sw_scores_gpu.launches
    want = align.sw_scores_plain(q, r)
    assert torch.equal(align.sw_scores(q, r), want)
    assert torch.equal(sw_scores_gpu(q, r), want)
    assert sw_scores_gpu.launches == before


def test_overflow_guard():
    assert overflow_free(150, 182, 2, -1, -2)
    assert not overflow_free(2**29, 182, 4, -1, -2)
    assert not overflow_free(150, 2**30, 2, -1, -2)


# ---- classify_reads ----------------------------------------------------------

@pytest.mark.parametrize("min_score,margin", [(20, 0), (20, 3), (60, 0)])
def test_classify_reads_equals_grid_tpu_with_ties(min_score, margin):
    """Two identical references and a third sharing their prefix: many
    reads tie between references, and the labels follow grid_tpu's argsort
    read for read."""
    rng = np.random.default_rng(11)
    shared = _random_seqs(rng, 1, 60, 60)[0]
    refs = [shared, shared, shared[:40] + _random_seqs(rng, 1, 20, 20)[0],
            _random_seqs(rng, 1, 60, 60)[0]]
    labels = ["B1", "B2", "B3", "A"]
    reads, _ = _reads_and_refs(rng, 60, 30, (60,))
    reads = [shared[i % 30:i % 30 + 30] if i % 2 else r for i, r in enumerate(reads)]
    q, r = align.encode_seqs(reads), align.encode_seqs(refs)
    got, got_scores = align.classify_reads(q, r, labels, min_score, margin, device="cpu")
    want, want_scores = jax_align.classify_reads(q, r, labels, min_score, margin)
    np.testing.assert_array_equal(got_scores, np.asarray(want_scores))
    assert got == want
    assert any(lab in ("B1", "B2") for lab in got) or margin > 0


# ---- a numpy model of the kernel's arithmetic --------------------------------

_NEVER = 1 << 20  # the kernel's code for a reference's 4


def _addmax(a, b, c):
    """__viaddmax_s32: max(a + b, c)."""
    return np.maximum(a + b, c)


def _addmax_relu(a, b, c):
    """__viaddmax_s32_relu: max(a + b, c, 0)."""
    return np.maximum(np.maximum(a + b, c), 0)


def _shfl_up(x, d):
    """__shfl_up_sync over the lane axis (last): lanes below d keep theirs."""
    out = x.copy()
    out[..., d:] = x[..., :-d]
    return out


def _scan_max(u, lane):
    for d in (1, 2, 4, 8, 16):
        u = np.where(lane >= d, np.maximum(u, _shfl_up(u, d)), u)
    return u


def _ref_codes(refs_p, j, lr, mixed=False):
    """Each unit's raw reference codes at the lanes' columns ``j`` [1,
    lanes]: the byte, or _NEVER past Lr, for a 4, and (int8 against uint8)
    for a byte of 128 or more."""
    j = j[0]
    c = np.where(j < lr, refs_p[:, np.minimum(j, lr - 1)], _NEVER)
    return np.where((c == 4) | (mixed & (c >= 128) & (c != _NEVER)), _NEVER, c)


def _emulate_groups(q, r, match, mismatch, gap, g_lanes, mixed=False):
    """The register mode's int32 form: G lanes a pair (axis 0 pairs, axis
    1 lanes), lane g holding the strip of S = strip(Lr, G) columns from g*S;
    at step t lane g computes row t - g, its left edge the one shuffle from
    lane g-1 and its diagonal edge that value held a step; code-4 rows and
    steps outside the read skip the cells; the bases right to left in
    place, then the left chain, in the DPX forms; columns past Lr kept out
    of the best only where the scores let them exceed it. ``q`` and ``r``
    hold raw bytes."""
    n_p, lq = q.shape
    lr = r.shape[1]
    s_cols = strip(lr, g_lanes)
    assert s_cols <= MAX_STRIP[g_lanes]
    lane = np.arange(g_lanes)[None, :]
    j0 = lane * s_cols
    rc = [_ref_codes(r, j0 + s, lr, mixed) for s in range(s_cols)]
    valid = np.clip(lr - j0, 0, s_cols) if gap > 0 or mismatch > 0 else s_cols
    h = [np.zeros((n_p, g_lanes), np.int64) for _ in range(s_cols)]
    best = np.zeros((n_p, g_lanes), np.int64)
    last = np.zeros((n_p, g_lanes), np.int64)
    held = np.zeros((n_p, g_lanes), np.int64)
    for t in range(lq + g_lanes - 1):
        i = t - lane
        qc = np.where((i >= 0) & (i < lq), q[:, np.clip(i, 0, lq - 1)[0]], 4)
        left = _shfl_up(last, 1)
        left[:, 0] = 0
        diag, held = held, left
        new = list(h)
        for s in range(s_cols - 1, -1, -1):
            edge = new[s - 1] if s else diag
            new[s] = _addmax_relu(new[s], gap, edge + np.where(rc[s] == qc, match, mismatch))
        for s in range(s_cols):
            left = _addmax(left, gap, new[s])
            new[s] = left
        live = qc != 4
        h = [np.where(live, nh, old) for old, nh in zip(h, new)]
        for s in range(s_cols):
            best = np.where(live & (s < valid), np.maximum(best, h[s]), best)
        last = h[-1]
    return best.max(axis=1)


_INT16 = 2**15


def _in_int16(*xs):
    for x in xs:
        assert -_INT16 <= x.min() and x.max() < _INT16, "a packed value left int16"
    return xs[0] if len(xs) == 1 else xs


def _half_sub(profile, qc):
    """One half of the prmt: byte qc (0-3) of the profile, sign-extended,
    or -32768 (bytes 0x00 and 0x80 of 0x8000) where the read has a 4."""
    byte = (profile >> (8 * np.clip(qc, 0, 3))) & 0xFF
    return np.where(qc == 4, -_INT16, np.where(byte >= 128, byte - 256, byte))


def _emulate_packed(q, r, match, mismatch, gap, g_lanes, mixed=False):
    """The packed form: a unit is reads 2k and 2k+1 (an odd Q's last read
    twice) against one reference, one in each 16-bit half; each column's
    profile holds its substitution for read codes 0-3 a byte each; a half
    whose read has a 4 takes -32768 as its substitution and 0 as its up
    gap, and must come out unchanged (its left chain keeps the usual gap:
    every row has H[j] >= H[j-1] + gap); every value
    stays inside int16 (asserted); the best counts the padded columns. A
    warp (32/G units) with a read code past 4 scores its reads in the int32
    form. ``q`` [Q, Lq] and ``r`` [T, Lr] hold raw bytes; returns [Q, T]."""
    n_q, lq = q.shape
    n_t, lr = r.shape
    duo = np.arange(units(n_q, n_t, True))
    qa, qb, ti = 2 * (duo // n_t), np.minimum(2 * (duo // n_t) + 1, n_q - 1), duo % n_t
    warp = duo // (32 // g_lanes)
    past4 = (q[qa] > 4).any(axis=1) | (q[qb] > 4).any(axis=1)
    generic = np.isin(warp, warp[past4])
    s_cols = strip(lr, g_lanes)
    lane = np.arange(g_lanes)[None, :]
    j0 = lane * s_cols
    profile = []
    for s in range(s_cols):
        rc = _ref_codes(r[ti], j0 + s, lr, mixed)
        profile.append(sum((np.where(rc == c, match, mismatch) & 0xFF) << (8 * c)
                           for c in range(4)))
    halves = {"a": qa, "b": qb}
    h = {x: [np.zeros((len(duo), g_lanes), np.int64) for _ in range(s_cols)] for x in halves}
    best = {x: np.zeros((len(duo), g_lanes), np.int64) for x in halves}
    last = {x: np.zeros((len(duo), g_lanes), np.int64) for x in halves}
    held = {x: np.zeros((len(duo), g_lanes), np.int64) for x in halves}
    for t in range(lq + g_lanes - 1):
        i = t - lane
        inside = (i >= 0) & (i < lq)
        code = {x: np.where(inside, q[rows][:, np.clip(i, 0, lq - 1)[0]], 4)
                for x, rows in halves.items()}
        moves = (code["a"] != 4) | (code["b"] != 4)
        for x in halves:
            qc = code[x]
            left = _shfl_up(last[x], 1)
            left[:, 0] = 0
            diag, held[x] = held[x], left
            gap_up = np.where(qc == 4, 0, gap)
            new = list(h[x])
            for s in range(s_cols - 1, -1, -1):
                edge = new[s - 1] if s else diag
                up = _in_int16(np.maximum(new[s] + gap_up, 0))
                new[s] = np.maximum(_in_int16(edge + _half_sub(profile[s], qc)), up)
            for s in range(s_cols):
                left = np.maximum(_in_int16(left + gap), new[s])
                new[s] = left
            h[x] = [np.where(moves, nh, old) for old, nh in zip(h[x], new)]
            for s in range(s_cols):
                best[x] = np.maximum(best[x], h[x][s])
            last[x] = h[x][-1]
    out = np.zeros((n_q, n_t), np.int64)
    out[qa, ti] = best["a"].max(axis=1)
    out[qb, ti] = np.where(qb != qa, best["b"].max(axis=1), out[qb, ti])
    if generic.any():  # those warps' units in the int32 form, read by read
        for rows in (qa, qb):
            out[rows[generic], ti[generic]] = _emulate_groups(
                q[rows[generic]], r[ti[generic]], match, mismatch, gap, g_lanes, mixed)
    return out


def _group_choices(lr):
    """Every G the chooser returns for references of ``lr`` codes, over
    unit counts from 1 to 2^24."""
    return sorted({sw_shape(lr, 2**e)[0] for e in range(25)})


def _emulate_shared(q, r, match, mismatch, gap, mixed=False):
    """The shared-memory mode: the row in memory, walked in chunks of 32
    columns, one a lane, with a carry between chunks; read bytes compared
    raw with :func:`_ref_codes`, as in the register mode."""
    n_p, lq = q.shape
    lr = r.shape[1]
    lane = np.arange(32)[None, :]
    chunks = -(-lr // 32)
    row = np.zeros((n_p, chunks * 32), np.int64)
    best = np.zeros((n_p, 32), np.int64)
    for i in range(lq):
        qc = q[:, i:i + 1]
        live = (qc != 4)[:, 0]
        edge = np.zeros((n_p, 1), np.int64)
        carry = np.zeros((n_p, 1), np.int64)
        for c in range(chunks):
            j = c * 32 + lane
            valid = j < lr
            up = np.where(valid, row[:, c * 32:(c + 1) * 32], 0)
            diag = _shfl_up(up, 1)
            diag[:, :1] = edge
            edge = up[:, 31:32]
            sub = np.where(_ref_codes(r, j, lr, mixed) == qc, match, mismatch)
            u = _scan_max(_addmax_relu(up, gap, diag + sub) - j * gap, lane)
            if c > 0:
                u = np.maximum(u, carry)
            hj = u + j * gap
            upd = live[:, None] & valid
            row[:, c * 32:(c + 1) * 32] = np.where(upd, hj, row[:, c * 32:(c + 1) * 32])
            best = np.where(upd, np.maximum(best, hj), best)
            carry = u[:, 31:32]
    return best.max(axis=1)


KERNEL_CASES = {
    # (reads, read length, reference lengths, N fraction)
    "lr-1": (6, 5, (1,), 0.0),
    "lr-31-ragged": (10, 20, (31, 17), 0.1),
    "lr-32": (10, 40, (32,), 0.0),
    "lr-33": (10, 24, (33, 30), 0.05),
    "exons-160-182": (16, 150, (160, 182, 182), 0.01),
    "lr-512": (4, 60, (512,), 0.0),
    "lq-gt-lr": (8, 90, (40, 70), 0.05),
    "shared-513": (4, 50, (513,), 0.02),
    "shared-700": (4, 80, (700, 650), 0.02),
}


def _lanes_of(case):
    """The register mode's G choices for a case, or 0 for the shared mode."""
    lr = max(KERNEL_CASES[case][2])
    return _group_choices(lr) if lr <= REGISTER_MAX_LR else [0]


@pytest.mark.parametrize("scores", SCORES + [(2, -1, 1)],
                         ids=["2,-1,-2", "3,-2,-3", "gap0", "gap+1"])
@pytest.mark.parametrize("case,lanes", [(c, g) for c in sorted(KERNEL_CASES)
                                        for g in _lanes_of(c)],
                         ids=lambda v: f"g{v}" if isinstance(v, int) else v)
def test_sw_kernel_arithmetic(case, lanes, scores):
    """Lane groups on the row wavefront (each G the chooser returns at the
    case's Lr) in the int32 form and, where the scores fit it, the packed
    form, the shared-memory chunks and the DPX forms written out give the
    plain version's integers (and grid_tpu's on two score sets), also for a
    positive gap."""
    n_reads, read_len, ref_lens, n_frac = KERNEL_CASES[case]
    rng = np.random.default_rng(sum(ref_lens) + read_len)
    reads, refs = _reads_and_refs(rng, n_reads, read_len, ref_lens, n_frac=n_frac)
    q, r = align.encode_seqs(reads), align.encode_seqs(refs)
    q[0, :3] = 4  # a pad-led read
    want = _plain(q, r, *scores)
    n_q, n_t = want.shape
    qp = np.repeat(q.astype(np.int64), n_t, axis=0)
    rp = np.tile(r.astype(np.int64), (n_q, 1))
    if lanes:
        np.testing.assert_array_equal(_emulate_groups(qp, rp, *scores, lanes).reshape(n_q, n_t),
                                      want)
        if packed_fits(q.shape[1], *scores):
            raw = q.astype(np.int64) & 0xFF, r.astype(np.int64) & 0xFF
            np.testing.assert_array_equal(_emulate_packed(*raw, *scores, lanes), want)
    else:
        np.testing.assert_array_equal(_emulate_shared(qp, rp, *scores).reshape(n_q, n_t), want)
    if r.shape[1] <= 700 and scores[:2] == (2, -1) and scores[2] in (-2, 1):
        np.testing.assert_array_equal(want, _jax_scores(q, r, *scores))


def test_shared_mode_emulation_equals_register_mode():
    """Both modes compute the same row: at Lr=200 (a register-mode width)
    the shared mode's chunks give the lane groups' integers at each G the
    chooser returns there."""
    rng = np.random.default_rng(12)
    reads, refs = _reads_and_refs(rng, 6, 70, (200, 150), n_frac=0.05)
    q, r = align.encode_seqs(reads), align.encode_seqs(refs)
    qp = np.repeat(q.astype(np.int64), 2, axis=0)
    rp = np.tile(r.astype(np.int64), (6, 1))
    shared = _emulate_shared(qp, rp, 2, -1, -2)
    for lanes in _group_choices(200):
        np.testing.assert_array_equal(shared, _emulate_groups(qp, rp, 2, -1, -2, lanes))


def test_sw_shape_stays_in_the_template_table():
    """For every Lr of the register mode and unit counts from 1 to 2^24:
    G divides 32, S is ceil(Lr/G) rounded up to the table's step (G*S >=
    Lr, less than a step of columns a lane wasted) and the kernel's table
    holds (G, S); more units never ask for more lanes."""
    for lr in range(1, REGISTER_MAX_LR + 1):
        before = 32
        for n in [2**e for e in range(25)] + [3, 100, 24_576, 1_000_003]:
            g, s = sw_shape(lr, n)
            assert g in GROUP_LANES and 32 % g == 0
            assert g * s >= lr > g * (s - STRIP_STEP)
            assert s % STRIP_STEP == 0 and STRIP_STEP <= s <= MAX_STRIP[g]
            if n == 2**int(np.log2(n)) and n > 1:
                assert g <= before
                before = g
    assert max(g * s for g, s in MAX_STRIP.items()) == REGISTER_MAX_LR
    # the WES main path: 8,192 reads of 150 on three exons, packed
    assert packed_fits(150, 2, -1, -2) and units(8192, 3, True) == 12_288
    assert sw_shape(182, 12_288) == (8, 24)


@pytest.mark.parametrize("lq,scores,fits", [
    (150, (2, -1, -2), True), (150, (3, -2, -3), True), (150, (2, -1, 0), True),
    (150, (2, -1, 1), False),            # a positive gap: the padding must be masked
    (150, (2, 1, -2), False),            # a positive mismatch: likewise
    (150, (128, -1, -2), False),         # match past a byte
    (150, (2, -129, -2), False),         # mismatch past a byte
    (150, (2, -1, -16385), False),       # up + gap could leave int16
    (150, (2, -1, -16384), True),
    (16382, (2, -1, -2), True),          # (Lq + 1) * match = 32,766
    (16383, (2, -1, -2), False),         # 32,768
    (10**6, (0, -1, -2), True),          # no score above 0
])
def test_packed_fits(lq, scores, fits):
    assert packed_fits(lq, *scores) is fits


@pytest.mark.parametrize("lanes", GROUP_LANES)
@pytest.mark.parametrize("mixed", [False, True], ids=["same-type", "int8-uint8"])
def test_sw_kernel_arithmetic_raw_codes(lanes, mixed):
    """Codes past 4 (none from encode_seqs) match themselves: in the int32
    form, and in the packed form, whose warps holding such a read score in
    the int32 form while the others stay packed. With int8 reads against a
    uint8 reference, bytes of 128 or more equal no read code."""
    rng = np.random.default_rng(lanes)
    alphabet = np.array([0, 1, 2, 3, 4, 5, 6, -56, -6], np.int8)
    q = alphabet[rng.integers(0, 9, (41, 30))]
    q[:20] = np.where(q[:20] > 4, 2, q[:20])  # the first warps' reads of codes 0-4
    q[:20][q[:20] < 0] = 1
    r = alphabet[rng.integers(0, 9, (2, 4 * lanes - 3))]
    refs = torch.as_tensor(r.view(np.uint8) if mixed else r)
    want = align.sw_scores_plain(torch.as_tensor(q), refs).numpy()
    raw = q.astype(np.int64) & 0xFF, r.astype(np.int64) & 0xFF
    qp, rp = np.repeat(raw[0], 2, axis=0), np.tile(raw[1], (41, 1))
    np.testing.assert_array_equal(
        _emulate_groups(qp, rp, 2, -1, -2, lanes, mixed).reshape(41, 2), want)
    np.testing.assert_array_equal(_emulate_packed(*raw, 2, -1, -2, lanes, mixed), want)


@pytest.mark.parametrize("mixed", [False, True], ids=["same-type", "int8-uint8"])
def test_shared_mode_arithmetic_raw_codes(mixed):
    """The shared mode compares raw bytes by the register mode's rule:
    codes past 4 match themselves, and int8 reads against a uint8
    reference match no byte of 128 or more."""
    rng = np.random.default_rng(7)
    alphabet = np.array([0, 1, 2, 3, 4, 5, 6, -56, -6], np.int8)
    q, r = alphabet[rng.integers(0, 9, (9, 30))], alphabet[rng.integers(0, 9, (2, 70))]
    refs = torch.as_tensor(r.view(np.uint8) if mixed else r)
    want = align.sw_scores_plain(torch.as_tensor(q), refs).numpy()
    raw = q.astype(np.int64) & 0xFF, r.astype(np.int64) & 0xFF
    qp, rp = np.repeat(raw[0], 2, axis=0), np.tile(raw[1], (9, 1))
    np.testing.assert_array_equal(
        _emulate_shared(qp, rp, 2, -1, -2, mixed).reshape(9, 2), want)


@pytest.mark.parametrize("main_q", [2048, 8192])
def test_card_cases_reach_every_choice(main_q):
    """tests/torch_sw_cases.py's cases (the card's: tests/test_torch_gpu.py
    takes them with 2,048 main reads, chip_smoke.py phase 13 with 8,192)
    launch every G of the register mode in both forms, the int32 form with
    padding, masked (a positive gap) and not, the packed form with padding,
    a packed launch with a read code past 4, an odd read count in the
    packed form, and the shared mode."""
    from torch_sw_cases import sw_cases

    seen = set()
    for _, q, r, (match, mismatch, gap) in sw_cases(main_q=main_q):
        (n_q, lq), (n_t, lr) = q.shape, r.shape
        if lr > REGISTER_MAX_LR:
            seen.add("shared")
            continue
        packed = packed_fits(lq, match, mismatch, gap)
        g, s = sw_shape(lr, units(n_q, n_t, packed))
        seen.add((g, "packed" if packed else "int32"))
        if g * s > lr:
            seen.add("packed padding" if packed else
                     "masked padding" if gap > 0 or mismatch > 0 else "int32 padding")
        if packed and n_q % 2:
            seen.add("odd Q")
        if packed and (q.view(np.uint8) > 4).any():
            seen.add("past 4")
    assert seen == {*((g, f) for g in GROUP_LANES for f in ("int32", "packed")), "shared",
                    "packed padding", "masked padding", "int32 padding", "odd Q", "past 4"}


def test_classify_from_threads_counts_no_launch_on_cpu():
    """Workers score from several threads on the CPU: every result equals
    the one-thread result and nothing is counted as a launch."""
    rng = np.random.default_rng(6)
    reads, refs = _reads_and_refs(rng, 30, 25, (30, 35, 33))
    q, r = align.encode_seqs(reads), align.encode_seqs(refs)
    want = align.classify_reads(q, r, ["a", "b", "c"], 20, device="cpu")
    got, before = [None] * 6, sw_scores_gpu.launches

    def work(i):
        got[i] = align.classify_reads(q, r, ["a", "b", "c"], 20, device="cpu")

    threads = [threading.Thread(target=work, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for labels, scores in got:
        assert labels == want[0]
        np.testing.assert_array_equal(scores, want[1])
    assert sw_scores_gpu.launches == before
