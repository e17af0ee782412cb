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
from grid_tpu_torch.ops.gpu_align import overflow_free, sw_scores_gpu

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


def _ref_codes(refs_p, j, lr):
    """Each pair's reference codes at the lanes' columns ``j`` [1, 32]."""
    j = j[0]
    c = np.where(j < lr, refs_p[:, np.minimum(j, lr - 1)], _NEVER)
    return np.where(c == 4, _NEVER, c)


def _emulate_registers(q, r, match, mismatch, gap):
    """The register mode: one warp per pair (axis 0), lane strips of W
    columns, the DPX forms, the shuffle-scan carry, the best masked at the
    end."""
    n_p, lq = q.shape
    lr = r.shape[1]
    w = -(-lr // 32)
    lane = np.arange(32)[None, :]
    j0 = lane * w
    rc = [_ref_codes(r, j0 + s, lr) for s in range(w)]
    h = [np.zeros((n_p, 32), np.int64) for _ in range(w)]
    colbest = [np.zeros((n_p, 32), np.int64) for _ in range(w)]
    for i in range(lq):
        qc = q[:, i:i + 1]
        diag = _shfl_up(h[w - 1], 1)
        diag[:, 0] = 0
        base = [_addmax_relu(h[0], gap, diag + np.where(rc[0] == qc, match, mismatch))]
        for s in range(1, w):
            base.append(_addmax_relu(h[s], gap, h[s - 1] + np.where(rc[s] == qc, match,
                                                                     mismatch)))
        run = base[0]
        for s in range(1, w):
            run = _addmax(run, gap, base[s])
        u = _scan_max(run - (j0 + w - 1) * gap, lane)
        left = _shfl_up(u, 1) + (j0 - 1) * gap
        new = [np.where(lane > 0, _addmax(left, gap, base[0]), base[0])]
        for s in range(1, w):
            new.append(_addmax(new[-1], gap, base[s]))
        keep = qc == 4  # the warp skips the row
        h = [np.where(keep, old, nh) for old, nh in zip(h, new)]
        colbest = [np.maximum(cb, hs) for cb, hs in zip(colbest, h)]
    best = np.zeros((n_p, 32), np.int64)
    for s in range(w):
        best = np.maximum(best, np.where(j0 + s < lr, colbest[s], 0))
    return best.max(axis=1)


def _emulate_shared(q, r, match, mismatch, gap):
    """The shared-memory mode: the row in memory, walked in chunks of 32
    columns, one a lane, with a carry between chunks."""
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
            sub = np.where(_ref_codes(r, j, lr) == qc, match, mismatch)
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


@pytest.mark.parametrize("scores", SCORES + [(2, -1, 1)],
                         ids=["2,-1,-2", "3,-2,-3", "gap0", "gap+1"])
@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_sw_kernel_arithmetic(case, scores):
    """Lane strips, the shuffle-scan carry, the shared-memory chunks and the
    DPX forms written out give the plain version's integers (and grid_tpu's
    on two score sets), also for a positive gap."""
    n_reads, read_len, ref_lens, n_frac = KERNEL_CASES[case]
    rng = np.random.default_rng(sum(ref_lens) + read_len)
    reads, refs = _reads_and_refs(rng, n_reads, read_len, ref_lens, n_frac=n_frac)
    q, r = align.encode_seqs(reads), align.encode_seqs(refs)
    q[0, :3] = 4  # a pad-led read
    want = _plain(q, r, *scores)
    n_q, n_t = want.shape
    qp = np.repeat(q.astype(np.int64), n_t, axis=0)
    rp = np.tile(r.astype(np.int64), (n_q, 1))
    emulate = _emulate_registers if r.shape[1] <= 512 else _emulate_shared
    got = emulate(qp, rp, *scores).reshape(n_q, n_t)
    np.testing.assert_array_equal(got, want)
    if r.shape[1] <= 700 and scores[:2] == (2, -1) and scores[2] in (-2, 1):
        np.testing.assert_array_equal(want, _jax_scores(q, r, *scores))


def test_shared_mode_emulation_equals_register_mode():
    """Both modes compute the same row: at Lr=200 (a register-mode width)
    the shared mode's chunks give the register mode's integers."""
    rng = np.random.default_rng(12)
    reads, refs = _reads_and_refs(rng, 6, 70, (200, 150), n_frac=0.05)
    q, r = align.encode_seqs(reads), align.encode_seqs(refs)
    qp = np.repeat(q.astype(np.int64), 2, axis=0)
    rp = np.tile(r.astype(np.int64), (6, 1))
    np.testing.assert_array_equal(_emulate_shared(qp, rp, 2, -1, -2),
                                  _emulate_registers(qp, rp, 2, -1, -2))


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
