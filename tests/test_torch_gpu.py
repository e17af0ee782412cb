"""The port's hand kernels against their plain versions on a CUDA card.

Every test here needs the card: it carries the ``cuda`` marker and skips
without one. This file imports no JAX, so on a machine without JAX run it
without the suite's conftest (which sets JAX up):

    python -m pytest tests/test_torch_gpu.py -m cuda --noconftest -q

Bounds as in chip_smoke.py: counts and ``ok`` exact; column sums at rtol
1e-5, and two calls bitwise equal; the Gram matrix within 1e-5 of its
largest entry (another summation
order over R), exactly symmetric, and at most twice the plain version's
error against a float64 Gram; dipCN at rtol 1e-6 (the same take-set
summed in another order). The Gram row panels and their norms are held to
the same bounds; the norms must equal the diagonal of the kernel's own G
bitwise. The ring's cross mode must give bitwise the panel mode's entries
for the same two rows. The wide dipCN mode is held to the plain version as the resident
mode is, past column 65,535 too. The multi-weight dipCN form is held to its
plain version at rtol 1e-5 (the plain form's [N, W] @ [W, L] product sums
in another order), to the binary kernel per locus at rtol 1e-6 (it sums in
float64, the binary kernel in float32), and its wide mode to its resident
mode bitwise. The Smith-Waterman kernel equals its plain scan exactly
(int32) in both its modes, and the WES pipeline on the card writes the CPU
run's files byte for byte. The gather form of the sharded step on one rank
launches what its panels need and equals the flat panel loop on its own z
bitwise; a named build cache receives the nvcc libraries. The selection
kernel (``knn_select``) equals the stable sort exactly, values and
positions, in the mode it picks (over 1, 2, 4 and 8 blocks a row, and
past the widest row 8 blocks hold) and in its wide mode, up to k = 16,384
at any width, and the ring merge on it the sort merge; ``dipcn_lists``' list route on the card keeps the
CPU route's and ``dipcn_select``'s validity exactly and their dipCN at rtol
1e-6; the phasing kernel (``phase_sweeps``) is held to the plain sweeps at rtol 1e-5
with the same NaNs (each neighbor list summed in slot order there, in
torch's reduction order in the plain version), its two modes to each
other bitwise. In float64 every kernel is held to its float64 plain
version at 1e-12 of the value (the multi-weight dipCN form too, and the
FP64 Gram's cross mode bitwise to its panel mode, whose products are
symmetric bit for bit), and the ring step at W=2 to the flat step. The
bf16 Gram's panels equal its triangle's rows bitwise (one sum order in
every mode), its launch the plan of ``tests/torch_plans.py``; dipCN's two
modes agree bitwise at the mode table's widths in every dtype, and the
resident mode runs where at least 4 of its blocks fit an SM.
"""

import functools

import numpy as np
import pytest
import torch

from grid_tpu_torch.convert import inputs_to_torch, outputs_to_numpy
from grid_tpu_torch.io.hap_neighbors import pad_hap_neighbors
from grid_tpu_torch.models.cohort import CohortParams, cohort_step
from grid_tpu_torch.ops.gpu_kernels import (
    masked_column_stats,
    masked_column_stats_plain,
    zprep_gram,
    zprep_gram_cross,
    zprep_gram_cross_plain,
    zprep_gram_info,
    zprep_gram_panel,
    zprep_gram_panel_plain,
    zprep_gram_plain,
    zprep_split,
    zprep_split_plain,
)
from grid_tpu_torch.ops.gpu_select import (
    _launch,
    _launch_multi,
    dipcn_from_distances_gpu,
    dipcn_from_distances_multi_gpu,
    dipcn_multi_panels_gpu,
    dipcn_select_info,
    dipcn_select_mode,
)
from grid_tpu_torch.ops.knn import d2_matrix
from grid_tpu_torch.ops.select import (
    dipcn_from_distances,
    dipcn_from_distances_multi,
    dipcn_from_distances_panels,
)
from torch_parity import assert_close_to_max, dipcn_sets_differ, neighbor_rows_differing

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full float32
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("n,r", [(1, 1), (97, 70), (300, 257), (2504, 2048), (1000, 130)])
def test_masked_column_stats_kernel(cuda, n, r):
    rng = np.random.default_rng(n)
    values = torch.tensor(rng.uniform(10, 60, (n, r)), dtype=torch.float32, device=cuda)
    mask = torch.tensor(rng.random((n, r)) > 0.15, device=cuda)
    inv = torch.tensor(rng.uniform(0.01, 0.1, n), dtype=torch.float32, device=cuda)
    mu = torch.tensor(rng.uniform(0.5, 2.0, r), dtype=torch.float32, device=cuda)
    for col_means in (None, mu):
        before = masked_column_stats.launches
        got = masked_column_stats(values, mask, inv, col_means)
        assert masked_column_stats.launches == before + 1
        want = masked_column_stats_plain(values, mask, inv, col_means)
        assert torch.equal(got[0], want[0])
        torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=0)
        torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=0)
        again = masked_column_stats(values, mask, inv, col_means)
        assert all(torch.equal(a, b) for a, b in zip(got, again))  # no atomics: bitwise equal


@pytest.mark.parametrize("n,r", [(1, 3), (97, 70), (300, 257), (515, 130)])
def test_zprep_gram_kernel(cuda, n, r):
    rng = np.random.default_rng(n)
    z = torch.tensor(rng.normal(size=(n, r)) * 3, dtype=torch.float32, device=cuda)
    mask = torch.tensor(rng.random((n, r)) > 0.1, device=cuda)
    region = torch.tensor(rng.random(r) > 0.2, device=cuda)
    before = zprep_gram.launches
    got = zprep_gram(z, mask, region, 2.0)
    assert zprep_gram.launches == before + 1
    want = zprep_gram_plain(z, mask, region, 2.0)
    assert_close_to_max(got.cpu(), want.cpu(), 1e-5)
    assert torch.equal(got, got.T)
    # against a float64 Gram of the same P, the kernel's 3xTF32 product is
    # held to twice the float32 product's error (plus one float32 spacing of
    # max|G|, for shapes where the float32 product happens to be exact)
    p64 = torch.where(mask, z.double().clamp(-2.0, 2.0), 0) * region[None, :].double()
    g64 = p64 @ p64.T
    err, plain_err = ((g.double() - g64).abs().max().item() for g in (got, want))
    spacing = np.spacing(np.float32(g64.abs().max().item()))
    assert err <= 2 * plain_err + spacing, (err, plain_err)


def _tie_d2(rng, cuda, n, r, valid):
    """Distances of z rounded to 1/4, so many tie exactly."""
    zp = torch.tensor(np.round(rng.normal(size=(n, r)) * 4) / 4, dtype=torch.float32, device=cuda)
    ones = torch.ones_like(zp, dtype=torch.bool)
    return d2_matrix(zp, ones, ones[0], 1e30, row_valid=valid)


def _dipcn_case(case, cuda):
    """(d2, rnorm, nbr_w, usable, valid), k, n_nbr of one named case."""
    rng = np.random.default_rng(sorted(_DIPCN_CASES).index(case))
    n, w, r, k, n_nbr = _DIPCN_CASES[case]
    valid = torch.tensor(rng.random(n) > 0.1, device=cuda)
    usable = torch.tensor(rng.random(w) > 0.2, device=cuda)
    big = torch.finfo(torch.float32).max
    if case == "all-equal":  # z all zero: every off-diagonal distance is 0
        ones = torch.ones((n, r), dtype=torch.bool, device=cuda)
        d2 = d2_matrix(torch.zeros((n, r), device=cuda), ones, ones[0], 1e30, row_valid=valid)
    elif case == "narrow-band":  # keys differ only in their low ~22 bits, as in the slice
        d2 = torch.tensor(rng.uniform(3830, 5185, (n, w)), dtype=torch.float32, device=cuda)
        d2[:, 7] = d2[:, 3]
        d2.masked_fill_(~valid[None, :], big).fill_diagonal_(big)
    elif case == "wide":  # quantized random distances, non-square
        d2 = torch.tensor(rng.integers(0, 400, (n, w)) * 0.25, dtype=torch.float32, device=cuda)
        d2[:, rng.random(w) < 0.05] = big
    elif case == "no-usable-row":  # row 0's k nearest are all unusable
        usable[: w // 2] = False
        d2 = torch.tensor(rng.uniform(1, 2, (n, w)), dtype=torch.float32, device=cuda)
        d2[0, usable] += 10
        d2.fill_diagonal_(big)
    else:
        d2 = _tie_d2(rng, cuda, n, r, valid)
    rnorm = torch.tensor(rng.uniform(0.5, 2.0, n), dtype=torch.float32, device=cuda)
    nbr_w = torch.tensor(rng.uniform(0.5, 2.0, w), dtype=torch.float32, device=cuda)
    return (d2, rnorm, nbr_w, usable, valid), k, n_nbr


# case: (n, w, r, k, n_nbr); r is z's width where the case makes d2 from z
_DIPCN_CASES = {
    "ties-97": (97, 97, 16, 20, 7),
    "ties-300": (300, 300, 40, 60, 50),
    "ties-k199": (200, 200, 8, 199, 300),
    "all-equal": (300, 300, 16, 60, 50),
    "k-equals-w": (97, 97, 16, 97, 40),
    "n_nbr-beyond-usable": (200, 200, 16, 30, 500),
    "no-usable-row": (128, 128, 0, 20, 7),
    "narrow-band": (512, 512, 0, 100, 60),
    "wide": (64, 23170, 0, 500, 300),
}


@pytest.mark.parametrize("case", list(_DIPCN_CASES))
def test_dipcn_kernel_on_ties(cuda, case):
    args, k, n_nbr = _dipcn_case(case, cuda)
    before = dipcn_from_distances_gpu.launches
    got, gok = dipcn_from_distances_gpu(*args, k=k, n_nbr=n_nbr)
    assert dipcn_from_distances_gpu.launches == before + 1
    want, wok = dipcn_from_distances(*args, k=k, n_nbr=n_nbr)
    assert torch.equal(gok, wok)
    torch.testing.assert_close(got[gok], want[gok], rtol=1e-6, atol=0)
    if case == "no-usable-row":
        assert not gok[0]
    # the wide mode lists and sums the same columns in the same order
    wide, wide_ok = _launch("wide", *args, k, n_nbr)
    assert torch.equal(wide_ok, gok) and torch.equal(wide, got)


def test_kernels_refuse_what_they_do_not_take(cuda):
    z = torch.zeros((8, 4), dtype=torch.float64, device=cuda)
    mask = torch.ones((8, 4), dtype=torch.bool, device=cuda)
    with pytest.raises(TypeError):
        zprep_gram(z.half(), mask, mask[0], 2.0)  # float32 and float64 only
    with pytest.raises(ValueError):
        zprep_gram(z.float().t(), mask.t(), mask[:, 0], 2.0)  # not contiguous
    with pytest.raises(ValueError):
        masked_column_stats(z.float(), mask, torch.ones(8, device="cpu"))  # mixed devices
    d2 = torch.zeros((8, 8), device=cuda)
    v = torch.ones(8, device=cuda)
    with pytest.raises(ValueError):
        dipcn_from_distances_gpu(d2, v, v, v > 0, v > 0, k=9, n_nbr=3)


def test_cohort_step_on_card_matches_plain_route(cuda):
    rng = np.random.default_rng(0)
    n, r = 256, 192
    values = rng.uniform(20, 40, (n, r)) * rng.normal(1, 0.1, (n, r)).clip(0.5, None)
    mask = rng.random((n, r)) > 0.02
    reads = rng.integers(500, 3000, n).astype(np.float64)
    reads_valid = rng.random(n) > 0.05
    ring = [[((h + 2) % (2 * n), 1.0), ((h - 2) % (2 * n), 0.5)] for h in range(2 * n)]
    hap = pad_hap_neighbors(ring, 2)
    params = CohortParams(num_neighbors=50, n_nbr=30, n_iters=10, quantize=False)
    args = (values, mask, reads, reads_valid, *hap)
    got = outputs_to_numpy(cohort_step(*inputs_to_torch(*args, cuda, torch.float32), params))
    want = outputs_to_numpy(cohort_step(*inputs_to_torch(*args, "cpu", torch.float32), params))
    assert_close_to_max(got.z, want.z, 1e-5)
    neighbor_rows_differing(got.nbr_idx, got.nbr_sq_dists, want.nbr_idx, want.nbr_sq_dists,
                            tol=1e-5 * want.nbr_sq_dists[:, -1])
    np.testing.assert_array_equal(got.dipcn_valid, want.dipcn_valid)
    same = got.dipcn_valid & ~dipcn_sets_differ(got.nbr_idx, want.nbr_idx,
                                                reads_valid & want.z_mask.any(axis=1), 30)
    np.testing.assert_allclose(got.dipcn[same], want.dipcn[same], rtol=1e-5)


@pytest.mark.parametrize("n,r", [(300, 257), (515, 130), (1000, 70)])
def test_zprep_gram_panel_kernel(cuda, n, r):
    rng = np.random.default_rng(n)
    z = torch.tensor(rng.normal(size=(n, r)) * 3, dtype=torch.float32, device=cuda)
    mask = torch.tensor(rng.random((n, r)) > 0.1, device=cuda)
    region = torch.tensor(rng.random(r) > 0.2, device=cuda)
    before = zprep_split.launches, zprep_gram_panel.launches
    split = zprep_split(z, mask, region, 2.0)
    plain = zprep_split_plain(z, mask, region, 2.0)
    # the norms are the diagonal of the same 3xTF32 product as G's
    assert torch.equal(split.norms, torch.diagonal(zprep_gram(z, mask, region, 2.0)))
    assert_close_to_max(split.norms.cpu(), plain.norms.cpu(), 1e-5)
    p64 = torch.where(mask, z.double().clamp(-2.0, 2.0), 0) * region[None, :].double()
    # aligned, unaligned and ragged-last panels, and a panel of one row
    panels = [(0, min(512, n)), (128, 100), (77, 200), (n - n % 97 - 1, n % 97 + 1), (n - 1, 1)]
    for i0, rows in panels:
        got = zprep_gram_panel(split, i0, rows)
        want = zprep_gram_panel_plain(plain, i0, rows)
        assert got.shape == (rows, n)
        assert_close_to_max(got.cpu(), want.cpu(), 1e-5)
        g64 = p64[i0:i0 + rows] @ p64.T
        err, plain_err = ((g.double() - g64).abs().max().item() for g in (got, want))
        spacing = np.spacing(np.float32(g64.abs().max().item()))
        assert err <= 2 * plain_err + spacing, (i0, rows, err, plain_err)
    assert (zprep_split.launches, zprep_gram_panel.launches) == (before[0] + 1,
                                                                 before[1] + len(panels))
    with pytest.raises(ValueError):
        zprep_gram_panel(split, n - 3, 4)
    # z prepared already: no mask, no region, no clip
    p = plain.p.contiguous()
    bare = zprep_split(p, None, None, float("inf"))
    assert_close_to_max(zprep_gram_panel(bare, 5, 50).cpu(), (p[5:55] @ p.T).cpu(), 1e-5)


@pytest.mark.parametrize("n,world,r", [(300, 3, 70), (1000, 4, 130), (1100, 2, 257),
                                         (4096, 4, 64), (97, 2, 33)])
def test_zprep_gram_cross_equals_the_panel_entries(cuda, n, world, r):
    """The ring's block products, for every pair of blocks of B = ceil(n/W)
    rows (ragged B and 128-aligned B), are bitwise the entries of one
    zprep_gram_panel over all n rows, the mirrored lower halves of its
    diagonal tiles included, and within 1e-5 of the plain P_a P_b^T."""
    rng = np.random.default_rng(n + world)
    z = torch.tensor(rng.normal(size=(n, r)) * 3, dtype=torch.float32, device=cuda)
    mask = torch.tensor(rng.random((n, r)) > 0.1, device=cuda)
    region = torch.tensor(rng.random(r) > 0.2, device=cuda)
    zp = torch.where(mask, z.clamp(-2.0, 2.0), 0) * region[None, :].float()
    panel = zprep_gram_panel(zprep_split(zp, None, None, float("inf")), 0, n)
    b = -(-n // world)
    zpad = torch.cat([zp, zp.new_zeros((b * world - n, r))])
    blocks = [zprep_split(zpad[i * b:(i + 1) * b].contiguous(), None, None, float("inf"))
              for i in range(world)]
    plain = [zprep_split_plain(zpad[i * b:(i + 1) * b], None, None, float("inf"))
             for i in range(world)]
    before = zprep_gram_cross.launches
    for a in range(world):
        for o in range(world):
            g = zprep_gram_cross(blocks[a], blocks[o], a * b, o * b)
            assert g.shape == (b, b)
            ra, ro = min(b, n - a * b), min(b, n - o * b)
            if ra > 0 and ro > 0:
                want = panel[a * b:a * b + ra, o * b:o * b + ro]
                assert torch.equal(g[:ra, :ro], want), (a, o)
            assert_close_to_max(g.cpu(), zprep_gram_cross_plain(plain[a], plain[o]).cpu(), 1e-5)
    assert zprep_gram_cross.launches == before + world * world
    with pytest.raises(ValueError):
        zprep_gram_cross(blocks[0], blocks[1], -1, 0)


# case: (n, w, k, n_nbr)
_WIDE_CASES = {
    "w40000-ties": (48, 40000, 500, 300),
    "w40000-k-equals-w": (16, 40000, 40000, 300),
    "w65536-ties": (64, 65536, 500, 300),
    "w65600-past-uint16": (40, 65600, 500, 300),
    "w65600-k-beyond-body": (8, 65600, 50000, 70000),
    "w65536-no-usable-row": (16, 65536, 500, 300),
    "w131072": (8, 131072, 500, 300),
}


@pytest.mark.parametrize("case", list(_WIDE_CASES))
def test_dipcn_kernel_wide_rows(cuda, case):
    n, w, k, n_nbr = _WIDE_CASES[case]
    rng = np.random.default_rng(w + k)
    big = torch.finfo(torch.float32).max
    # quantized distances: each value repeats ~w/400 times across the row,
    # so the k-th distance sits in a tie group that spans the whole row
    d2 = torch.tensor(rng.integers(0, 400, (n, w)) * 0.25, dtype=torch.float32, device=cuda)
    # self / invalid-row columns; past the body (keys < finfo.max) when k is
    d2[:, rng.random(w) < (0.3 if "beyond-body" in case else 0.05)] = big
    usable = torch.tensor(rng.random(w) > 0.2, device=cuda)
    if w > 65536:  # the nearest columns and a tie group lie past column 65,535
        d2[:, 65540:] = 0.0
        d2[:, 65536:65540] = 0.25
    if case == "w65536-no-usable-row":
        usable[: w // 2] = False
        d2[0, usable] += 200.0  # row 0's k nearest are all unusable
    rnorm = torch.tensor(rng.uniform(0.5, 2.0, n), dtype=torch.float32, device=cuda)
    nbr_w = torch.tensor(rng.uniform(0.5, 2.0, w), dtype=torch.float32, device=cuda)
    valid = rnorm > 0.6
    args = (d2, rnorm, nbr_w, usable, valid)
    mode = dipcn_select_mode(w, k, cuda)
    assert mode == "wide"  # past the columns 4 resident blocks an SM hold
    before = dipcn_from_distances_gpu.launches
    got, gok = dipcn_from_distances_gpu(*args, k=k, n_nbr=n_nbr)
    assert dipcn_from_distances_gpu.launches == before + 1
    want, wok = dipcn_from_distances(*args, k=k, n_nbr=n_nbr)
    assert torch.equal(gok, wok)
    torch.testing.assert_close(got[gok], want[gok], rtol=1e-6, atol=0)
    if case == "w65536-no-usable-row":
        assert not gok[0]
    if dipcn_select_info(w, k, cuda, mode="resident")["blocks_per_sm"]:
        # the resident mode, where it fits, lists and sums the same columns
        # in the same order
        res, res_ok = _launch("resident", *args, k, n_nbr)
        assert torch.equal(res_ok, gok) and torch.equal(res, got)


def test_dipcn_kernel_refuses_rows_no_mode_takes(cuda):
    w = 65600  # at k = W the int32 list alone needs 262,400 bytes
    assert dipcn_select_mode(w, w, cuda) is None
    d2 = torch.zeros((2, w), device=cuda)
    v = torch.ones(w, device=cuda)
    with pytest.raises(ValueError):
        dipcn_from_distances_gpu(d2, v[:2], v, v > 0, v[:2] > 0, k=w, n_nbr=3)


@pytest.mark.parametrize("k", [500, 4000])
def test_dipcn_mode_switch_at_the_shared_memory_edge(cuda, k):
    """The resident mode runs while 4 of its blocks fit an SM's shared
    memory: at the widest such row, and the wide mode one column past it
    (where the resident mode still fits, at 3 blocks an SM)."""
    lo, hi = k, 65536  # the widest resident row lies in [lo, hi]
    assert dipcn_select_mode(lo, k, cuda) == "resident"
    assert dipcn_select_mode(hi, k, cuda) == "wide"
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if dipcn_select_mode(mid, k, cuda) == "resident" else (lo, mid)
    assert dipcn_select_info(lo, k, cuda, mode="resident")["blocks_per_sm"] >= 4
    assert 0 < dipcn_select_info(hi, k, cuda, mode="resident")["blocks_per_sm"] < 4
    rng = np.random.default_rng(k)
    for w, mode in ((lo, "resident"), (hi, "wide")):
        assert dipcn_select_mode(w, k, cuda) == mode
        d2 = torch.tensor(rng.integers(0, 300, (24, w)) * 0.5, dtype=torch.float32, device=cuda)
        usable = torch.tensor(rng.random(w) > 0.3, device=cuda)
        nbr_w = torch.tensor(rng.uniform(0.5, 2.0, w), dtype=torch.float32, device=cuda)
        rnorm = torch.ones(24, device=cuda)
        args = (d2, rnorm, nbr_w, usable, rnorm > 0)
        got, gok = dipcn_from_distances_gpu(*args, k=k, n_nbr=300)
        want, wok = dipcn_from_distances(*args, k=k, n_nbr=300)
        assert torch.equal(gok, wok)
        torch.testing.assert_close(got[gok], want[gok], rtol=1e-6, atol=0)
        other = "wide" if mode == "resident" else "resident"
        res, res_ok = _launch(other, *args, k, 300)
        assert torch.equal(res_ok, gok) and torch.equal(res, got)


# dipcn_select's mode table (chip_smoke.py phase 5): its widths at k=500
_MODE_TABLE_W = (2504, 8192, 12288, 16384, 23170, 32768, 65536)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
def test_dipcn_modes_bitwise_at_the_mode_table_widths(cuda, dtype):
    """Both modes of the binary form give the same dipCN and validity
    bitwise at every width of the mode table where the resident mode fits;
    the rule picks the resident mode where at least 4 of its blocks fit an
    SM, else the wide one: N=2504 is resident in every dtype, a
    65,536-column bf16 panel wide."""
    gen = torch.Generator(device=cuda).manual_seed(12)
    big = torch.finfo(dtype).max
    for w in _MODE_TABLE_W:
        rows = 64
        d2 = (torch.randint(0, 400, (rows, w), device=cuda, generator=gen) * 0.25).to(dtype)
        d2[:, torch.rand(w, device=cuda, generator=gen) < 0.05] = big
        vec = (torch.rand(w, device=cuda, generator=gen) + 0.5).to(dtype)
        usable = torch.rand(w, device=cuda, generator=gen) > 0.2
        args = (d2, vec[:rows].contiguous(), vec, usable, usable[:rows].contiguous())
        blocks = dipcn_select_info(w, 500, cuda, dtype=dtype, mode="resident")["blocks_per_sm"]
        mode = dipcn_select_mode(w, 500, cuda, dtype)
        assert mode == ("resident" if blocks >= 4 else "wide")
        wide, wide_ok = _launch("wide", *args, 500, 300)
        if blocks:
            res, res_ok = _launch("resident", *args, 500, 300)
            assert torch.equal(res_ok, wide_ok) and torch.equal(res.view(torch.uint8),
                                                                wide.view(torch.uint8))
        got, ok = dipcn_from_distances_gpu(*args, k=500, n_nbr=300)
        assert torch.equal(ok, wide_ok) and torch.equal(got.view(torch.uint8),
                                                        wide.view(torch.uint8))
    assert dipcn_select_mode(2504, 500, cuda, dtype) == "resident"
    if dtype == torch.bfloat16:
        assert dipcn_select_mode(65536, 500, cuda, dtype) == "wide"


def test_cohort_panel_branch_on_card_matches_plain_route_and_resident(cuda):
    rng = np.random.default_rng(1)
    n, r = 700, 160
    values = rng.uniform(20, 40, (n, r)) * rng.normal(1, 0.1, (n, r)).clip(0.5, None)
    mask = rng.random((n, r)) > 0.02
    reads = rng.integers(500, 3000, n).astype(np.float64)
    reads_valid = rng.random(n) > 0.05
    ring = [[((h + 2) % (2 * n), 1.0), ((h - 2) % (2 * n), 0.5)] for h in range(2 * n)]
    args = (values, mask, reads, reads_valid, *pad_hap_neighbors(ring, 2))
    panel = CohortParams(num_neighbors=60, n_nbr=30, n_iters=10, quantize=False, row_block=256,
                         d2_budget_bytes=0)
    before = zprep_split.launches, zprep_gram_panel.launches, dipcn_from_distances_gpu.launches
    got = outputs_to_numpy(cohort_step(*inputs_to_torch(*args, cuda, torch.float32), panel))
    assert (zprep_split.launches - before[0], zprep_gram_panel.launches - before[1],
            dipcn_from_distances_gpu.launches - before[2]) == (1, 3, 3)
    resident = panel._replace(d2_budget_bytes=2 << 30)
    for want_params, device in ((panel, "cpu"), (resident, cuda)):
        want = outputs_to_numpy(cohort_step(*inputs_to_torch(*args, device, torch.float32),
                                            want_params))
        assert_close_to_max(got.z, want.z, 1e-5)
        neighbor_rows_differing(got.nbr_idx, got.nbr_sq_dists, want.nbr_idx, want.nbr_sq_dists,
                                tol=1e-5 * want.nbr_sq_dists[:, -1])
        np.testing.assert_array_equal(got.dipcn_valid, want.dipcn_valid)
        usable = reads_valid & want.z_mask.any(axis=1)
        same = got.dipcn_valid & ~dipcn_sets_differ(got.nbr_idx, want.nbr_idx, usable, 30)
        np.testing.assert_allclose(got.dipcn[same], want.dipcn[same], rtol=1e-5)


def _multi_weights(rng, cuda, n, w, n_loci):
    """rnorm [N, L], nbr_w [W, L] and sample_valid [N, L] for L loci."""
    rnorm = torch.tensor(rng.uniform(0.5, 2.0, (n, n_loci)), dtype=torch.float32, device=cuda)
    nbr_w = torch.tensor(rng.uniform(0.5, 2.0, (w, n_loci)), dtype=torch.float32, device=cuda)
    valid = torch.tensor(rng.random((n, n_loci)) > 0.1, device=cuda)
    return rnorm, nbr_w, valid


# the binary cases' distances with L loci's weights: several passes over
# the loci (L > 128 threads), and the wide mode past column 65,535
_MULTI_CASES = {"ties-97": 5, "ties-300": 130, "ties-k199": 3, "all-equal": 7,
                "k-equals-w": 2, "n_nbr-beyond-usable": 4, "no-usable-row": 3,
                "narrow-band": 33, "wide": 9}


@pytest.mark.parametrize("case", list(_MULTI_CASES))
def test_dipcn_multi_kernel_against_its_plain_version(cuda, case):
    (d2, _, _, usable, _), k, n_nbr = _dipcn_case(case, cuda)
    n, w = d2.shape
    rnorm, nbr_w, valid = _multi_weights(np.random.default_rng(w), cuda, n, w,
                                         _MULTI_CASES[case])
    args = (d2, rnorm, nbr_w, usable, valid)
    before = dipcn_from_distances_multi_gpu.launches
    got, gok = dipcn_from_distances_multi_gpu(*args, k=k, n_nbr=n_nbr)
    assert dipcn_from_distances_multi_gpu.launches == before + 1
    want, wok = dipcn_from_distances_multi(*args, k=k, n_nbr=n_nbr)
    assert torch.equal(gok, wok)
    torch.testing.assert_close(got[gok], want[gok], rtol=1e-5, atol=0)
    if case == "no-usable-row":
        assert not gok[0].any()
    # the wide mode compacts and sums the same columns in the same order
    wide, wide_ok = _launch_multi("wide", *args, k, n_nbr)
    assert torch.equal(wide_ok, gok) and torch.equal(wide, got)
    info = dipcn_select_info(w, k, cuda, multi=True)
    assert info["spill_bytes"] == 0 and info["mode"] == dipcn_select_mode(w, k, cuda)


@pytest.mark.parametrize("case", ["ties-300", "all-equal", "narrow-band", "wide"])
def test_dipcn_multi_kernel_per_locus_equals_the_binary_kernel(cuda, case):
    """L=1, and each column of L=6, against the binary kernel on the same
    weights: the same sets (``ok`` equal), values within rtol 1e-6."""
    (d2, _, _, usable, _), k, n_nbr = _dipcn_case(case, cuda)
    n, w = d2.shape
    rnorm, nbr_w, valid = _multi_weights(np.random.default_rng(n + w), cuda, n, w, 6)
    for loci in (slice(0, 1), slice(0, 6)):
        got, gok = dipcn_from_distances_multi_gpu(
            d2, rnorm[:, loci].contiguous(), nbr_w[:, loci].contiguous(), usable,
            valid[:, loci].contiguous(), k=k, n_nbr=n_nbr)
        for j in range(got.shape[1]):
            want, wok = dipcn_from_distances_gpu(
                d2, rnorm[:, j].contiguous(), nbr_w[:, j].contiguous(), usable,
                valid[:, j].contiguous(), k=k, n_nbr=n_nbr)
            assert torch.equal(gok[:, j], wok)
            torch.testing.assert_close(got[wok, j], want[wok], rtol=1e-6, atol=0)


def test_dipcn_multi_kernel_wide_rows_past_uint16(cuda):
    """Rows of 65,600 columns (the wide mode's int32 lists), 40 loci."""
    n, w, k, n_nbr = 24, 65600, 500, 300
    rng = np.random.default_rng(w)
    d2 = torch.tensor(rng.integers(0, 400, (n, w)) * 0.25, dtype=torch.float32, device=cuda)
    d2[:, rng.random(w) < 0.05] = torch.finfo(torch.float32).max
    d2[:, 65540:] = 0.0  # the nearest columns and a tie group past column 65,535
    d2[:, 65536:65540] = 0.25
    usable = torch.tensor(rng.random(w) > 0.2, device=cuda)
    rnorm, nbr_w, valid = _multi_weights(rng, cuda, n, w, 40)
    assert dipcn_select_mode(w, k, cuda) == "wide"
    got, gok = dipcn_from_distances_multi_gpu(d2, rnorm, nbr_w, usable, valid, k=k, n_nbr=n_nbr)
    want, wok = dipcn_from_distances_multi(d2, rnorm, nbr_w, usable, valid, k=k, n_nbr=n_nbr)
    assert torch.equal(gok, wok)
    torch.testing.assert_close(got[gok], want[gok], rtol=1e-5, atol=0)


def test_dipcn_multi_kernel_refuses_what_it_does_not_take(cuda):
    d2 = torch.zeros((8, 8), device=cuda)
    w2 = torch.ones((8, 3), device=cuda)
    usable = torch.ones(8, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):
        dipcn_from_distances_multi_gpu(d2, w2, w2, usable, w2 > 0, k=9, n_nbr=3)
    with pytest.raises(ValueError):  # 1-D weights: the binary form's
        dipcn_from_distances_multi_gpu(d2, w2[:, 0], w2[:, 0], usable, usable, k=4, n_nbr=3)
    with pytest.raises(ValueError):  # nbr_w of another locus count
        dipcn_from_distances_multi_gpu(d2, w2, w2[:, :2].contiguous(), usable, w2 > 0, k=4,
                                       n_nbr=3)


def test_dipcn_multi_panels_on_card_match_the_plain_panels(cuda):
    """The panel route of the sweep (split, Gram panels, multi kernel) on a
    ragged last panel, against the plain panel form on the card."""
    rng = np.random.default_rng(5)
    n, r, n_loci = 1100, 40, 12
    zp = torch.tensor(np.round(rng.normal(size=(n, r)) * 4) / 4, dtype=torch.float32, device=cuda)
    usable = torch.tensor(rng.random(n) > 0.2, device=cuda)
    rnorm, nbr_w, _ = _multi_weights(rng, cuda, n, n, n_loci)
    valid = usable[:, None].expand(n, n_loci).contiguous()
    row_valid = torch.ones(n, dtype=torch.bool, device=cuda)
    before = (zprep_split.launches, zprep_gram_panel.launches,
              dipcn_from_distances_multi_gpu.launches)
    got, gok = dipcn_multi_panels_gpu(zp, rnorm, nbr_w, usable, valid, k=60, n_nbr=30,
                                      row_block=512, row_valid=row_valid)
    assert (zprep_split.launches, zprep_gram_panel.launches,
            dipcn_from_distances_multi_gpu.launches) == (before[0] + 1, before[1] + 3,
                                                         before[2] + 3)
    want, wok = dipcn_from_distances_panels(zp, rnorm, nbr_w, usable, valid, k=60, n_nbr=30,
                                            row_block=512, row_valid=row_valid)
    assert torch.equal(gok, wok)
    torch.testing.assert_close(got[gok], want[gok], rtol=1e-5, atol=0)


# ------------------------------------------ the pipeline from alignments ---

QUANTUM = 0.01001  # one %.2f step, with room for the last digit of a float


def _wgs_from_bam(tmp_path, cohort, name, device):
    """One ``run_wgs_pipeline`` of steps 1-7 from the cohort's BAMs (its
    own output and work directories); returns (output dir, launches)."""
    import copy

    from grid_tpu_torch.pipeline import run_wgs_pipeline

    counted = (masked_column_stats, zprep_gram, dipcn_from_distances_gpu, zprep_split,
               zprep_gram_panel)
    cfg = copy.deepcopy(cohort["config"])
    cfg["output_dir"] = str(tmp_path / name)
    cfg["mosdepth"]["work_dir"] = str(tmp_path / name / "work")
    cfg["device"] = device
    for fn in counted:
        fn.launches = 0
    run_wgs_pipeline(console=None, config=cfg)
    return tmp_path / name, {fn.__name__: fn.launches for fn in counted}


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "files"])
def test_wgs_from_bam_on_card_matches_the_cpu_run(cuda, tmp_path, fused):
    """A small BAM cohort through steps 1-7 on the card (no platform named)
    and with ``platform: cpu``, both float32: steps 1-3 identical, z within
    one %.2f quantum, neighbors under the tie rule, dipCN at rtol 1e-5 on
    rows whose input sets agree; the kernels launched as the form says."""
    import gzip

    from grid_tpu_torch.io.formats import read_dipcn, read_neighbors, read_normalized_data
    from grid_tpu_torch.synth import make_synthetic_cohort_with_alignments

    n = 64
    cohort = make_synthetic_cohort_with_alignments(tmp_path / "cohort", n_samples=n, seed=3,
                                                   indel_frac=0.1)
    card, launches = _wgs_from_bam(tmp_path, cohort, "card", {"fused": fused})
    cpu, cpu_launches = _wgs_from_bam(tmp_path, cohort, "cpu",
                                      {"fused": fused, "platform": "cpu", "dtype": "float32"})
    assert not any(cpu_launches.values())
    want = ({"masked_column_stats": 2, "zprep_gram": 1, "dipcn_from_distances_gpu": 1,
             "zprep_split": 0, "zprep_gram_panel": 0} if fused else
            {"masked_column_stats": 2, "zprep_gram": 0, "dipcn_from_distances_gpu": 0,
             "zprep_split": 1, "zprep_gram_panel": 1})
    assert launches == want
    for name in ("read_counts.tsv", "mosdepth_results.tsv"):
        got, ref = ((out / name).read_text().splitlines() for out in (card, cpu))
        assert got[0] == ref[0] and sorted(got[1:]) == sorted(ref[1:]) and len(got) == n + 1
    for bed in sorted((cpu / "work").iterdir()):
        assert gzip.open(card / "work" / bed.name).read() == gzip.open(bed).read()
    ids, _, z, scales = read_normalized_data(card / "mosdepth_results_normalized.tsv.gz")
    c_ids, _, c_z, c_scales = read_normalized_data(cpu / "mosdepth_results_normalized.tsv.gz")
    assert ids == c_ids and z.shape == c_z.shape
    np.testing.assert_array_equal(np.isnan(z), np.isnan(c_z))
    assert np.nanmax(np.abs(z - c_z)) <= QUANTUM
    nbrs, _ = read_neighbors(card / "neighbor_coverage.zMax2.0.tsv.gz")
    c_nbrs, _ = read_neighbors(cpu / "neighbor_coverage.zMax2.0.tsv.gz")
    row = {s: i for i, s in enumerate(ids)}
    idx, c_idx = (np.array([[row[m] for m, _, _ in lists[s]] for s in ids])
                  for lists in (nbrs, c_nbrs))
    d, c_d = (np.array([[dist for _, _, dist in lists[s]] for s in ids])
              for lists in (nbrs, c_nbrs))
    # written distances are rounded to %.2f: ties are within that quantum
    neighbor_rows_differing(idx, d, c_idx, c_d, tol=QUANTUM)
    d_ids, dip, _ = read_dipcn(card / "diploid_genotypes.tsv")
    c_ids6, c_dip, _ = read_dipcn(cpu / "diploid_genotypes.tsv")
    assert d_ids == c_ids6
    same = ~dipcn_sets_differ(idx, c_idx, np.ones(n, bool), n - 1)
    np.testing.assert_allclose(np.asarray(dip)[same], np.asarray(c_dip)[same], rtol=1e-5)


# ---- the Smith-Waterman kernel (csrc/sw_scores.cu) --------------------------

@functools.cache
def _sw_cases():
    from torch_sw_cases import sw_cases

    return {case[0]: case for case in sw_cases(main_q=2048)}


def _sw_case(label):
    return _sw_cases()[label]


@pytest.mark.parametrize("label", ["main", "q1-lq1", "pad-and-n", "lr-45-97", "lr-700-shared",
                                   "lq-gt-lr", "scores-3-2-3", "gap-0", "forced-ties",
                                   "lr-255", "lr-256", "lr-257", "lr-511", "lr-512", "lr-513",
                                   "lr-3-lt-g", "units-ragged", "gap+1", "scores-300",
                                   "codes-past-4"])
def test_sw_scores_kernel_against_its_plain_version(cuda, label):
    """Exact int32 equality with the plain scan on the card, in both
    modes, at every G of the register mode's lane groups in both its forms,
    for int8, uint8 and int8 reads against uint8 references; one launch a
    call."""
    from grid_tpu_torch.ops.align import sw_scores_plain
    from grid_tpu_torch.ops.gpu_align import sw_scores_gpu

    _, q_np, r_np, (match, mismatch, gap) = _sw_case(label)
    q, r = torch.as_tensor(q_np, device=cuda), torch.as_tensor(r_np, device=cuda)
    before = sw_scores_gpu.launches
    got = sw_scores_gpu(q, r, match=match, mismatch=mismatch, gap=gap)
    assert sw_scores_gpu.launches == before + 1
    want = sw_scores_plain(q, r, match=match, mismatch=mismatch, gap=gap)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    as_u8 = sw_scores_gpu(q.view(torch.uint8), r.view(torch.uint8), match=match,
                          mismatch=mismatch, gap=gap)
    assert torch.equal(as_u8, want)
    mixed = sw_scores_gpu(q, r.view(torch.uint8), match=match, mismatch=mismatch, gap=gap)
    assert torch.equal(mixed, sw_scores_plain(q, r.view(torch.uint8), match=match,
                                              mismatch=mismatch, gap=gap))


def test_sw_scores_kernel_equals_the_host_oracle_on_acgt(cuda):
    from torch_sw_cases import acgt_pairs

    from grid_tpu_torch.ops.align import encode_seqs, sw_score_host
    from grid_tpu_torch.ops.gpu_align import sw_scores_gpu

    for read, ref in acgt_pairs():
        got = sw_scores_gpu(torch.as_tensor(encode_seqs([read]), device=cuda),
                            torch.as_tensor(encode_seqs([ref]), device=cuda))
        assert int(got[0, 0]) == sw_score_host(read, ref)


def test_sw_scores_kernel_refuses_what_it_does_not_take(cuda):
    from grid_tpu_torch import native
    from grid_tpu_torch.ops.gpu_align import sw_scores_gpu, sw_scores_max_lr

    q = torch.zeros((8, 30), dtype=torch.int8, device=cuda)
    r = torch.zeros((3, 40), dtype=torch.int8, device=cuda)
    before = sw_scores_gpu.launches
    with pytest.raises(ValueError, match="several devices"):
        sw_scores_gpu(q, r.cpu())
    with pytest.raises(native.KernelError, match="int8 or uint8"):
        sw_scores_gpu(q.to(torch.int32), r)
    with pytest.raises(native.KernelError, match="contiguous"):
        sw_scores_gpu(torch.zeros((30, 8), dtype=torch.int8, device=cuda).T, r)
    with pytest.raises(native.KernelError, match="int32"):
        sw_scores_gpu(q, r, match=2**27)
    long_ref = torch.zeros((1, sw_scores_max_lr(cuda) + 1), dtype=torch.int8, device=cuda)
    with pytest.raises(native.KernelError, match="at most"):
        sw_scores_gpu(q, long_ref)
    assert sw_scores_gpu.launches == before
    empty = sw_scores_gpu(q[:0], r)
    assert tuple(empty.shape) == (0, 3) and sw_scores_gpu.launches == before


def test_wes_on_card_matches_the_cpu_run(cuda, tmp_path):
    """The WES pipeline on a small BAM world on the card (no platform
    named) and with ``platform: cpu``: the counts, both exon dipCN files
    and the KIV-2 estimates byte-identical; one launch per sample."""
    import copy

    from torch_sw_cases import exon_refs, reads_from

    from grid_tpu_torch.io.bamlite import encode_record, write_bam
    from grid_tpu_torch.ops.gpu_align import sw_scores_gpu
    from grid_tpu_torch.pipeline import run_wes_pipeline

    rng = np.random.default_rng(21)
    exons = dict(zip(("1A", "1B_KIV3", "1B_KIV2"), exon_refs(rng, (120, 120, 120))))
    fasta = tmp_path / "exons.fa"
    fasta.write_text("".join(f">{name}\n{seq}\n" for name, seq in exons.items()))
    aln = tmp_path / "aln"
    ids = [f"S{i}" for i in range(5)]
    for i, sid in enumerate(ids):
        reads = reads_from(rng, list(exons.values()), 30 + 10 * i, 50, n_frac=0.01)
        recs = [encode_record(0, 1000 + j, 99, read_name=f"{sid}r{j}", seq=s)
                for j, s in enumerate(reads)]
        write_bam(aln / f"{sid}.bam", [("chr6", 10_000)], recs)
    nbrs = tmp_path / "nbrs.tsv"
    nbrs.write_text("".join("\t".join([sid, "1.00"] + [x for o in ids if o != sid
                                                       for x in (o, "1.00", "0.10")]) + "\n"
                            for sid in ids))
    (tmp_path / "samples.txt").write_text("".join(f"{s}\n" for s in ids))
    base = {"samples_file": str(tmp_path / "samples.txt"), "directory_loc": str(aln),
            "reference_genome": str(fasta), "threads": 2, "file_type": "bam",
            "chrom": "chr6", "start_bp": 0, "end_bp": 10_000, "output_file_type": "tsv",
            "index": {"run": False},
            "realign": {"run": True, "exon_fasta": str(fasta), "min_score": 60},
            "exon_dipcn": {"run": True, "neighbors_file": str(nbrs), "n_neighbors": 4},
            "estimate_kiv": {"run": True}}
    outs = {}
    for name, device in (("card", None), ("cpu", {"platform": "cpu"})):
        cfg = copy.deepcopy(base)
        cfg["output_dir"] = str(tmp_path / name)
        if device:
            cfg["device"] = device
        before = sw_scores_gpu.launches
        run_wes_pipeline(config=cfg)
        outs[name] = (tmp_path / name, sw_scores_gpu.launches - before)
    assert outs["card"][1] == len(ids) and outs["cpu"][1] == 0
    for artifact in ("exon_counts.tsv", "exon_dipcn.1A.tsv", "exon_dipcn.1B.tsv",
                     "kiv2_estimates.tsv"):
        assert (outs["card"][0] / artifact).read_bytes() == \
            (outs["cpu"][0] / artifact).read_bytes()


def test_gather_form_on_one_rank_equals_the_flat_panel_loop(cuda):
    """``auto_sharded_cohort_step`` over one rank (NCCL, a group of one):
    2 column statistics, 1 split, a panel Gram and a wide-or-resident dipCN
    per 256-row panel, no cross Gram; its lists and dipCN bitwise those of
    ``_panel_knn_dipcn`` on its own z, and within the tie rule of the
    single-device step's."""
    from grid_tpu_torch.models.cohort import _panel_knn_dipcn
    from grid_tpu_torch.parallel import auto_sharded_cohort_step

    rng = np.random.default_rng(4)
    n, r = 700, 160
    values = rng.uniform(20, 40, (n, r)) * rng.normal(1, 0.1, (n, r)).clip(0.5, None)
    mask = rng.random((n, r)) > 0.02
    reads = rng.integers(500, 3000, n).astype(np.float64)
    reads_valid = rng.random(n) > 0.05
    ring = [[((h + 2) % (2 * n), 1.0), ((h - 2) % (2 * n), 0.5)] for h in range(2 * n)]
    hap = pad_hap_neighbors(ring, 2)
    params = CohortParams(num_neighbors=60, n_nbr=30, n_iters=10, quantize=False, row_block=256)
    reports = []
    got = outputs_to_numpy(auto_sharded_cohort_step(1, params, reports=reports)(
        values.astype(np.float32), mask, reads.astype(np.float32), reads_valid, *hap,
        np.ones(n, bool)))
    panels = -(-n // params.row_block)
    assert {name: reports[0][name] for name in ("masked_column_stats", "zprep_split",
                                                "zprep_gram_panel", "dipcn_from_distances_gpu",
                                                "zprep_gram_cross", "zprep_gram")} == {
        "masked_column_stats": 2, "zprep_split": 1, "zprep_gram_panel": panels,
        "dipcn_from_distances_gpu": panels, "zprep_gram_cross": 0, "zprep_gram": 0}
    z, z_mask, region = (torch.tensor(a, device=cuda) for a in (got.z, got.z_mask,
                                                                got.region_used))
    scales = torch.tensor(got.scales, device=cuda)
    usable = torch.tensor(reads_valid, device=cuda) & z_mask.any(dim=1)
    w = torch.tensor(reads, dtype=torch.float32, device=cuda) / scales
    d, idx, dip, ok = (t.cpu().numpy() for t in _panel_knn_dipcn(
        z, z_mask, region, z_mask.any(dim=1), w, usable, params))
    np.testing.assert_array_equal(got.nbr_idx, idx)
    np.testing.assert_array_equal(got.nbr_sq_dists, d)
    np.testing.assert_array_equal(got.dipcn_valid, ok)
    np.testing.assert_array_equal(got.dipcn[ok], dip[ok])
    flat = outputs_to_numpy(cohort_step(*inputs_to_torch(values, mask, reads, reads_valid, *hap,
                                                         cuda, torch.float32), params))
    assert_close_to_max(got.z, flat.z, 1e-5)
    np.testing.assert_array_equal(got.region_used, flat.region_used)
    neighbor_rows_differing(got.nbr_idx, got.nbr_sq_dists, flat.nbr_idx, flat.nbr_sq_dists,
                            tol=1e-5 * flat.nbr_sq_dists[:, -1])


_BUILD_INTO_CACHE = r"""
import sys
from pathlib import Path
from grid_tpu_torch.utils.device import enable_compilation_cache
cache = enable_compilation_cache(sys.argv[1])
from grid_tpu_torch import native
native.load("dipcn_select")
print(native.loaded_paths()[0])
"""


def test_a_named_build_cache_receives_the_nvcc_libraries(cuda, tmp_path):
    import os
    import subprocess
    import sys
    from pathlib import Path

    from grid_tpu_torch import native

    env = {k: v for k, v in os.environ.items()
           if k not in ("GRID_TPU_COMPILE_CACHE", "TRITON_CACHE_DIR")}
    before = sorted(p.name for p in native.BUILD_DIR.glob("*")) if native.BUILD_DIR.exists() \
        else []
    proc = subprocess.run([sys.executable, "-c", _BUILD_INTO_CACHE, str(tmp_path)], env=env,
                          cwd=Path(__file__).resolve().parent.parent, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    built = Path(proc.stdout.strip().splitlines()[-1])
    assert built.parent == tmp_path and built.name.startswith("libdipcn_select-")
    assert built.with_suffix(".log").exists()
    after = sorted(p.name for p in native.BUILD_DIR.glob("*")) if native.BUILD_DIR.exists() \
        else []
    assert after == before


# ---- knn_select: exact sorted k-smallest selection -------------------------


def _select_case(case, cuda):
    """(d2 [B, W] on the card, k) of one named case."""
    rng = np.random.default_rng(len(case))
    big = torch.finfo(torch.float32).max
    b, w, k = _SELECT_CASES[case][:3]
    if case.startswith("ties"):
        valid = torch.tensor(rng.random(b) > 0.1, device=cuda)
        d2 = _tie_d2(rng, cuda, b, 16, valid)
    elif case == "all-equal":
        ones = torch.ones((b, 16), dtype=torch.bool, device=cuda)
        d2 = d2_matrix(torch.zeros((b, 16), device=cuda), ones, ones[0], 1e30)
    elif case == "narrow-band":  # the slice's keys: ~22 low bits differ
        d2 = torch.tensor(rng.uniform(3830, 5185, (b, w)), dtype=torch.float32, device=cuda)
        d2[:, 7] = d2[:, 3]
        d2.fill_diagonal_(big)
    else:  # quantized: every value repeats ~w/400 times across the row
        d2 = torch.tensor(rng.integers(0, 400, (b, w)) * 0.25, dtype=torch.float32, device=cuda)
        d2[:, rng.random(w) < (0.6 if case == "past-body" else 0.05)] = big
        d2[:, 3] = torch.inf
        if w > 65536:  # the nearest columns and a tie group past column 65,535
            d2[:, 65540:65560] = 0.0
            d2[:, 65536:65540] = 0.25
    return d2.contiguous(), k


# case: (B, W, k, the mode knn_select_mode picks, its blocks a row)
_SELECT_CASES = {
    "ties-97-k1": (97, 97, 1, "resident", 1),
    "ties-97-k20": (97, 97, 20, "resident", 1),
    "ties-97-k-equals-w": (97, 97, 97, "resident", 1),
    "ties-300-k299": (300, 300, 299, "resident", 1),
    "all-equal": (300, 300, 60, "resident", 1),
    "narrow-band": (512, 512, 100, "resident", 1),
    "past-body": (64, 3000, 2000, "resident", 1),
    "quantized-2504": (256, 2504, 500, "resident", 1),
    "w8192-one-block": (32, 8192, 500, "resident", 1),
    "w8193-two-blocks-unaligned": (32, 8193, 500, "cluster", 2),
    "quantized-16884": (64, 16884, 500, "cluster", 4),
    "w65536": (64, 65536, 500, "cluster", 8),
    "w65600-past-uint16": (16, 65600, 777, "cluster", 8),
    "w100000-biobank": (16, 100000, 500, "cluster", 8),
    "w131072-k4096": (8, 131072, 4096, "cluster", 8),
    "w460000-past-the-cluster-edge": (4, 460000, 500, "wide", 1),
    "w131072-k9000": (4, 131072, 9000, "wide", 1),
    "w131072-k16384": (4, 131072, 16384, "wide", 1),
}


@pytest.mark.parametrize("case", list(_SELECT_CASES))
def test_knn_select_kernel_equals_the_stable_sort(cuda, case):
    """The wrapper's mode, over the cluster size the width picks (widths
    8,192, 8,193, 16,884 and 65,536 take 1, 2, 4 and 8 blocks), equals the
    stable sort bitwise; so does the wide mode on the same rows, and at k
    up to 16,384 on rows too wide for the shared mode."""
    from grid_tpu_torch.ops.gpu_select import (
        _knn_launch, knn_select_info, knn_select_mode, sorted_smallest_k_gpu,
    )
    from grid_tpu_torch.ops.knn import sorted_smallest_k

    d2, k = _select_case(case, cuda)
    w = d2.shape[1]
    mode, blocks = _SELECT_CASES[case][3:]
    assert knn_select_mode(w, k, cuda) == mode
    assert knn_select_info(w, k, cuda)["cluster_blocks"] == blocks
    before = sorted_smallest_k_gpu.launches
    vals, idx = sorted_smallest_k_gpu(d2, k)
    assert sorted_smallest_k_gpu.launches == before + 1
    want_v, want_i = sorted_smallest_k(d2, k)  # stable torch.sort on the card
    assert torch.equal(idx, want_i) and torch.equal(vals, want_v)
    assert idx.dtype == torch.int32 and vals.shape == (d2.shape[0], k)
    if mode != "wide":
        assert knn_select_info(w, k, cuda, "wide")["clusters"] > 0
        got_v, got_i = _knn_launch("wide", d2, k)
        assert torch.equal(got_i, idx) and torch.equal(got_v, vals)


@pytest.mark.parametrize("k", [500, 4000])
def test_knn_select_mode_switch_at_the_shared_memory_edge(cuda, k):
    """Past the widest row whose slices fit 8 blocks' shared memory the
    wide mode takes over; the rows on both sides equal the stable sort."""
    from grid_tpu_torch.ops.gpu_select import _knn_launch, knn_select_info, knn_select_mode
    from grid_tpu_torch.ops.knn import sorted_smallest_k

    lo, hi = 65536, 1 << 21  # the widest row of the shared mode lies in [lo, hi]
    assert knn_select_mode(lo, k, cuda) == "cluster"
    assert knn_select_mode(hi, k, cuda) == "wide"
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if knn_select_mode(mid, k, cuda) == "cluster" else (lo, mid)
    assert knn_select_info(lo, k, cuda)["cluster_blocks"] == 8
    rng = np.random.default_rng(k)
    for w, mode in ((lo, "cluster"), (hi, "wide")):
        d2 = torch.tensor(rng.integers(0, 300, (24, w)) * 0.5, dtype=torch.float32, device=cuda)
        got = _knn_launch(mode, d2, k)
        want = sorted_smallest_k(d2, k)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        if mode == "cluster":
            assert all(torch.equal(a, b) for a, b in zip(_knn_launch("wide", d2, k), got))


def test_knn_select_refuses_what_it_does_not_take(cuda):
    from grid_tpu_torch.ops.gpu_select import knn_select_mode, sorted_smallest_k_gpu

    d2 = torch.zeros((8, 40), device=cuda)
    with pytest.raises(TypeError):
        sorted_smallest_k_gpu(d2.half(), 3)  # float32 and float64 only
    with pytest.raises(ValueError):
        sorted_smallest_k_gpu(d2.t(), 3)  # not contiguous
    with pytest.raises(ValueError):
        sorted_smallest_k_gpu(d2, 41)
    with pytest.raises(ValueError):
        sorted_smallest_k_gpu(d2, 0)
    with pytest.raises(ValueError):
        sorted_smallest_k_gpu(d2[0], 3)  # not [B, W]
    with pytest.raises(ValueError):
        sorted_smallest_k_gpu(d2[None], 3)  # not [B, W]
    assert knn_select_mode(20000, 16385, cuda) is None  # past the 2^14-entry list
    assert knn_select_mode(1 << 21, 16384, cuda) == "wide"  # the largest list at any width
    with pytest.raises(ValueError):
        sorted_smallest_k_gpu(torch.zeros((2, 20000), device=cuda), 16385)


def test_ring_merge_on_the_kernel_equals_the_sort_merge(cuda):
    """merge_candidates on the card (knn_select of [best | d2]) equals the
    same merge on the CPU (a stable sort), payloads included."""
    from grid_tpu_torch.parallel.pknn import merge_candidates

    rng = np.random.default_rng(15)
    b, k, block = 300, 60, 700
    big = np.finfo(np.float32).max
    best_d = np.sort((rng.integers(0, 80, (b, k)) * 0.5).astype(np.float32), axis=1)
    best_d[: b // 3, k // 2:] = big
    best_i = rng.integers(0, 5000, (b, k)).astype(np.int32)
    best_p = (rng.random((b, k)).astype(np.float32),)
    d2 = (rng.integers(0, 80, (b, block)) * 0.5).astype(np.float32)
    d2[:, ::9] = big
    cols = np.arange(1000, 1000 + block, dtype=np.int32)
    pay = (rng.random(block).astype(np.float32),)

    def run(device):
        t = lambda a: torch.tensor(a, device=device)  # noqa: E731
        return merge_candidates(t(best_d), t(best_i), tuple(map(t, best_p)), t(d2), t(cols),
                                tuple(map(t, pay)), k)

    from grid_tpu_torch.ops.gpu_select import sorted_smallest_k_gpu

    before = sorted_smallest_k_gpu.launches
    got = run(cuda)
    assert sorted_smallest_k_gpu.launches == before + 1
    want = run("cpu")
    for g, w in zip((got[0], got[1], *got[2]), (want[0], want[1], *want[2])):
        assert torch.equal(g.cpu(), w)


def test_dipcn_from_lists_on_the_card_equals_the_cpu_route(cuda):
    """``CohortParams.dipcn_lists``' route on the card, on the forced-tie
    inputs and knn_select's lists: the CPU route's validity and
    dipcn_select's exactly, dipCN within 1e-6 relative of both (the same
    take-set summed in another order); each call counts one launch."""
    from grid_tpu_torch.ops.gpu_select import sorted_smallest_k_gpu
    from grid_tpu_torch.ops.select import dipcn_from_lists

    rng = np.random.default_rng(16)
    n, k, n_nbr = 300, 60, 25
    valid = torch.tensor(rng.random(n) > 0.1, device=cuda)
    d2 = _tie_d2(rng, cuda, n, 16, valid)
    rnorm = torch.tensor(rng.uniform(0.5, 2.0, n), dtype=torch.float32, device=cuda)
    nbr_w = torch.tensor(rng.uniform(0.5, 2.0, n), dtype=torch.float32, device=cuda)
    usable = torch.tensor(rng.random(n) > 0.2, device=cuda)
    usable[valid.nonzero()[:40, 0]] = False  # some rows' nearest are all unusable
    sq, idx = sorted_smallest_k_gpu(d2, k)
    before = dipcn_from_lists.launches
    got, ok = dipcn_from_lists(d2, sq, idx, rnorm, nbr_w, usable, valid, k=k, n_nbr=n_nbr)
    assert dipcn_from_lists.launches == before + 1
    cpu, cok = dipcn_from_lists(*(t.cpu() for t in (d2, sq, idx, rnorm, nbr_w, usable, valid)),
                                k=k, n_nbr=n_nbr)
    assert dipcn_from_lists.launches == before + 1  # the CPU route counts nothing
    kern, kok = dipcn_from_distances_gpu(d2, rnorm, nbr_w, usable, valid, k=k, n_nbr=n_nbr)
    assert torch.equal(ok.cpu(), cok) and torch.equal(ok, kok)
    assert 50 < int(ok.sum()) < n
    assert torch.allclose(got[ok].cpu(), cpu[cok], rtol=1e-6, atol=0)
    assert torch.allclose(got[ok], kern[kok], rtol=1e-6, atol=0)


# ---- phase_sweeps: every Jacobi sweep in one launch ------------------------


def _phasing_case(rng, n, k, reps=0):
    """irrs [N] (some NaN), padded lists [2N, K] with some empty ones; with
    ``reps``, bootstrap slots [reps, 2N, K] drawn within each degree."""
    irrs = rng.uniform(1.0, 6.0, n).astype(np.float32)
    irrs[rng.random(n) < 0.05] = np.nan
    deg = rng.integers(0, k + 1, 2 * n)
    deg[::11] = 0
    hv = np.arange(k)[None, :] < deg[:, None]
    hi = np.where(hv, rng.integers(0, 2 * n, (2 * n, k)), 0).astype(np.int32)
    hw = np.where(hv, rng.uniform(0.1, 1.0, (2 * n, k)), 0).astype(np.float32)
    slots = None
    if reps:
        slots = (rng.random((reps, 2 * n, k)) * np.maximum(deg, 1)[None, :, None]).astype(
            np.int64)
    return irrs, hi, hw, hv, slots


# (N, K, sweeps, replicates, mode): the resident mode where
# 16 C chunk + 18 chunk K bytes fit a block's shared memory (chunk =
# ceil(N / C), C = 8), else the persistent mode; N from
# 1 to 9 leaves blocks empty or with one pair, odd and even sweep counts;
# K=12 and N=6000 (a thread two or more haplotypes) keep the lists in
# shared memory, the others in registers
_SWEEP_CASES = [(97, 4, 1, 0, "resident"), (2504, 2, 100, 0, "resident"),
                (2504, 10, 100, 0, "resident"), (1000, 8, 30, 20, "resident"),
                (16384, 4, 20, 0, "persistent"), (3000, 6, 25, 3, "resident"),
                (12000, 4, 10, 3, "persistent"), (5, 3, 4, 2, "resident"),
                (16384, 2, 100, 0, "persistent"), (65536, 2, 100, 0, "persistent"),
                (65536, 10, 21, 2, "persistent"), (2504, 12, 30, 0, "resident"),
                (6000, 2, 15, 0, "resident"),
                *((n, 3, 3 + n % 2, n % 3, "resident") for n in range(1, 10))]


def _modes(n, k, cuda):
    """The modes that take N and K."""
    from grid_tpu_torch.ops.phasing import phase_sweeps_info

    resident = phase_sweeps_info(n, k, cuda, "resident")["clusters"] > 0
    return ["persistent"] + ["resident"] * resident


@pytest.mark.parametrize("n,k,n_iters,reps,mode", _SWEEP_CASES)
def test_phase_sweeps_kernel_against_its_plain_version(cuda, n, k, n_iters, reps, mode):
    """Every mode against the plain sweeps on the card: rtol 1e-5 with the
    NaN pattern identical (the kernel sums each neighbor list in slot
    order, the plain version in torch's reduction order); the wrapper's
    pick launches once (one launch for all sweeps), and every mode that
    takes the shape, launched directly, gives bitwise its values."""
    from grid_tpu_torch.ops.phasing import (
        _sweeps_launch, phase_bootstrap_slots, phase_haplotypes, phase_sweeps, phase_sweeps_gpu,
        phase_sweeps_mode,
    )

    rng = np.random.default_rng(n + k)
    irrs, hi, hw, hv, slots = _phasing_case(rng, n, k, reps)
    t = [torch.tensor(a, device=cuda) for a in (irrs, hi, hw, hv)]
    assert phase_sweeps_mode(n, k, cuda) == mode
    before = phase_sweeps_gpu.launches
    if reps:
        got = phase_bootstrap_slots(*t, torch.tensor(slots, device=cuda), 1, n_iters)[2]
        bi = torch.gather(t[1].long().expand(reps, 2 * n, k), 2, torch.tensor(slots, device=cuda))
        bw = torch.gather(t[2].expand(reps, 2 * n, k), 2, torch.tensor(slots, device=cuda))
        lists = (bi, bw)
    else:
        got = phase_haplotypes(*t, 1, n_iters).hap_irrs
        lists = (t[1], t[2])
    assert phase_sweeps_gpu.launches == before + 1
    deg = t[3].sum(dim=1).reshape(n, 2)
    phased = (deg[:, 0] >= 1) & (deg[:, 1] >= 1) & torch.isfinite(t[0])
    hap0 = torch.where(phased, t[0] / 2, torch.nan).repeat_interleave(2)
    want = phase_sweeps(hap0, t[0], *lists, t[3], n_iters)
    assert torch.equal(got.isnan(), want.isnan())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0, equal_nan=True)
    idx = lists[0].to(torch.int32).contiguous()
    for other in _modes(n, k, cuda):
        before = phase_sweeps_gpu.launches
        again = _sweeps_launch(other, hap0, t[0], idx, lists[1], t[3], n_iters,
                               torch.empty((max(reps, 1), 2 * n), device=cuda))
        assert phase_sweeps_gpu.launches == before + 1
        again = again.reshape(got.shape)
        assert torch.equal(again.isnan(), got.isnan()), other
        assert torch.equal(torch.nan_to_num(again), torch.nan_to_num(got)), other


def test_phase_sweeps_more_replicates_than_clusters_at_once(cuda):
    """At N=2504, K=10, more bootstrap replicates than the card holds
    clusters at once: the later clusters run after the first have left,
    and every replicate equals the plain sweeps (rtol 1e-5, the same NaNs)
    and the persistent mode bitwise."""
    from grid_tpu_torch.ops.phasing import (
        _sweeps_launch, phase_bootstrap_slots, phase_sweeps, phase_sweeps_info,
    )

    n, k = 2504, 10
    info = phase_sweeps_info(n, k, cuda)
    assert info["mode"] == "resident" and info["clusters"] >= 1
    reps = info["clusters"] + 9
    irrs, hi, hw, hv, slots = _phasing_case(np.random.default_rng(40), n, k, reps)
    t = [torch.tensor(a, device=cuda) for a in (irrs, hi, hw, hv)]
    s = torch.tensor(slots, device=cuda)
    got = phase_bootstrap_slots(*t, s, 1, 31)[2]
    bi = torch.gather(t[1].long().expand(reps, 2 * n, k), 2, s)
    bw = torch.gather(t[2].expand(reps, 2 * n, k), 2, s)
    deg = t[3].sum(dim=1).reshape(n, 2)
    hap0 = torch.where((deg[:, 0] >= 1) & (deg[:, 1] >= 1) & torch.isfinite(t[0]), t[0] / 2,
                       torch.nan).repeat_interleave(2)
    want = phase_sweeps(hap0, t[0], bi, bw, t[3], 31)
    assert torch.equal(got.isnan(), want.isnan())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0, equal_nan=True)
    again = _sweeps_launch("persistent", hap0, t[0], bi.to(torch.int32), bw, t[3], 31,
                           torch.empty((reps, 2 * n), device=cuda))
    assert torch.equal(again.nan_to_num(), got.nan_to_num())


def test_phase_sweeps_takes_the_callers_lists_as_they_are(cuda):
    """The wrapper fed [2N, K] and [B, 2N, K] lists in the callers' layout
    (int64 indices, a haplotype's slots contiguous), in both modes: the
    plain sweeps' values within rtol 1e-5, the same NaNs."""
    from grid_tpu_torch.ops.phasing import _sweeps_launch, phase_sweeps, phase_sweeps_gpu

    n, k, reps = 2504, 10, 5
    rng = np.random.default_rng(17)
    irrs, hi, hw, hv, slots = _phasing_case(rng, n, k, reps)
    t = [torch.tensor(a, device=cuda) for a in (irrs, hi, hw, hv)]
    s = torch.tensor(slots, device=cuda)
    hap0 = (t[0] / 2).repeat_interleave(2)
    bi = torch.gather(t[1].long().expand(reps, 2 * n, k), 2, s)
    bw = torch.gather(t[2].expand(reps, 2 * n, k), 2, s)
    for idx, w in ((t[1].long(), t[2]), (bi, bw)):
        assert idx.stride()[-1] == 1 and w.is_contiguous()
        want = phase_sweeps(hap0, t[0], idx, w, t[3], 12)
        got = phase_sweeps_gpu(hap0, t[0], idx, w, t[3], 12)
        assert got.shape == want.shape and torch.equal(got.isnan(), want.isnan())
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0, equal_nan=True)
        lead = idx.shape[0] if idx.dim() == 3 else 1
        again = _sweeps_launch("persistent", hap0, t[0], idx.to(torch.int32), w, t[3], 12,
                               torch.empty((lead, 2 * n), device=cuda)).reshape(got.shape)
        assert torch.equal(again.nan_to_num(), got.nan_to_num())


def test_phase_sweeps_mode_switch_at_the_shared_memory_edge(cuda):
    from grid_tpu_torch.ops.phasing import (
        _sweeps_launch, phase_sweeps, phase_sweeps_info, phase_sweeps_mode,
    )

    lo, hi = 1, 1 << 16  # the largest resident N at K=3 lies in [lo, hi)
    assert phase_sweeps_mode(lo, 3, cuda) == "resident"
    assert phase_sweeps_mode(hi, 3, cuda) == "persistent"
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if phase_sweeps_mode(mid, 3, cuda) == "resident" else (lo, mid)
    info = phase_sweeps_info(lo, 3, cuda)
    chunk = -(-lo // 8)
    assert info["smem_bytes"] == 16 * 8 * chunk + 18 * chunk * 3
    assert info["cluster_blocks"] == 8 and info["clusters"] >= 1
    assert info["threads"] == min(1024, -(-2 * chunk // 32) * 32)
    grid = phase_sweeps_info(hi, 3, cuda)
    assert grid["mode"] == "persistent" and grid["clusters"] == 0
    assert 1 <= grid["grid_blocks"] <= grid["blocks_per_sm"] * torch.cuda.get_device_properties(
        cuda).multi_processor_count
    for n, mode in ((lo, "resident"), (hi, "persistent")):
        assert phase_sweeps_mode(n, 3, cuda) == mode
        irrs, hi_, hw, hv, _ = _phasing_case(np.random.default_rng(n), n, 3)
        t = [torch.tensor(a, device=cuda) for a in (irrs, hi_, hw, hv)]
        hap0 = (t[0] / 2).repeat_interleave(2)
        got = _sweeps_launch(mode, hap0, t[0], t[1], t[2], t[3], 7,
                             torch.empty((1, 2 * n), device=cuda))[0]
        want = phase_sweeps(hap0, *t, 7)
        assert torch.equal(got.isnan(), want.isnan())
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0, equal_nan=True)


def test_phase_sweeps_zero_sweeps_launch_nothing(cuda):
    """Zero sweeps return the start broadcast over the replicates, as the
    plain version does, without a launch (the fused steps run the cohort
    step with empty float64 placeholder lists and no sweep)."""
    from grid_tpu_torch.ops.phasing import phase_sweeps, phase_sweeps_gpu

    irrs, hi, hw, hv, _ = _phasing_case(np.random.default_rng(1), 40, 3)
    t = [torch.tensor(a, device=cuda) for a in (irrs, hi, hw, hv)]
    hap0 = (t[0] / 2).repeat_interleave(2)
    before = phase_sweeps_gpu.launches
    for idx, w in ((t[1], t[2].double()), (t[1].expand(4, 80, 3), t[2].expand(4, 80, 3))):
        got = phase_sweeps_gpu(hap0, t[0], idx, w, t[3], 0)
        want = phase_sweeps(hap0.cpu(), t[0].cpu(), idx.cpu(), w.cpu(), t[3].cpu(), 0)
        assert got.shape == want.shape and torch.equal(got.cpu().isnan(), want.isnan())
        assert torch.equal(got.cpu().nan_to_num(), want.nan_to_num())
    assert phase_sweeps_gpu.launches == before


def test_phase_sweeps_refuses_what_it_does_not_take(cuda):
    from grid_tpu_torch.ops.phasing import phase_sweeps_gpu

    irrs, hi, hw, hv, _ = _phasing_case(np.random.default_rng(0), 50, 3)
    t = [torch.tensor(a, device=cuda) for a in (irrs, hi, hw, hv)]
    hap0 = (t[0] / 2).repeat_interleave(2)
    with pytest.raises(TypeError):
        phase_sweeps_gpu(hap0.half(), t[0].half(), t[1], t[2].half(), t[3], 3)
    with pytest.raises(TypeError):  # one value type throughout
        phase_sweeps_gpu(hap0.double(), t[0], t[1], t[2], t[3], 3)
    with pytest.raises(ValueError):
        phase_sweeps_gpu(hap0, t[0], t[1][:, :2], t[2], t[3], 3)  # idx shape
    bad = t[1].clone()
    bad[5, 0] = 100  # past 2N
    with pytest.raises(ValueError):
        phase_sweeps_gpu(hap0, t[0], bad, t[2], t[3], 3)
    with pytest.raises(ValueError):
        phase_sweeps_gpu(hap0, t[0], t[1], t[2].t().contiguous().t(), t[3], 3)  # not contiguous


def test_cohort_step_launches_each_selection_and_phasing_kernel_once(cuda):
    """The resident step launches knn_select once and phase_sweeps once; the
    panel branch one knn_select per panel."""
    from grid_tpu_torch.ops.gpu_select import sorted_smallest_k_gpu
    from grid_tpu_torch.ops.phasing import phase_sweeps_gpu

    rng = np.random.default_rng(2)
    n, r = 700, 160
    values = rng.uniform(20, 40, (n, r)) * rng.normal(1, 0.1, (n, r)).clip(0.5, None)
    mask = rng.random((n, r)) > 0.02
    reads = rng.integers(500, 3000, n).astype(np.float64)
    ring = [[((h + 2) % (2 * n), 1.0), ((h - 2) % (2 * n), 0.5)] for h in range(2 * n)]
    args = inputs_to_torch(values, mask, reads, np.ones(n, bool), *pad_hap_neighbors(ring, 2),
                           cuda, torch.float32)
    resident = CohortParams(num_neighbors=60, n_nbr=30, n_iters=10, quantize=False,
                            row_block=256)
    for params, selections in ((resident, 1), (resident._replace(d2_budget_bytes=0), 3)):
        before = sorted_smallest_k_gpu.launches, phase_sweeps_gpu.launches
        cohort_step(*args, params)
        assert (sorted_smallest_k_gpu.launches - before[0],
                phase_sweeps_gpu.launches - before[1]) == (selections, 1)


# ---- float64: every kernel of the cohort step in its float64 form ----------
#
# Bounds (the float64 contract, docs/parity.md, and PERF.md): counts, ok,
# the selections' values and positions and the dipCN take-sets exact; the
# column sums and the Gram matrix within 1e-12 of the plain version's
# largest entry (another summation order of float64 terms: ~1e-15); dipCN at
# rtol 1e-12; the phasing sweeps at rtol 1e-12 with the same NaNs, the
# bootstrap replicates at rtol 1e-10 (their values decay towards 0 and
# carry the rounding of 100 sweeps, ~250 roundings in float32's case).

F64_RTOL = 1e-12


@pytest.mark.parametrize("n,r", [(1, 1), (3, 5), (9, 33), (97, 70), (300, 257), (2504, 2048)])
def test_float64_masked_column_stats_kernel(cuda, n, r):
    rng = np.random.default_rng(n + 64)
    values = torch.tensor(rng.uniform(10, 60, (n, r)), dtype=torch.float64, device=cuda)
    values[:, r // 2] = values[:, 0]  # an exactly tied column stays tied
    mask = torch.tensor(rng.random((n, r)) > 0.15, device=cuda)
    mask[:, r // 2] = mask[:, 0]
    inv = torch.tensor(rng.uniform(0.01, 0.1, n), dtype=torch.float64, device=cuda)
    mu = torch.tensor(rng.uniform(0.5, 2.0, r), dtype=torch.float64, device=cuda)
    mu[r // 2] = mu[0]
    for col_means in (None, mu):
        before = masked_column_stats.launches
        got = masked_column_stats(values, mask, inv, col_means)
        assert masked_column_stats.launches == before + 1
        assert all(g.dtype == torch.float64 for g in got)
        want = masked_column_stats_plain(values, mask, inv, col_means)
        assert torch.equal(got[0], want[0])
        for g, w in zip(got[1:], want[1:]):
            assert_close_to_max(g.cpu(), w.cpu(), F64_RTOL)
            assert g[r // 2] == g[0]
        again = masked_column_stats(values, mask, inv, col_means)
        assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("n,r", [(1, 3), (2, 1), (5, 17), (9, 33), (97, 70), (300, 257),
                                 (515, 130), (127, 70), (128, 33), (129, 257), (257, 130)])
def test_float64_zprep_gram_kernel(cuda, n, r):
    """The FP64 tensor-core Gram against the plain float64 product: within
    1e-12 of its largest entry, exactly symmetric, masked rows and columns
    zero; the split's norms are the diagonal of the triangle's G bitwise,
    and each row panel (the whole, one from a third, one that straddles a
    128-row tile, one that ends at row N) equals the plain panel to the
    same bound and holds the norms bitwise as its G[i, i]. The sizes sit
    on and beside the 128-row tiles; R is not a multiple of the 16-column
    K-stage."""
    rng = np.random.default_rng(n + 7)
    z = torch.tensor(rng.normal(size=(n, r)) * 3, dtype=torch.float64, device=cuda)
    mask = torch.tensor(rng.random((n, r)) > 0.1, device=cuda)
    mask[n // 2] = False  # a row with no valid cell
    region = torch.tensor(rng.random(r) > 0.2, device=cuda)
    before = zprep_gram.launches
    got = zprep_gram(z, mask, region, 2.0)
    assert zprep_gram.launches == before + 1 and got.dtype == torch.float64
    want = zprep_gram_plain(z, mask, region, 2.0)
    assert_close_to_max(got.cpu(), want.cpu(), F64_RTOL)
    assert torch.equal(got, got.T)
    assert not got[n // 2].any()
    split = zprep_split(z, mask, region, 2.0)
    assert split.p.shape[:2] == (1, n) and split.p.dtype == torch.float64
    assert torch.equal(split.norms, torch.diagonal(got))
    plain_split = zprep_split_plain(z, mask, region, 2.0)
    for i0, rows in ((0, n), (n // 3, max(1, n // 2)), (100, 60),
                     (max(0, n - 37), 37)):
        i0 = min(i0, n - 1)
        rows = min(rows, n - i0)
        g = zprep_gram_panel(split, i0, rows)
        assert g.shape == (rows, n)
        assert_close_to_max(g.cpu(), zprep_gram_panel_plain(plain_split, i0, rows).cpu(),
                            F64_RTOL)
        own = torch.arange(rows, device=cuda)
        assert torch.equal(g[own, i0 + own], split.norms[i0:i0 + rows])


@pytest.mark.parametrize("mode", ["triangle", "split", "panel"])
@pytest.mark.parametrize("n", [1, 129, 2504, 65536])
def test_float64_zprep_gram_info_is_the_plan(cuda, n, mode):
    """The FP64 Gram's own launch shape (``zprep_gram64_info``) is
    ``tests/torch_plans.py``'s plan, in registers with no spill and one
    block an SM."""
    from torch_plans import zprep_gram64_plan

    rows = min(n, 512) if mode == "panel" else n
    info = zprep_gram_info(n, cuda, torch.float64, mode, rows)
    plan = zprep_gram64_plan(n, rows, mode)
    keys = ("tile", "k_tile", "stages", "threads", "smem_bytes", "blocks", "blocks_per_sm")
    assert {key: info[key] for key in keys} == {key: plan[key] for key in keys}
    assert info["spill_bytes"] == 0 and info["registers"] <= 255


def _f64_dipcn_case(rng, cuda, n, w, k, ties):
    """(d2 [n, w], rnorm, nbr_w, usable, valid) in float64: quantized
    distances (many exact ties) or spread ones, finfo.max columns."""
    big = torch.finfo(torch.float64).max
    if ties:
        d2 = rng.integers(0, 40, (n, w)) * 0.25
    else:
        d2 = rng.uniform(1000.0, 5000.0, (n, w))
    d2 = torch.tensor(d2, dtype=torch.float64, device=cuda)
    d2[:, rng.random(w) < 0.05] = big
    if n == w:
        d2.fill_diagonal_(big)
    rnorm = torch.tensor(rng.uniform(0.5, 2.0, n), dtype=torch.float64, device=cuda)
    nbr_w = torch.tensor(rng.uniform(0.5, 2.0, w), dtype=torch.float64, device=cuda)
    usable = torch.tensor(rng.random(w) > 0.2, device=cuda)
    valid = torch.tensor(rng.random(n) > 0.1, device=cuda)
    return d2.contiguous(), rnorm, nbr_w, usable, valid


# case: (rows, width, k, n_nbr, quantized)
_F64_DIPCN_CASES = {
    "one-row": (1, 3, 2, 1, True), "n9-k-equals-w": (9, 9, 9, 4, True),
    "ties-300": (300, 300, 60, 20, True), "spread-2504": (256, 2504, 500, 300, False),
    "all-equal": (64, 16, 16, 7, None), "panel-65536": (8, 65536, 500, 300, True),
}


@pytest.mark.parametrize("case", list(_F64_DIPCN_CASES))
def test_float64_dipcn_kernel(cuda, case):
    """The float64 form against the plain float64 dipCN: ok exact, dipCN at
    rtol 1e-12; its wide mode, where the resident mode also takes the row,
    gives bitwise the same values."""
    n, w, k, n_nbr, ties = _F64_DIPCN_CASES[case]
    rng = np.random.default_rng(w + k)
    args = _f64_dipcn_case(rng, cuda, n, w, k, bool(ties))
    if ties is None:
        args = (torch.zeros_like(args[0]),) + args[1:]
    before = dipcn_from_distances_gpu.launches
    dip, ok = dipcn_from_distances_gpu(*args, k=k, n_nbr=n_nbr)
    assert dipcn_from_distances_gpu.launches == before + 1 and dip.dtype == torch.float64
    pdip, pok = dipcn_from_distances(*args, k=k, n_nbr=n_nbr)
    assert torch.equal(ok, pok)
    torch.testing.assert_close(dip[ok], pdip[ok], rtol=F64_RTOL, atol=0)
    mode = dipcn_select_mode(w, k, cuda, torch.float64)
    assert mode == ("wide" if w > 20000 else "resident")
    if mode == "resident":  # the kernel's plan is the pure function's
        from torch_plans import dipcn_select_smem_bytes

        info = dipcn_select_info(w, k, cuda, dtype=torch.float64)
        assert info["smem_bytes"] == dipcn_select_smem_bytes(w, k, 8)
    if mode == "resident":
        wdip, wok = _launch("wide", *args, k, n_nbr)
        assert torch.equal(wok, ok) and torch.equal(wdip[ok], dip[ok])


def test_float64_dipcn_mode_edge_is_half_the_float32_edge(cuda):
    """The resident mode holds 8 W bytes of keys in float64: its widest row
    at k=500 lies below float32's and above a third of it."""
    def edge(dtype):
        lo, hi = 1000, 65536
        while hi - lo > 1:
            mid = (lo + hi) // 2
            lo, hi = (mid, hi) if dipcn_select_mode(mid, 500, cuda, dtype) == "resident" else (
                lo, mid)
        return lo

    e32, e64 = edge(torch.float32), edge(torch.float64)
    assert e32 / 3 < e64 < e32 * 0.6


# case: (B, W, k, the mode knn_select_mode picks in float64, its blocks a row)
_F64_SELECT_CASES = {
    "n1-w1-k1": (1, 1, 1, "resident", 1),
    "n9-ties-k-equals-w": (9, 9, 9, "resident", 1),
    "ties-300-k299": (300, 300, 299, "resident", 1),
    "all-equal": (64, 16, 16, "resident", 1),
    "past-body": (32, 3000, 2000, "resident", 1),
    "quantized-2504": (256, 2504, 500, "resident", 1),
    "spread-2504": (256, 2504, 500, "resident", 1),
    "w8192-one-block": (16, 8192, 500, "resident", 1),
    "w8193-wide-unaligned": (16, 8193, 500, "wide", 1),
    "w65536-wide": (32, 65536, 500, "wide", 1),
    "w65600-wide-past-uint16": (8, 65600, 777, "wide", 1),
    "w230000-past-the-cluster-edge": (4, 230000, 500, "wide", 1),
    "w131072-k8192": (4, 131072, 8192, "wide", 1),
}


def _f64_select_case(case, cuda):
    b, w, k = _F64_SELECT_CASES[case][:3]
    rng = np.random.default_rng(len(case) + 100)
    big = torch.finfo(torch.float64).max
    if case == "all-equal":
        d2 = torch.zeros((b, w), dtype=torch.float64, device=cuda)
    elif case.startswith("spread"):
        d2 = torch.tensor(rng.uniform(3830, 5185, (b, w)), dtype=torch.float64, device=cuda)
        d2[:, 7] = d2[:, 3]
    else:  # quantized: exact ties across the row
        d2 = torch.tensor(rng.integers(0, 400, (b, w)) * 0.01, dtype=torch.float64, device=cuda)
        d2[:, rng.random(w) < (0.6 if case == "past-body" else 0.05)] = big
        if w > 3:
            d2[:, 3] = torch.inf
        if w > 65536:
            d2[:, 65540:65560] = 0.0
            d2[:, 65536:65540] = 0.01
    return d2.contiguous(), k


@pytest.mark.parametrize("case", list(_F64_SELECT_CASES))
def test_float64_knn_select_kernel_equals_the_stable_sort(cuda, case):
    """The float64 form, in the mode it picks over the cluster size the
    width picks, equals the stable float64 sort bitwise (values and
    positions); so does its wide mode on the same rows."""
    from grid_tpu_torch.ops.gpu_select import (
        _knn_launch, knn_select_info, knn_select_mode, sorted_smallest_k_gpu,
    )
    from grid_tpu_torch.ops.knn import sorted_smallest_k

    d2, k = _f64_select_case(case, cuda)
    w = d2.shape[1]
    mode, blocks = _F64_SELECT_CASES[case][3:]
    assert knn_select_mode(w, k, cuda, torch.float64) == mode
    from torch_plans import knn_select_plan

    info, plan = knn_select_info(w, k, cuda, dtype=torch.float64), knn_select_plan(w, k, 8)
    assert info["cluster_blocks"] == blocks
    if mode == "wide":
        assert info["smem_bytes"] == plan["wide_smem_bytes"]
    else:
        assert (info["smem_bytes"], info["slice"]) == (plan["shared_smem_bytes"], plan["slice"])
    before = sorted_smallest_k_gpu.launches
    vals, idx = sorted_smallest_k_gpu(d2, k)
    assert sorted_smallest_k_gpu.launches == before + 1 and vals.dtype == torch.float64
    want_v, want_i = sorted_smallest_k(d2, k)
    assert torch.equal(idx, want_i) and torch.equal(vals, want_v)
    if mode != "wide":
        got_v, got_i = _knn_launch("wide", d2, k)
        assert torch.equal(got_i, idx) and torch.equal(got_v, vals)


def test_float64_knn_select_takes_k_up_to_8192(cuda):
    from grid_tpu_torch.ops.gpu_select import knn_select_mode, sorted_smallest_k_gpu

    assert knn_select_mode(1 << 20, 8192, cuda, torch.float64) == "wide"
    assert knn_select_mode(20000, 8193, cuda, torch.float64) is None
    with pytest.raises(ValueError):
        sorted_smallest_k_gpu(torch.zeros((2, 20000), dtype=torch.float64, device=cuda), 8193)


def test_float64_knn_select_runs_no_cluster(cuda):
    """The float64 shared mode takes one block a row: rows past 8,192
    columns go to the wide mode, and the kernel refuses the shared mode's
    launch shape over a cluster."""
    from grid_tpu_torch import native
    from grid_tpu_torch.ops.gpu_select import knn_select_info, knn_select_mode

    assert knn_select_mode(8192, 500, cuda, torch.float64) == "resident"
    assert knn_select_mode(8193, 500, cuda, torch.float64) == "wide"
    assert knn_select_mode(8193, 500, cuda, torch.float32) == "cluster"
    with pytest.raises(native.KernelError):
        knn_select_info(65536, 500, cuda, mode="cluster", dtype=torch.float64)


# (N, K, sweeps, replicates, the float64 mode)
_F64_SWEEP_CASES = [*((n, 3, 3 + n % 2, n % 3, "resident") for n in range(1, 10)),
                    (2504, 2, 100, 0, "resident"), (2504, 10, 100, 0, "resident"),
                    (1000, 8, 30, 20, "resident"), (65536, 2, 100, 0, "persistent"),
                    (12000, 4, 10, 3, "persistent")]


@pytest.mark.parametrize("n,k,n_iters,reps,mode", _F64_SWEEP_CASES)
def test_float64_phase_sweeps_kernel_against_its_plain_version(cuda, n, k, n_iters, reps, mode):
    """The float64 form against the plain float64 sweeps: rtol 1e-12 (1e-10
    for bootstrap replicates), the same NaNs; every mode that takes the
    shape gives bitwise the wrapper's values."""
    from grid_tpu_torch.ops.phasing import (
        _sweeps_launch, phase_sweeps, phase_sweeps_gpu, phase_sweeps_info, phase_sweeps_mode,
    )

    rng = np.random.default_rng(n + k + 64)
    irrs, hi, hw, hv, slots = _phasing_case(rng, n, k, reps)
    irrs_t = torch.tensor(irrs, dtype=torch.float64, device=cuda)
    idx = torch.tensor(hi, device=cuda)
    w = torch.tensor(hw, dtype=torch.float64, device=cuda)
    valid = torch.tensor(hv, device=cuda)
    if reps:
        s = torch.tensor(slots, device=cuda)
        idx = torch.gather(idx.long().expand(reps, 2 * n, k), 2, s).to(torch.int32).contiguous()
        w = torch.gather(w.expand(reps, 2 * n, k), 2, s).contiguous()
    assert phase_sweeps_mode(n, k, cuda, torch.float64) == mode
    info = phase_sweeps_info(n, k, cuda, dtype=torch.float64)
    if mode == "resident":
        from torch_plans import phase_sweeps_smem_bytes

        assert info["smem_bytes"] == phase_sweeps_smem_bytes(n, k, 8)
    deg = valid.sum(dim=1).reshape(n, 2)
    hap0 = torch.where((deg[:, 0] >= 1) & (deg[:, 1] >= 1) & torch.isfinite(irrs_t), irrs_t / 2,
                       torch.nan).repeat_interleave(2)
    before = phase_sweeps_gpu.launches
    got = phase_sweeps_gpu(hap0, irrs_t, idx, w, valid, n_iters)
    assert phase_sweeps_gpu.launches == before + 1 and got.dtype == torch.float64
    want = phase_sweeps(hap0, irrs_t, idx, w, valid, n_iters)
    assert torch.equal(got.isnan(), want.isnan())
    torch.testing.assert_close(got, want, rtol=1e-10 if reps else F64_RTOL, atol=0,
                               equal_nan=True)
    for other in ["persistent"] + ["resident"] * (mode == "resident"):
        again = _sweeps_launch(other, hap0, irrs_t, idx, w, valid, n_iters,
                               torch.empty((max(reps, 1), 2 * n), dtype=torch.float64,
                                           device=cuda)).reshape(got.shape)
        assert torch.equal(again.nan_to_num(), got.nan_to_num()), other


def test_float64_phase_sweeps_more_replicates_than_clusters_at_once(cuda):
    from grid_tpu_torch.ops.phasing import phase_sweeps, phase_sweeps_gpu, phase_sweeps_info

    n, k = 2504, 10
    info = phase_sweeps_info(n, k, cuda, dtype=torch.float64)
    assert info["mode"] == "resident" and info["clusters"] >= 1
    reps = info["clusters"] + 5
    irrs, hi, hw, hv, slots = _phasing_case(np.random.default_rng(41), n, k, reps)
    irrs_t = torch.tensor(irrs, dtype=torch.float64, device=cuda)
    s = torch.tensor(slots, device=cuda)
    idx = torch.gather(torch.tensor(hi, device=cuda).long().expand(reps, 2 * n, k), 2, s)
    w = torch.gather(torch.tensor(hw, dtype=torch.float64, device=cuda).expand(reps, 2 * n, k),
                     2, s)
    valid = torch.tensor(hv, device=cuda)
    hap0 = (irrs_t / 2).repeat_interleave(2)
    got = phase_sweeps_gpu(hap0, irrs_t, idx, w, valid, 31)
    want = phase_sweeps(hap0, irrs_t, idx, w, valid, 31)
    assert torch.equal(got.isnan(), want.isnan())
    torch.testing.assert_close(got, want, rtol=1e-10, atol=0, equal_nan=True)


def test_float64_kernels_refuse_what_they_do_not_take(cuda):
    """bfloat16 reaches the four kernels of steps 4-6 (their bf16 forms)
    and the cross-mode Gram (the sharded ring's, since bf16 runs with
    ``device.mesh_shape``), and no other: the multi-weight dipCN and the
    sweeps refuse it; mixed float32 and float64 inputs are refused by both
    dipCN forms."""
    from grid_tpu_torch.ops.gpu_kernels import SplitZ, zprep_gram_cross
    from grid_tpu_torch.ops.gpu_select import sorted_smallest_k_gpu
    from grid_tpu_torch.ops.phasing import phase_sweeps_gpu

    bf = torch.zeros((8, 8), dtype=torch.bfloat16, device=cuda)
    mask = torch.ones((8, 8), dtype=torch.bool, device=cuda)
    v = torch.ones(8, dtype=torch.bfloat16, device=cuda)
    assert zprep_gram(bf, mask, mask[0], 2.0).dtype == torch.bfloat16
    assert masked_column_stats(bf, mask, v)[1].dtype == torch.bfloat16
    assert sorted_smallest_k_gpu(bf, 3)[0].dtype == torch.bfloat16
    assert dipcn_from_distances_gpu(bf, v, v, mask[0], mask[0], k=3, n_nbr=2)[0].dtype == \
        torch.bfloat16
    with pytest.raises(TypeError):
        dipcn_from_distances_multi_gpu(bf, bf[:, :2], bf[:, :2], mask[0], mask[:, :2], k=3,
                                       n_nbr=2)
    split = SplitZ(torch.zeros((1, 8, 16), dtype=torch.bfloat16, device=cuda), v)
    assert zprep_gram_cross(split, split).dtype == torch.bfloat16
    idx = torch.zeros((16, 2), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        phase_sweeps_gpu(v.repeat(2), v, idx, bf[:2].T.repeat(2, 1)[:16],
                         torch.ones((16, 2), dtype=torch.bool, device=cuda), 1)
    d64 = torch.zeros((8, 8), dtype=torch.float64, device=cuda)
    v64 = torch.ones((8, 2), dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError):  # mixed dtypes
        dipcn_from_distances_multi_gpu(d64, v64.float(), v64, mask[0], mask[:, :2], k=3, n_nbr=2)
    with pytest.raises(TypeError):  # mixed dtypes
        dipcn_from_distances_gpu(d64, v64[:, 0].float(), v64[:, 0], mask[0], mask[0], k=3,
                                 n_nbr=2)


@pytest.mark.parametrize("branch", ["resident", "panels"])
def test_float64_cohort_step_on_card_matches_the_cpu_route(cuda, branch):
    """The float64 step on the card against the port's float64 CPU route:
    z bitwise (the column statistics' sums in float64 on both sides may
    differ in the last bit: within 1e-12 of max|z|), neighbor lists
    identical but for ties within 1e-12 of the row's k-th distance, dipCN
    at 1e-9 where the input sets agree, dipcn_valid exact; every kernel
    launched."""
    from grid_tpu_torch.ops.gpu_select import sorted_smallest_k_gpu
    from grid_tpu_torch.ops.phasing import phase_sweeps_gpu

    rng = np.random.default_rng(5)
    n, r = 400, 192
    values = rng.uniform(20, 40, (n, r)) * rng.normal(1, 0.1, (n, r)).clip(0.5, None)
    mask = rng.random((n, r)) > 0.02
    reads = rng.integers(500, 3000, n).astype(np.float64)
    reads_valid = rng.random(n) > 0.05
    ring = [[((h + 2) % (2 * n), 1.0), ((h - 2) % (2 * n), 0.5)] for h in range(2 * n)]
    hap = pad_hap_neighbors(ring, 2, dtype=np.float64)
    params = CohortParams(num_neighbors=50, n_nbr=30, n_iters=10, quantize=True, row_block=128)
    if branch == "panels":
        params = params._replace(d2_budget_bytes=0)
    args = (values, mask, reads, reads_valid, *hap)
    wrappers = (masked_column_stats, zprep_gram, zprep_split, zprep_gram_panel,
                dipcn_from_distances_gpu, sorted_smallest_k_gpu, phase_sweeps_gpu)
    before = [f.launches for f in wrappers]
    got = outputs_to_numpy(cohort_step(*inputs_to_torch(*args, cuda, torch.float64), params))
    launched = dict(zip((f.__name__ for f in wrappers),
                        (f.launches - b for f, b in zip(wrappers, before))))
    want = outputs_to_numpy(cohort_step(*inputs_to_torch(*args, "cpu", torch.float64), params))
    assert launched["masked_column_stats"] == 2 and launched["phase_sweeps_gpu"] == 1
    if branch == "resident":
        assert launched["zprep_gram"] == launched["sorted_smallest_k_gpu"] == 1
    else:
        assert launched["zprep_split"] == 1 and launched["zprep_gram_panel"] == 4
        assert launched["sorted_smallest_k_gpu"] == launched["dipcn_from_distances_gpu"] == 4
    assert got.z.dtype == np.float64
    assert_close_to_max(got.z, want.z, F64_RTOL)
    neighbor_rows_differing(got.nbr_idx, got.nbr_sq_dists, want.nbr_idx, want.nbr_sq_dists,
                            tol=F64_RTOL * want.nbr_sq_dists[:, -1])
    np.testing.assert_array_equal(got.dipcn_valid, want.dipcn_valid)
    same = got.dipcn_valid & ~dipcn_sets_differ(got.nbr_idx, want.nbr_idx,
                                                reads_valid & want.z_mask.any(axis=1), 30)
    np.testing.assert_allclose(got.dipcn[same], want.dipcn[same], rtol=1e-9)


# ---------------- float64: the multi-weight dipCN and the cross-mode Gram ---


def _as_float64(d2):
    """A float32 case's distances in float64, finfo(float32).max (self and
    invalid rows) as finfo(float64).max."""
    big32 = torch.finfo(torch.float32).max
    return torch.where(d2 == big32, torch.finfo(torch.float64).max, d2.double()).contiguous()


def _f64_multi_args(case, cuda, n_loci):
    """(d2, rnorm, nbr_w, usable, valid), k, n_nbr: a binary case's
    distances in float64 with ``n_loci`` loci's float64 weights."""
    (d2, _, _, usable, _), k, n_nbr = _dipcn_case(case, cuda)
    n, w = d2.shape
    rnorm, nbr_w, valid = _multi_weights(np.random.default_rng(w + n_loci), cuda, n, w, n_loci)
    return (_as_float64(d2), rnorm.double(), nbr_w.double(), usable, valid), k, n_nbr


@pytest.mark.parametrize("case", list(_MULTI_CASES))
def test_float64_dipcn_multi_kernel_against_its_plain_version(cuda, case):
    """The multi-weight form's float64 entry point against the float64
    plain form ([N, W] @ [W, L] of the take mask): ok exact, dipCN at rtol
    1e-12; its two modes bitwise equal; its resident launch the plan's, and
    the mode the rule's (resident where 4 blocks fit an SM), with no
    spill."""
    from torch_plans import dipcn_select_smem_bytes

    args, k, n_nbr = _f64_multi_args(case, cuda, _MULTI_CASES[case])
    w = args[0].shape[1]
    before = dipcn_from_distances_multi_gpu.launches
    got, gok = dipcn_from_distances_multi_gpu(*args, k=k, n_nbr=n_nbr)
    assert dipcn_from_distances_multi_gpu.launches == before + 1 and got.dtype == torch.float64
    want, wok = dipcn_from_distances_multi(*args, k=k, n_nbr=n_nbr)
    assert torch.equal(gok, wok)
    torch.testing.assert_close(got[gok], want[gok], rtol=F64_RTOL, atol=0)
    if case == "no-usable-row":
        assert not gok[0].any()
    mode = dipcn_select_mode(w, k, cuda, torch.float64)
    other, other_ok = _launch_multi("wide" if mode == "resident" else "resident", *args, k, n_nbr)
    assert torch.equal(other_ok, gok) and torch.equal(other, got)
    info = dipcn_select_info(w, k, cuda, multi=True, dtype=torch.float64)
    assert info["spill_bytes"] == 0 and info["mode"] == mode
    resident = dipcn_select_info(w, k, cuda, multi=True, dtype=torch.float64, mode="resident")
    assert resident["smem_bytes"] == dipcn_select_smem_bytes(w, k, 8)
    assert mode == ("resident" if resident["blocks_per_sm"] >= 4 else "wide")


@pytest.mark.parametrize("case", ["ties-300", "all-equal", "narrow-band", "wide"])
def test_float64_dipcn_multi_kernel_per_locus_equals_the_binary_kernel(cuda, case):
    """L=1, and each column of L=6, against the float64 binary kernel on
    the same weights: the same sets (``ok`` equal), values within rtol
    1e-12 (both sum in float64, in other orders)."""
    (d2, rnorm, nbr_w, usable, valid), k, n_nbr = _f64_multi_args(case, cuda, 6)
    for loci in (slice(0, 1), slice(0, 6)):
        got, gok = dipcn_from_distances_multi_gpu(
            d2, rnorm[:, loci].contiguous(), nbr_w[:, loci].contiguous(), usable,
            valid[:, loci].contiguous(), k=k, n_nbr=n_nbr)
        for j in range(got.shape[1]):
            want, wok = dipcn_from_distances_gpu(
                d2, rnorm[:, j].contiguous(), nbr_w[:, j].contiguous(), usable,
                valid[:, j].contiguous(), k=k, n_nbr=n_nbr)
            assert want.dtype == torch.float64 and torch.equal(gok[:, j], wok)
            torch.testing.assert_close(got[wok, j], want[wok], rtol=F64_RTOL, atol=0)


@pytest.mark.parametrize("w", [30000, 65600])
def test_float64_dipcn_multi_kernel_wide_rows_past_the_resident_edge(cuda, w):
    """Rows past the float64 resident mode's shared memory (~28,000 columns
    at k=500) take the wide mode; 65,600 columns also need its int32 lists.
    40 loci. Float32's resident mode still holds 30,000 columns, at fewer
    than 4 blocks an SM, so float32 takes the wide mode there too."""
    n, k, n_nbr = 24, 500, 300
    rng = np.random.default_rng(w)
    d2 = torch.tensor(rng.integers(0, 400, (n, w)) * 0.25, dtype=torch.float64, device=cuda)
    d2[:, rng.random(w) < 0.05] = torch.finfo(torch.float64).max
    d2[:, w - 60:] = 0.0  # the nearest columns and a tie group at the row's end
    d2[:, w - 64:w - 60] = 0.25
    usable = torch.tensor(rng.random(w) > 0.2, device=cuda)
    rnorm, nbr_w, valid = _multi_weights(rng, cuda, n, w, 40)
    rnorm, nbr_w = rnorm.double(), nbr_w.double()
    assert dipcn_select_mode(w, k, cuda, torch.float64) == "wide"
    assert dipcn_select_info(w, k, cuda, multi=True, dtype=torch.float64,
                             mode="resident")["blocks_per_sm"] == 0
    if w < 65536:  # float32 still fits such a row in shared memory
        assert 0 < dipcn_select_info(w, k, cuda, mode="resident")["blocks_per_sm"] < 4
        assert dipcn_select_mode(w, k, cuda) == "wide"
    got, gok = dipcn_from_distances_multi_gpu(d2, rnorm, nbr_w, usable, valid, k=k, n_nbr=n_nbr)
    want, wok = dipcn_from_distances_multi(d2, rnorm, nbr_w, usable, valid, k=k, n_nbr=n_nbr)
    assert torch.equal(gok, wok)
    torch.testing.assert_close(got[gok], want[gok], rtol=F64_RTOL, atol=0)
    assert dipcn_select_info(w, k, cuda, multi=True, dtype=torch.float64)["spill_bytes"] == 0


def test_float64_dipcn_multi_kernel_refuses_mixed_dtypes(cuda):
    """d2, rnorm and nbr_w of one dtype: float64 distances with float32
    weights (or the other way round) reach no kernel."""
    d2 = torch.zeros((8, 8), dtype=torch.float64, device=cuda)
    w2 = torch.ones((8, 3), dtype=torch.float64, device=cuda)
    usable = torch.ones(8, dtype=torch.bool, device=cuda)
    before = dipcn_from_distances_multi_gpu.launches
    for args in ((d2, w2.float(), w2), (d2, w2, w2.float()), (d2.float(), w2, w2)):
        with pytest.raises(TypeError):
            dipcn_from_distances_multi_gpu(*args, usable, w2 > 0, k=4, n_nbr=3)
    assert dipcn_from_distances_multi_gpu.launches == before


def test_float64_dipcn_multi_panels_on_card_match_the_plain_panels(cuda):
    """The sweep's panel route in float64 (the FP64 split and panel Grams,
    the distances and the multi kernel in float64, no float32 copy) on a
    ragged last panel, against the plain float64 panel form on the card."""
    rng = np.random.default_rng(6)
    n, r, n_loci = 1100, 40, 12
    zp = torch.tensor(np.round(rng.normal(size=(n, r)) * 4) / 4, dtype=torch.float64, device=cuda)
    usable = torch.tensor(rng.random(n) > 0.2, device=cuda)
    rnorm, nbr_w, _ = _multi_weights(rng, cuda, n, n, n_loci)
    rnorm, nbr_w = rnorm.double(), nbr_w.double()
    valid = usable[:, None].expand(n, n_loci).contiguous()
    row_valid = torch.ones(n, dtype=torch.bool, device=cuda)
    before = (zprep_split.launches, zprep_gram_panel.launches,
              dipcn_from_distances_multi_gpu.launches)
    got, gok = dipcn_multi_panels_gpu(zp, rnorm, nbr_w, usable, valid, k=60, n_nbr=30,
                                      row_block=512, row_valid=row_valid)
    assert (zprep_split.launches, zprep_gram_panel.launches,
            dipcn_from_distances_multi_gpu.launches) == (before[0] + 1, before[1] + 3,
                                                         before[2] + 3)
    assert got.dtype == torch.float64
    want, wok = dipcn_from_distances_panels(zp, rnorm, nbr_w, usable, valid, k=60, n_nbr=30,
                                            row_block=512, row_valid=row_valid)
    assert torch.equal(gok, wok)
    torch.testing.assert_close(got[gok], want[gok], rtol=F64_RTOL, atol=0)


@pytest.mark.parametrize("n,r", [(300, 70), (700, 130)])
def test_float64_gram_products_are_symmetric_bitwise(cuda, n, r):
    """What lets the float64 cross mode skip the mirror launch: a panel
    that starts off a tile (no tile of it is diagonal, so every entry is
    computed, none mirrored) equals the tile-aligned panel (whose diagonal
    tiles take their lower halves from their upper halves) bitwise, and
    its own computed entries G[i, j] and G[j, i] are equal bitwise."""
    rng = np.random.default_rng(n)
    zp = torch.tensor(rng.normal(size=(n, r)).clip(-2, 2), dtype=torch.float64, device=cuda)
    split = zprep_split(zp, None, None, float("inf"))
    aligned = zprep_gram_panel(split, 0, n)
    off = zprep_gram_panel(split, 64, n - 64)  # row tiles at 64, 192, ...: never diagonal
    assert torch.equal(off, aligned[64:])
    block = off[:, 64:]  # rows and columns 64 .. n-1, all computed
    assert torch.equal(block, block.T)


@pytest.mark.parametrize("n,world,r", [(300, 3, 70), (1000, 4, 130), (1100, 2, 257),
                                         (4096, 4, 64), (97, 2, 33)])
def test_float64_zprep_gram_cross_equals_the_panel_entries(cuda, n, world, r):
    """The ring's float64 block products ([1, B, R_pad] splits, one launch
    each), for every pair of blocks of B = ceil(n/W) rows, are bitwise the
    entries of one float64 zprep_gram_panel over all n rows, and within
    1e-12 of the plain P_a P_b^T."""
    rng = np.random.default_rng(n + world)
    z = torch.tensor(rng.normal(size=(n, r)) * 3, dtype=torch.float64, device=cuda)
    mask = torch.tensor(rng.random((n, r)) > 0.1, device=cuda)
    region = torch.tensor(rng.random(r) > 0.2, device=cuda)
    zp = torch.where(mask, z.clamp(-2.0, 2.0), 0) * region[None, :].double()
    panel = zprep_gram_panel(zprep_split(zp, None, None, float("inf")), 0, n)
    b = -(-n // world)
    zpad = torch.cat([zp, zp.new_zeros((b * world - n, r))])
    blocks = [zprep_split(zpad[i * b:(i + 1) * b].contiguous(), None, None, float("inf"))
              for i in range(world)]
    assert blocks[0].p.shape[0] == 1 and blocks[0].p.dtype == torch.float64
    plain = [zprep_split_plain(zpad[i * b:(i + 1) * b], None, None, float("inf"))
             for i in range(world)]
    before = zprep_gram_cross.launches
    for a in range(world):
        for o in range(world):
            g = zprep_gram_cross(blocks[a], blocks[o], a * b, o * b)
            assert g.shape == (b, b) and g.dtype == torch.float64
            ra, ro = min(b, n - a * b), min(b, n - o * b)
            if ra > 0 and ro > 0:
                assert torch.equal(g[:ra, :ro], panel[a * b:a * b + ra, o * b:o * b + ro]), (a, o)
            assert_close_to_max(g.cpu(), zprep_gram_cross_plain(plain[a], plain[o]).cpu(),
                                F64_RTOL)
    assert zprep_gram_cross.launches == before + world * world
    with pytest.raises(ValueError):
        zprep_gram_cross(blocks[0], blocks[1], -1, 0)
    with pytest.raises(TypeError):  # a float32 split beside a float64 one
        zprep_gram_cross(blocks[0], zprep_split(zpad[:b].float(), None, None, float("inf")))


@pytest.mark.parametrize("na,nb", [(1, 1), (127, 129), (4096, 4096), (8192, 8192), (129, 4096)])
def test_float64_zprep_gram_cross_info_is_the_plan(cuda, na, nb):
    """The cross mode's own launch shape (``zprep_gram64_info`` mode 3) is
    ``tests/torch_plans.py``'s plan, in registers with no spill."""
    from torch_plans import zprep_gram64_plan

    info = zprep_gram_info(nb, cuda, torch.float64, "cross", na)
    plan = zprep_gram64_plan(nb, na, "cross")
    keys = ("tile", "k_tile", "stages", "threads", "smem_bytes", "blocks", "blocks_per_sm")
    assert {key: info[key] for key in keys} == {key: plan[key] for key in keys}
    assert info["spill_bytes"] == 0 and info["registers"] <= 255


def test_float64_ring_step_at_w2_equals_the_flat_step(cuda):
    """``sharded_cohort_step`` over 2 ranks of the card in float64 (the
    cross mode, float64 ring shifts, the float64 knn_select merges) against
    the flat float64 step on the card: z within 1e-12 of max|z|, neighbor
    lists identical but for ties within 1e-12 of the k-th distance, dipCN
    at 1e-9 where the input sets agree; each rank launched the float64
    cross mode twice."""
    from grid_tpu_torch.parallel import sharded_cohort_step

    rng = np.random.default_rng(9)
    n, r = 600, 96
    values = rng.uniform(20, 40, (n, r)) * rng.normal(1, 0.1, (n, r)).clip(0.5, None)
    mask = rng.random((n, r)) > 0.02
    reads = rng.integers(500, 3000, n).astype(np.float64)
    reads_valid = rng.random(n) > 0.05
    ring = [[((h + 2) % (2 * n), 1.0), ((h - 2) % (2 * n), 0.5)] for h in range(2 * n)]
    hap = pad_hap_neighbors(ring, 2, dtype=np.float64)
    params = CohortParams(num_neighbors=50, n_nbr=30, n_iters=10, quantize=False)
    reports = []
    got = outputs_to_numpy(sharded_cohort_step(2, values, mask, reads, reads_valid, *hap, params,
                                               dtype=torch.float64, reports=reports))
    assert [rep["zprep_gram_cross"] for rep in reports] == [2, 2]
    want = outputs_to_numpy(cohort_step(*inputs_to_torch(values, mask, reads, reads_valid, *hap,
                                                         cuda, torch.float64), params))
    assert got.z.dtype == np.float64 and got.nbr_sq_dists.dtype == np.float64
    assert_close_to_max(got.z[:n], want.z, F64_RTOL)
    neighbor_rows_differing(got.nbr_idx[:n], got.nbr_sq_dists[:n], want.nbr_idx,
                            want.nbr_sq_dists, tol=F64_RTOL * want.nbr_sq_dists[:, -1])
    np.testing.assert_array_equal(got.dipcn_valid[:n], want.dipcn_valid)
    same = want.dipcn_valid & ~dipcn_sets_differ(got.nbr_idx[:n], want.nbr_idx,
                                                 reads_valid & want.z_mask.any(axis=1), 30)
    np.testing.assert_allclose(got.dipcn[:n][same], want.dipcn[same], rtol=1e-9)


# --------------------------- bfloat16: the bf16 forms of steps 4-6's kernels ---

BF16 = torch.bfloat16


def _bf16_ulps(got, want) -> int:
    from torch_parity import bf16_ulps

    return bf16_ulps(got.float().cpu().numpy(), want.float().cpu().numpy())


@pytest.mark.parametrize("n,r", [(1, 1), (97, 70), (300, 257), (2504, 2048), (1000, 130)])
@pytest.mark.parametrize("round_squares", [True, False])
def test_bfloat16_masked_column_stats_kernel(cuda, n, r, round_squares):
    """The Triton kernel's bf16 form against its plain version: counts
    exact, sums and squared deviations within one bf16 ulp (float32 sums in
    another order, rounded once), two calls bitwise equal."""
    from torch_parity import BF16_ULPS

    rng = np.random.default_rng(n + r)
    values = torch.tensor(rng.uniform(10, 60, (n, r)), dtype=BF16, device=cuda)
    mask = torch.tensor(rng.random((n, r)) > 0.15, device=cuda)
    rm = torch.tensor(rng.uniform(20, 40, n), dtype=BF16, device=cuda)
    mu = torch.tensor(rng.uniform(0.5, 2.0, r), dtype=BF16, device=cuda)
    for col_means in (None, mu):
        before = masked_column_stats.launches
        got = masked_column_stats(values, mask, rm, col_means, round_squares)
        assert masked_column_stats.launches == before + 1 and got[1].dtype == BF16
        want = masked_column_stats_plain(values, mask, rm, col_means, round_squares)
        assert torch.equal(got[0], want[0])
        assert _bf16_ulps(got[1], want[1]) <= BF16_ULPS
        assert _bf16_ulps(got[2], want[2]) <= BF16_ULPS
        again = masked_column_stats(values, mask, rm, col_means, round_squares)
        assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("n,r", [(1, 3), (97, 70), (129, 64), (256, 130), (300, 257),
                                 (515, 130), (2504, 2048), (1000, 1000), (4097, 200)])
def test_bfloat16_zprep_gram_kernel(cuda, n, r):
    """The bf16 wgmma Gram against its plain version under the Gram rule of
    the bf16 contract (one bf16 ulp of the entry, or 2^-16 of max|G| where
    an entry cancels towards 0), exactly symmetric; the norms of the split
    pass (grid_tpu's sum(P * P)) within one ulp of the plain norms; the
    split's P is the plain P bitwise, its norms the triangle's, and its row
    panels the triangle's rows bitwise (one sum order in every mode: the
    same products, A and B swapped), at tile-aligned rows and at rows off
    the tiles, fewer rows than a tile too, and the last row alone. N off
    the 128- and 256-row tiles (129, 1000, 4097; 129, 4097 and 515 also
    off the TMA store's 16-byte rows), on them (256: the last row tile's
    one tile holds a diagonal block and the mirror of another), R off the
    64-column stages (1000, 200, 130)."""
    from torch_parity import BF16_ULPS, bf16_gram_ratio

    def gram_ratio(got, want):
        return bf16_gram_ratio(got.float().cpu().numpy(), want.float().cpu().numpy())

    rng = np.random.default_rng(n)
    z = torch.tensor(rng.normal(size=(n, r)) * 3, dtype=BF16, device=cuda)
    mask = torch.tensor(rng.random((n, r)) > 0.1, device=cuda)
    region = torch.tensor(rng.random(r) > 0.2, device=cuda)
    before = zprep_gram.launches
    g, sq = zprep_gram(z, mask, region, 2.0, norms=True)
    assert zprep_gram.launches == before + 1 and g.dtype == sq.dtype == BF16
    pg, psq = zprep_gram_plain(z, mask, region, 2.0, norms=True)
    assert gram_ratio(g, pg) <= 1 and _bf16_ulps(sq, psq) <= BF16_ULPS
    assert torch.equal(g, g.T)
    split = zprep_split(z, mask, region, 2.0)
    plain = zprep_split_plain(z, mask, region, 2.0)
    assert split.p.shape[0] == 1 and torch.equal(split.p[0, :, :r], plain.p)
    assert torch.equal(split.norms, sq)
    panels = [(i0, min(256, n - i0)) for i0 in range(0, n, 256)]
    panels += [(n // 3, min(100, n - n // 3)), (max(0, n - 77), min(77, n)),  # off the tiles
               (n - 1, 1)]
    for i0, rows in panels:
        panel = zprep_gram_panel(split, i0, rows)
        assert panel.dtype == BF16 and torch.equal(panel, g[i0:i0 + rows])


@pytest.mark.parametrize("r", [1024, 2048])
@pytest.mark.parametrize("cell", ["triangle", "panel"])
def test_bfloat16_zprep_gram_holds_the_float32_sum_on_the_cpu(cuda, cell, r):
    """The kernel sums an entry over all of R in the wgmma accumulator. Held
    here to the plain version run on the CPU in float32 (each bf16 product
    exact, a float32 sum in the CPU's order, G rounded to bf16 once) under
    the Gram rule, not to cuBLAS, which sums in the same tensor cores: at
    N=2504 (the triangle) and on a [512, 65,536] panel, at the panels' R
    (1024) and the slice's (2048)."""
    from torch_parity import bf16_gram_ratio

    gen = torch.Generator(device=cuda).manual_seed(r + len(cell))
    if cell == "triangle":
        n, rows = 2504, 2504
        z = (torch.randn((n, r), device=cuda, generator=gen) * 3).to(BF16)
        mask = torch.rand((n, r), device=cuda, generator=gen) > 0.1
        region = torch.rand(r, device=cuda, generator=gen) > 0.2
        got = zprep_gram(z, mask, region, 2.0)
        p = zprep_split_plain(z.cpu(), mask.cpu(), region.cpu(), 2.0).p
    else:
        n, rows = 65536, 512
        z = torch.randn((n, r), device=cuda, generator=gen).to(BF16)
        got = zprep_gram_panel(zprep_split(z, None, None, float("inf")), 0, rows)
        p = z.cpu()
    want = (p[:rows].float() @ p.float().T).to(BF16)
    assert got.shape == want.shape
    assert bf16_gram_ratio(got.float().cpu().numpy(), want.float().numpy()) <= 1


def test_bfloat16_zprep_gram_panel_walk_wraps(cuda):
    """A [512, 65,536] panel is 1,024 tiles for one block an SM: the
    persistent walk wraps ~8 times around the card. At R=64 (one stage a
    tile) against the plain panel under the Gram rule, and its rows of the
    panel at 65,024 bitwise those of the panel at 65,280 (the same entries
    from other tiles)."""
    from torch_parity import bf16_gram_ratio

    n, r = 65536, 64
    gen = torch.Generator(device=cuda).manual_seed(8)
    z = (torch.randn((n, r), device=cuda, generator=gen) * 3).to(BF16)
    split = zprep_split(z, None, None, float("inf"))
    plain = zprep_split_plain(z, None, None, float("inf"))
    info = zprep_gram_info(n, cuda, BF16, "panel", 512)
    assert info["tiles"] == 1024 and info["grid"] < info["tiles"] // 7
    for i0 in (0, n - 512):
        got = zprep_gram_panel(split, i0, 512)
        want = zprep_gram_panel_plain(plain, i0, 512)
        assert bf16_gram_ratio(got.float().cpu().numpy(), want.float().cpu().numpy()) <= 1
    tail = zprep_gram_panel(split, n - 256, 256)
    assert torch.equal(tail, got[256:])


@pytest.mark.parametrize("n,mode", [(n, "triangle") for n in (1, 129, 1000, 2504)]
                         + [(n, "panel") for n in (1, 129, 1000, 2504, 65536)])
def test_bfloat16_zprep_gram_info(cuda, n, mode):
    """The bf16 kernel's launch is the plan (tests/torch_plans.py): 128x256
    tiles (the triangle's from column 128 i of row tile i, a panel's row
    tiles times 256-column tiles), 64-column stages (one 128-byte swizzle
    row of bf16) in a ring of 4, two staged boxes of G, 384 threads, one
    block an SM walking the tiles (the grid one block an SM, or one a tile
    where there are fewer); no spill."""
    from torch_plans import zprep_gram16_plan

    rows = min(n, 512) if mode == "panel" else n
    info = zprep_gram_info(n, cuda, BF16, mode, rows)
    plan = zprep_gram16_plan(n, rows, mode, torch.cuda.get_device_properties(cuda)
                             .multi_processor_count)
    assert {key: info[key] for key in plan if key in info} == {
        key: plan[key] for key in plan if key in info}
    assert info["spill_bytes"] == 0 and info["registers"] > 0


# case: (rows, width, k, mode, cluster blocks)
_BF16_SELECT_CASES = {
    "k1": (8, 300, 1, "resident", 1),
    "k-equals-w": (8, 97, 97, "resident", 1),
    "all-equal": (64, 16, 16, "resident", 1),
    "past-body": (32, 3000, 2000, "resident", 1),
    "quantized-2504": (256, 2504, 500, "resident", 1),
    "w8193-two-blocks-unaligned": (16, 8193, 500, "cluster", 2),
    "w65536-cluster": (32, 65536, 500, "cluster", 8),
    "w131072-the-widest": (4, 131072, 500, "cluster", 8),
    "largest-list": (4, 20000, 16384, "cluster", 4),
}


def _bf16_select_case(case, cuda):
    b, w, k = _BF16_SELECT_CASES[case][:3]
    rng = np.random.default_rng(len(case) + 200)
    big = torch.finfo(BF16).max
    if case == "all-equal":
        d2 = torch.zeros((b, w), dtype=BF16, device=cuda)
    else:  # quantized: exact ties across the row
        d2 = torch.tensor(rng.integers(0, 400, (b, w)) * 0.25, dtype=BF16, device=cuda)
        d2[:, rng.random(w) < (0.6 if case == "past-body" else 0.05)] = big
    return d2.contiguous(), k


@pytest.mark.parametrize("case", list(_BF16_SELECT_CASES))
def test_bfloat16_knn_select_kernel_equals_the_plain_sort(cuda, case):
    """The bf16 form, in the mode and cluster size the width picks, equals
    its plain version (the stable sort of the int16 keys) bitwise, values
    and positions; so does its wide mode; its plan is the pure function's."""
    from grid_tpu_torch.ops.gpu_select import (
        _knn_launch, knn_select_info, knn_select_mode, sorted_smallest_k_gpu,
    )
    from grid_tpu_torch.ops.knn import sorted_smallest_k
    from torch_plans import knn_select_plan

    d2, k = _bf16_select_case(case, cuda)
    w = d2.shape[1]
    mode, blocks = _BF16_SELECT_CASES[case][3:]
    assert knn_select_mode(w, k, cuda, BF16) == mode
    info, plan = knn_select_info(w, k, cuda, dtype=BF16), knn_select_plan(w, k, 2)
    assert info["cluster_blocks"] == blocks and info["spill_bytes"] == 0
    if mode == "wide":
        assert info["smem_bytes"] == plan["wide_smem_bytes"]
    else:
        assert (info["smem_bytes"], info["slice"]) == (plan["shared_smem_bytes"], plan["slice"])
    before = sorted_smallest_k_gpu.launches
    vals, idx = sorted_smallest_k_gpu(d2, k)
    assert sorted_smallest_k_gpu.launches == before + 1 and vals.dtype == BF16
    want_v, want_i = sorted_smallest_k(d2, k)
    assert torch.equal(idx, want_i) and torch.equal(vals.view(torch.int16),
                                                   want_v.view(torch.int16))
    if mode != "wide":
        got_v, got_i = _knn_launch("wide", d2, k)
        assert torch.equal(got_i, idx) and torch.equal(got_v.view(torch.int16),
                                                       vals.view(torch.int16))


def test_bfloat16_knn_select_refuses_rows_past_131072(cuda):
    from grid_tpu_torch.ops.gpu_select import knn_select_mode, sorted_smallest_k_gpu

    assert knn_select_mode((1 << 17) + 1, 500, cuda, BF16) is None
    with pytest.raises(ValueError):
        sorted_smallest_k_gpu(torch.zeros((1, (1 << 17) + 1), dtype=BF16, device=cuda), 5)


# case: (rows, width, k, n_nbr, quantized)
_BF16_DIPCN_CASES = {
    "one-row": (1, 3, 2, 1, True), "n9-k-equals-w": (9, 9, 9, 4, True),
    "ties-300": (300, 300, 60, 20, True), "quantized-2504": (256, 2504, 500, 300, True),
    "spread-2504": (256, 2504, 500, 300, False), "all-equal": (64, 16, 16, 7, None),
    "panel-65536": (8, 65536, 500, 300, True), "w70000-wide": (4, 70000, 500, 300, True),
}


@pytest.mark.parametrize("case", list(_BF16_DIPCN_CASES))
def test_bfloat16_dipcn_kernel(cuda, case):
    """The bf16 binary form against the plain bf16 dipCN bitwise (the same
    take-sets, float32 sums of bf16 weights rounded as the plain version
    rounds them); both modes where both take the row; its resident plan is
    the pure function's."""
    from torch_plans import dipcn_select_smem_bytes

    n, w, k, n_nbr, ties = _BF16_DIPCN_CASES[case]
    rng = np.random.default_rng(w + k + 1)
    big = torch.finfo(BF16).max
    d2 = rng.integers(0, 40, (n, w)) * 0.25 if ties else rng.uniform(1000.0, 5000.0, (n, w))
    d2 = torch.tensor(d2, dtype=BF16, device=cuda)
    if ties is None:
        d2.zero_()
    d2[:, rng.random(w) < 0.05] = big
    if n == w:
        d2.fill_diagonal_(big)
    args = (d2.contiguous(), torch.tensor(rng.uniform(0.5, 2.0, n), dtype=BF16, device=cuda),
            torch.tensor(rng.uniform(0.5, 2.0, w), dtype=BF16, device=cuda),
            torch.tensor(rng.random(w) > 0.2, device=cuda),
            torch.tensor(rng.random(n) > 0.1, device=cuda))
    before = dipcn_from_distances_gpu.launches
    dip, ok = dipcn_from_distances_gpu(*args, k=k, n_nbr=n_nbr)
    assert dipcn_from_distances_gpu.launches == before + 1 and dip.dtype == BF16
    pdip, pok = dipcn_from_distances(*args, k=k, n_nbr=n_nbr)
    assert torch.equal(ok, pok)
    assert torch.equal(dip[ok].view(torch.int16), pdip[ok].view(torch.int16))
    mode = dipcn_select_mode(w, k, cuda, BF16)
    assert mode == ("wide" if w >= 65536 else "resident")  # the panel: 1 resident block an SM
    info = dipcn_select_info(w, k, cuda, dtype=BF16, mode="resident")
    if info["blocks_per_sm"]:  # both modes where the resident mode fits
        assert info["smem_bytes"] == dipcn_select_smem_bytes(w, k, 2) and info["spill_bytes"] == 0
        other = "wide" if mode == "resident" else "resident"
        odip, ook = _launch(other, *args, k, n_nbr)
        assert torch.equal(ook, ok) and torch.equal(odip[ok].view(torch.int16),
                                                    dip[ok].view(torch.int16))
    with pytest.raises(TypeError):  # no multi-weight form in bf16
        dipcn_select_info(w, k, cuda, multi=True, dtype=BF16)


@pytest.mark.parametrize("branch", ["resident", "panels"])
def test_bfloat16_cohort_step_on_card_matches_the_cpu_route(cuda, branch):
    """The bf16 step on the card against the port's bf16 CPU route at the
    bf16 contract: values within 2^-7 of max|want|, neighbor lists equal but
    for ties within 2^-7 of the row's k-th distance, dipCN within rtol 2^-7
    where the input sets agree, dipcn_valid exact; every kernel launched, in
    its bf16 form, and the sweeps in float32."""
    from grid_tpu_torch.ops.gpu_select import sorted_smallest_k_gpu
    from grid_tpu_torch.ops.phasing import phase_sweeps_gpu
    from torch_parity import BF16_RTOL

    rng = np.random.default_rng(5)
    n, r = 400, 192
    values = rng.uniform(20, 40, (n, r)) * rng.normal(1, 0.1, (n, r)).clip(0.5, None)
    mask = rng.random((n, r)) > 0.02
    reads = rng.integers(500, 3000, n).astype(np.float64)
    reads_valid = rng.random(n) > 0.05
    ring = [[((h + 2) % (2 * n), 1.0), ((h - 2) % (2 * n), 0.5)] for h in range(2 * n)]
    hap = pad_hap_neighbors(ring, 2, dtype=np.float64)
    params = CohortParams(num_neighbors=50, n_nbr=30, n_iters=10, quantize=True, row_block=128)
    if branch == "panels":
        params = params._replace(d2_budget_bytes=0)
    args = (values, mask, reads, reads_valid, *hap)
    wrappers = (masked_column_stats, zprep_gram, zprep_split, zprep_gram_panel,
                dipcn_from_distances_gpu, sorted_smallest_k_gpu, phase_sweeps_gpu)
    before = [f.launches for f in wrappers]
    out = cohort_step(*inputs_to_torch(*args, cuda, BF16, torch.float32), params)
    assert out.z.dtype == out.dipcn.dtype == BF16 and out.hap_irrs.dtype == torch.float32
    got = outputs_to_numpy(out)
    launched = dict(zip((f.__name__ for f in wrappers),
                        (f.launches - b for f, b in zip(wrappers, before))))
    want = outputs_to_numpy(cohort_step(*inputs_to_torch(*args, "cpu", BF16, torch.float64),
                                        params))
    assert launched["masked_column_stats"] == 2 and launched["phase_sweeps_gpu"] == 1
    if branch == "resident":
        assert launched["zprep_gram"] == launched["sorted_smallest_k_gpu"] == 1
    else:
        assert launched["zprep_split"] == 1 and launched["zprep_gram_panel"] == 4
        assert launched["sorted_smallest_k_gpu"] == launched["dipcn_from_distances_gpu"] == 4
    assert_close_to_max(got.z, want.z, BF16_RTOL)
    neighbor_rows_differing(got.nbr_idx, got.nbr_sq_dists, want.nbr_idx, want.nbr_sq_dists,
                            tol=BF16_RTOL * want.nbr_sq_dists[:, -1])
    np.testing.assert_array_equal(got.dipcn_valid, want.dipcn_valid)
    same = got.dipcn_valid & ~dipcn_sets_differ(got.nbr_idx, want.nbr_idx,
                                                reads_valid & want.z_mask.any(axis=1), 30)
    np.testing.assert_allclose(got.dipcn[same], want.dipcn[same], rtol=BF16_RTOL)


# ------------- bfloat16 with device.mesh_shape: the sharded step's bf16 forms ---


def _bf16_prepared(rng, cuda, n, r):
    """A prepared bf16 z [n, r] on the card (clipped, masked, region-filtered)."""
    z = torch.tensor(rng.normal(size=(n, r)) * 3, dtype=BF16, device=cuda)
    mask = torch.tensor(rng.random((n, r)) > 0.1, device=cuda)
    region = torch.tensor(rng.random(r) > 0.2, device=cuda)
    return torch.where(mask, z.clamp(-2.0, 2.0), 0) * region[None, :].to(BF16)


@pytest.mark.parametrize("n,world,r", [(300, 2, 130), (1000, 3, 200), (4096, 2, 64),
                                       (515, 4, 1000)])
def test_bfloat16_zprep_gram_cross_equals_the_panel_entries(cuda, n, world, r):
    """The ring's bf16 block products ([1, B, R_pad] splits, one launch
    each), for every pair of blocks of B = ceil(n/W) rows, are bitwise the
    entries of one bf16 zprep_gram_panel over all n rows (blocks at offsets
    off the 128- and 256-row tiles where B is), and within the bf16 Gram
    rule of the plain P_a P_b^T."""
    from torch_parity import bf16_gram_ratio

    zp = _bf16_prepared(np.random.default_rng(n + world), cuda, n, r)
    panel = zprep_gram_panel(zprep_split(zp, None, None, float("inf")), 0, n)
    b = -(-n // world)
    zpad = torch.cat([zp, zp.new_zeros((b * world - n, r))])
    blocks = [zprep_split(zpad[i * b:(i + 1) * b].contiguous(), None, None, float("inf"))
              for i in range(world)]
    assert blocks[0].p.shape[0] == 1 and blocks[0].p.dtype == BF16
    plain = [zprep_split_plain(zpad[i * b:(i + 1) * b].cpu(), None, None, float("inf"))
             for i in range(world)]
    before = zprep_gram_cross.launches
    for a in range(world):
        for o in range(world):
            g = zprep_gram_cross(blocks[a], blocks[o], a * b, o * b)
            assert g.shape == (b, b) and g.dtype == BF16
            ra, ro = min(b, n - a * b), min(b, n - o * b)
            if ra > 0 and ro > 0:
                assert torch.equal(g[:ra, :ro], panel[a * b:a * b + ra, o * b:o * b + ro]), (a, o)
            want = zprep_gram_cross_plain(plain[a], plain[o])
            assert bf16_gram_ratio(g.float().cpu().numpy(), want.float().numpy()) <= 1
    assert zprep_gram_cross.launches == before + world * world


@pytest.mark.parametrize("a0,na,b0,nb", [(0, 256, 256, 256), (128, 384, 0, 512),
                                         (77, 300, 1001, 129), (1, 1, 2047, 1),
                                         (5, 1500, 700, 1111), (0, 2048, 0, 2048)])
def test_bfloat16_zprep_gram_cross_at_offsets_and_unequal_blocks(cuda, a0, na, b0, nb):
    """Any two blocks of rows of one prepared z, at offsets on a tile and
    off it, of unequal rows (Ba != Bb, B off the tiles and off the 16-byte
    rows of the TMA store): the cross block is bitwise those rows of the
    whole cohort's panel (every entry summed in one order wherever it sits
    in a tile)."""
    n, r = 2048, 192
    zp = _bf16_prepared(np.random.default_rng(a0 + nb), cuda, n, r)
    panel = zprep_gram_panel(zprep_split(zp, None, None, float("inf")), 0, n)
    pa = zprep_split(zp[a0:a0 + na].contiguous(), None, None, float("inf"))
    pb = zprep_split(zp[b0:b0 + nb].contiguous(), None, None, float("inf"))
    g = zprep_gram_cross(pa, pb, a0, b0)
    assert g.shape == (na, nb)
    assert torch.equal(g, panel[a0:a0 + na, b0:b0 + nb])
    assert torch.equal(pa.norms, zprep_split(zp, None, None, float("inf")).norms[a0:a0 + na])


@pytest.mark.parametrize("na,nb", [(1, 1), (127, 129), (1252, 1252), (4096, 4096),
                                   (8192, 8192), (129, 4096)])
def test_bfloat16_zprep_gram_cross_info_is_the_plan(cuda, na, nb):
    """The cross mode's launch (``zprep_gram16_info`` mode 3) is
    ``tests/torch_plans.py``'s plan: the panel mode's tiles over a's row
    tiles and b's 256-column tiles, one block an SM; no spill."""
    from torch_plans import zprep_gram16_plan

    info = zprep_gram_info(nb, cuda, BF16, "cross", na)
    plan = zprep_gram16_plan(nb, na, "cross", torch.cuda.get_device_properties(cuda)
                             .multi_processor_count)
    assert {key: info[key] for key in plan if key in info} == {
        key: plan[key] for key in plan if key in info}
    assert info["spill_bytes"] == 0 and info["registers"] > 0


def test_bfloat16_zprep_gram_cross_refuses_what_it_does_not_take(cuda):
    zp = _bf16_prepared(np.random.default_rng(1), cuda, 64, 32)
    split = zprep_split(zp, None, None, float("inf"))
    with pytest.raises(ValueError):
        zprep_gram_cross(split, split, -1, 0)
    with pytest.raises(TypeError):  # a float32 split beside a bf16 one
        zprep_gram_cross(split, zprep_split(zp.float(), None, None, float("inf")))


@pytest.mark.parametrize("n,r", [(2504, 1024), (300, 130)])
def test_bfloat16_masked_column_stats_wide_sums(cuda, n, r):
    """``wide``: the kernel's float32 sums as they are, counts exact past
    256 rows; rounded to bf16 they are the rounded kernel's outputs
    bitwise, and they hold the plain float32 sums within float32 rounding
    of another order."""
    rng = np.random.default_rng(n)
    v = torch.tensor(rng.uniform(10, 60, (n, r)), dtype=BF16, device=cuda)
    m = torch.tensor(rng.random((n, r)) > 0.1, device=cuda)
    rm = torch.tensor(rng.uniform(20, 40, n), dtype=BF16, device=cuda)
    mu = torch.tensor(rng.uniform(0.8, 1.2, r), dtype=BF16, device=cuda)
    for col_means in (None, mu):
        wide = masked_column_stats(v, m, rm, col_means, round_squares=False, wide=True)
        rounded = masked_column_stats(v, m, rm, col_means, round_squares=False)
        plain = masked_column_stats_plain(v.cpu(), m.cpu(), rm.cpu(),
                                          None if col_means is None else mu.cpu(),
                                          round_squares=False, wide=True)
        for w, rd, p in zip(wide, rounded, plain):
            assert w.dtype == torch.float32
            assert torch.equal(w.to(BF16), rd)
            np.testing.assert_allclose(w.cpu().numpy(), p.numpy(), rtol=1e-6)
        assert torch.equal(wide[0].cpu(), m.sum(0).float().cpu())


def test_bfloat16_ring_step_at_w2_equals_the_cpu_ring(cuda):
    """``sharded_cohort_step`` over 2 ranks of the card in bf16 (the bf16
    cross mode, bf16 ring shifts, the bf16 knn_select merges; the reads and
    the ring's dipCN in float32) against the same ring on gloo ranks on the
    CPU in bf16 at the bf16 contract; each rank launched the bf16 cross mode
    twice, and dipCN and step 7 stay float32."""
    from grid_tpu_torch.parallel import sharded_cohort_step
    from torch_parity import BF16_RTOL

    rng = np.random.default_rng(9)
    n, r = 600, 96
    values = rng.uniform(20, 40, (n, r)) * rng.normal(1, 0.1, (n, r)).clip(0.5, None)
    mask = rng.random((n, r)) > 0.02
    reads = rng.integers(500, 3000, n).astype(np.float64)
    reads_valid = rng.random(n) > 0.05
    ring = [[((h + 2) % (2 * n), 1.0), ((h - 2) % (2 * n), 0.5)] for h in range(2 * n)]
    hap = pad_hap_neighbors(ring, 2, dtype=np.float64)
    params = CohortParams(num_neighbors=50, n_nbr=30, n_iters=10, quantize=True)
    args = (values, mask, reads, reads_valid, *hap, params)
    reports = []
    out = sharded_cohort_step(2, *args, dtype=BF16, reports=reports)
    assert [rep["zprep_gram_cross"] for rep in reports] == [2, 2]
    assert out.z.dtype == out.nbr_sq_dists.dtype == BF16
    assert out.dipcn.dtype == out.hap_irrs.dtype == torch.float32
    got = outputs_to_numpy(out)
    want = outputs_to_numpy(sharded_cohort_step(2, *args, platform="cpu", dtype=BF16))
    assert_close_to_max(got.z, want.z, BF16_RTOL)
    neighbor_rows_differing(got.nbr_idx[:n], got.nbr_sq_dists[:n], want.nbr_idx[:n],
                            want.nbr_sq_dists[:n], tol=BF16_RTOL * want.nbr_sq_dists[:n, -1])
    np.testing.assert_array_equal(got.dipcn_valid, want.dipcn_valid)
    same = want.dipcn_valid[:n] & ~dipcn_sets_differ(got.nbr_idx[:n], want.nbr_idx[:n],
                                                     reads_valid & want.z_mask[:n].any(axis=1),
                                                     30)
    np.testing.assert_allclose(got.dipcn[:n][same], want.dipcn[:n][same], rtol=BF16_RTOL)
