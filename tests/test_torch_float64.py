"""``device.dtype: float64`` on the card: what the CPU can check of it.

The float64 forms of the cohort step's kernels run only on the card
(``tests/test_torch_gpu.py`` holds each to its plain version there). Here:

- the launch plans by element size, as the pure functions of
  ``tests/torch_plans.py`` compute them (the card tests hold the kernels'
  own plans to them): where ``knn_select``, ``dipcn_select`` and
  ``phase_sweeps`` leave their shared-memory modes in float64, the
  resident edge of the d2 matrix, and the FP64 Gram's tiles, waves and
  ring in its three modes;
- the key order the float64 selections rely on: non-negative doubles read
  as int64 order as the doubles, finfo.max and exact ties included, as a
  stable sort orders them;
- the port's float64 ``cohort_step`` against ``grid_tpu``'s under x64 on
  the panel branch, with the d2 budget one byte short of N * N * 8 in both
  packages (float64 contract: neighbor indices identical, dipCN at 1e-9);
- the dtype each entry point resolves before any step: float64 on the
  card for the multi-locus sweep and for ``device.mesh_shape`` (the ring,
  the gather form), whose kernels now have float64 forms; the up-front
  refusals of bfloat16 on the card and of float64 past the float64
  ``knn_select``'s largest k, each naming the cause;
- the FP64 Gram's cross mode: its plan at the ring's block sizes and
  offsets, and its plain version on float64 splits against the plain
  panel entries of the whole cohort's split;
- the multi-weight ``dipcn_select`` in float64: the resident mode's
  shared memory and edge are the binary form's.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import make_matrix
from grid_tpu.models.cohort import CohortParams as JCohortParams
from grid_tpu.models.cohort import cohort_step as j_cohort_step
from grid_tpu.ops.select import sorted_smallest_k as j_sorted_smallest_k
from grid_tpu_torch.convert import inputs_to_torch, outputs_to_numpy, params_from_reference
from grid_tpu_torch.io.hap_neighbors import pad_hap_neighbors
from grid_tpu_torch.models.cohort import CohortParams, cohort_step, d2_resident
from grid_tpu_torch.ops.gpu_kernels import (
    _GRAM64_K_TILE, _r_pad, zprep_gram_cross_plain, zprep_gram_panel_plain, zprep_split_plain,
)
from grid_tpu_torch.ops.knn import sorted_smallest_k
from grid_tpu_torch.ops.select import _key_type, _kth_smallest_key
from grid_tpu_torch.synth import make_synthetic_cohort
from grid_tpu_torch.utils.device import compute_dtype
from torch_parity import assert_close_to_max
from torch_plans import (
    H100_SMEM, dipcn_select_smem_bytes, knn_select_mode_of, knn_select_plan,
    phase_sweeps_smem_bytes, zprep_gram64_l2_bytes, zprep_gram64_plan,
)

# an H100's shared memory a block may opt in to, less a few KB of the
# kernels' static shared memory
SMEM = 232_448 - 4_096
CUDA = torch.device("cuda")


# ------------------------------------------------------------ plans by size ---


def _widest(fits, lo: int, hi: int) -> int:
    """The largest x in [lo, hi) with fits(x), fits being monotone."""
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid)
    return lo


@pytest.mark.parametrize("k", [1, 300, 500, 4000])
def test_knn_select_plan_by_element_size(k):
    """A float64 row holds twice the key bytes and 16-byte list entries: a
    resident N=2504 row takes 8 * 2504 + 20 L bytes. Its shared mode runs
    one block a row only, up to 8,192 columns; wider float64 rows, the
    65,536-column panels among them, take the wide mode, where float32
    rows take a cluster of up to 8 blocks."""
    length = max(128, 1 << (k - 1).bit_length())
    f32, f64 = knn_select_plan(65536, k, 4), knn_select_plan(65536, k, 8)
    assert f32["cluster_blocks"] == f64["cluster_blocks"] == 8
    assert f32["shared_smem_bytes"] == 8192 * 4 + 8 * length + 4 * length
    assert (f32["max_shared_cluster"], f64["max_shared_cluster"]) == (8, 1)
    assert knn_select_mode_of(65536, k, 4, SMEM) == "cluster"
    assert knn_select_mode_of(65536, k, 8, SMEM) == "wide"
    resident = knn_select_plan(2504, k, 8)
    assert resident["cluster_blocks"] == 1 and resident["slice"] == 2504
    assert resident["shared_smem_bytes"] == 2504 * 8 + 20 * length
    for w in (max(2504, k), 8192):
        assert knn_select_mode_of(w, k, 8, SMEM) == "resident"
    assert knn_select_mode_of(8193, k, 8, SMEM) == "wide"
    assert knn_select_mode_of(8193, k, 4, SMEM) == "cluster"


def test_knn_select_plan_largest_list():
    """The wide mode's list and gather buffer fit a block up to k = 16,384
    in float32 and k = 8,192 in float64 (16-byte pairs): the forms' max k."""
    for itemsize, max_k in ((4, 16384), (8, 8192)):
        plan = knn_select_plan(1 << 20, max_k, itemsize)
        assert plan["max_k"] == max_k and plan["wide_smem_bytes"] <= SMEM
        assert knn_select_plan(1 << 20, 2 * max_k, itemsize)["wide_smem_bytes"] > SMEM


def test_dipcn_select_resident_edge_by_element_size():
    """The resident mode holds the row's keys: 8 W bytes in float64, so its
    widest row at k=500 is about half float32's (still past N=2504)."""
    assert dipcn_select_smem_bytes(2504, 500, 8) - dipcn_select_smem_bytes(2504, 500, 4) == \
        2504 * 4
    e32 = _widest(lambda w: dipcn_select_smem_bytes(w, 500, 4) <= SMEM, 2504, 65536)
    e64 = _widest(lambda w: dipcn_select_smem_bytes(w, 500, 8) <= SMEM, 2504, 65536)
    assert 0.45 < e64 / e32 < 0.55 and e64 > 2504


def test_dipcn_select_float64_multi_form_keeps_the_binary_form_s_plan():
    """The multi-weight form's resident block holds what the binary form's
    does (step 5m compacts the list in place): in float64 21,356 B at
    N=2504, k=500, so the sweep's N=2504 rows stay resident; its edge at
    k=500 falls to ~28,000 columns (float32: ~55,000), and a panel's 65,536
    columns, like any row past the float64 resident edge, take the wide
    mode."""
    assert dipcn_select_smem_bytes(2504, 500, 8) == 2504 * 8 + 79 * 4 + 504 * 2 == 21_356
    e64 = _widest(lambda w: dipcn_select_smem_bytes(w, 500, 8) <= SMEM, 2504, 65536)
    e32 = _widest(lambda w: dipcn_select_smem_bytes(w, 500, 4) <= SMEM, 2504, 65536)
    assert 26_000 < e64 < 28_500 < 54_000 < e32
    assert dipcn_select_smem_bytes(65536, 500, 8) > SMEM


@pytest.mark.parametrize("k", [2, 10])
def test_phase_sweeps_resident_edge_by_element_size(k):
    """Two value buffers of 2N values in every block: 80 KB at N=2504 in
    float64, twice float32's, so the resident mode's largest N falls to
    about half."""
    assert phase_sweeps_smem_bytes(2504, k, 8) - phase_sweeps_smem_bytes(2504, k, 4) == \
        313 * (4 * 4 * 8 + 2 * 4 * k)
    assert 4 * 8 * 8 * 313 == 80_128  # the f64 value buffers at N=2504
    e32 = _widest(lambda n: phase_sweeps_smem_bytes(n, k, 4) <= SMEM, 1, 1 << 16)
    e64 = _widest(lambda n: phase_sweeps_smem_bytes(n, k, 8) <= SMEM, 1, 1 << 16)
    assert 0.45 < e64 / e32 < 0.65 and e64 > 2504


def test_d2_resident_edge_by_element_size():
    """N * N * itemsize against the 2 GiB budget, as grid_tpu's step: the
    resident edge is N = 23,170 in float32 and 16,384 in float64."""
    params = CohortParams()
    assert d2_resident(params, 23170, 4) and not d2_resident(params, 23171, 4)
    assert d2_resident(params, 16384, 8) and not d2_resident(params, 16385, 8)


@pytest.mark.parametrize("k", [1, 300, 500, 4000, 16384])
def test_knn_select_plan_bfloat16(k):
    """A bf16 row holds 2-byte keys and 4-byte list entries (key * 2^17 +
    column): a resident N=2504 row takes 2 * 2504 + 8 L bytes, a panel's
    65,536 columns 8 blocks of 8,192 (16 KB of keys each), slices round to
    8 keys (16 bytes); every row up to 131,072 columns takes the shared
    mode (at k = 16,384: a 64 KB list and a 64 KB gather buffer), wider
    rows none: the entry's column field is 17 bits."""
    length = max(128, 1 << (k - 1).bit_length())
    panel = knn_select_plan(65536, k, 2)
    assert (panel["cluster_blocks"], panel["slice"]) == (8, 8192)
    assert panel["shared_smem_bytes"] == 8192 * 2 + 4 * length + 4 * length
    assert knn_select_plan(8193, k, 2)["slice"] == 4104 and knn_select_plan(8193, k, 4)["slice"] \
        == 4100
    if k <= 2504:
        resident = knn_select_plan(2504, k, 2)
        assert resident["cluster_blocks"] == 1
        assert resident["shared_smem_bytes"] == 2504 * 2 + 8 * length
        assert knn_select_mode_of(2504, k, 2, SMEM) == "resident"
    assert knn_select_mode_of(65536, k, 2, SMEM) == "cluster"
    assert knn_select_mode_of(1 << 17, k, 2, SMEM) == "cluster"
    assert knn_select_mode_of((1 << 17) + 1, k, 2, SMEM) is None
    assert knn_select_plan(1 << 17, 16384, 2)["shared_smem_bytes"] <= SMEM


def test_dipcn_select_resident_edge_bfloat16():
    """The resident mode holds 2 W bytes of bf16 keys: 6,332 B at N=2504,
    k=500, and every row up to its 65,536-column limit (the uint16 list),
    the N=65,536 panels included, stays resident at k=500."""
    assert dipcn_select_smem_bytes(2504, 500, 2) == 2504 * 2 + 79 * 4 + 504 * 2 == 6_332
    assert dipcn_select_smem_bytes(65536, 500, 2) <= SMEM < dipcn_select_smem_bytes(65536, 500, 4)
    e16 = _widest(lambda w: dipcn_select_smem_bytes(w, w, 2) <= SMEM, 2504, 65536)
    e32 = _widest(lambda w: dipcn_select_smem_bytes(w, w, 4) <= SMEM, 2504, 65536)
    assert 1.4 < e16 / e32 < 1.6  # at k = W: 4 W against 6 W bytes of keys and list


def test_d2_resident_edge_bfloat16():
    """N * N * 2 against the 2 GiB budget, grid_tpu's rule at
    models/cohort.py:173: resident up to N = 32,768 in bf16."""
    params = CohortParams()
    assert d2_resident(params, 32768, 2) and not d2_resident(params, 32769, 2)
    assert not d2_resident(params, 32768, 4)


@pytest.mark.parametrize("mode", ["triangle", "split", "panel"])
@pytest.mark.parametrize("n", [1, 127, 128, 129, 2504, 16384, 65536])
def test_zprep_gram64_plan(n, mode):
    """The FP64 Gram's launch: one 128x128 tile a block, counted here tile
    by tile (the upper triangle, the diagonal, or a 512-row panel's row
    tiles times every column tile); 8 consumer warps and a producer warpgroup,
    64 float64 accumulators a consumer thread, one block an SM, so the
    waves on 132 SMs are the blocks over 132; a ring of at least 3 stages
    whose dynamic shared memory also holds the epilogue's tile and fits a
    block; 16 flops a byte from L2 at least; R_pad a multiple of the
    K-stage, which is the wrapper's."""
    rows = min(n, 512) if mode == "panel" else n
    plan = zprep_gram64_plan(n, rows, mode)
    t = plan["tile"]
    assert (t, plan["threads"], plan["accumulators"]) == (128, 384, 64)
    tiles = range(-(-n // t))
    want = {"triangle": sum(1 for i in tiles for j in tiles if i <= j),
            "split": sum(1 for i in tiles for j in tiles if i == j),
            "panel": sum(1 for i in range(-(-rows // t)) for j in tiles)}[mode]
    assert plan["blocks"] == want and 0 < plan["blocks"] < 2**31
    assert plan["waves"] == plan["blocks"] / 132 and plan["blocks_per_sm"] == 1
    assert plan["stages"] >= 3
    assert plan["ring_bytes"] == plan["stages"] * 2 * t * 16 * 8
    assert plan["smem_bytes"] == max(plan["ring_bytes"], t * (t + 1) * 8) + 1024 <= H100_SMEM
    assert plan["epilogue_bytes"] < plan["smem_bytes"] and plan["smem_bytes"] > 48 * 1024
    assert plan["flops_per_l2_byte"] >= 16
    assert plan["k_tile"] == _GRAM64_K_TILE == 16
    for r in (1, 15, 16, 17, 1000, 1024, 2047, 2048):
        r_pad = _r_pad(r, torch.float64)
        assert r_pad % plan["k_tile"] == 0 and r <= r_pad < r + plan["k_tile"]
    if (n, mode) == (2504, "triangle"):
        assert plan["blocks"] == 210 and round(plan["waves"], 2) == 1.59
    if (n, mode) == (65536, "panel"):
        assert plan["blocks"] == 2048 and round(plan["waves"], 1) == 15.5
        # 128x128 tiles read half the 8.6 GB of L2 that 64x64 tiles read
        assert zprep_gram64_l2_bytes(n, rows, mode, 1024) == (2 * 2048 - 4) * 128 * 1024 * 8
    if mode == "split":  # a diagonal tile reads its rows once
        assert zprep_gram64_l2_bytes(n, rows, mode, 16) == plan["blocks"] * t * 16 * 8


@pytest.mark.parametrize("offsets", [(0, 0), (4096, 256), (64, 200)],
                         ids=["own-block", "on-tiles", "off-tiles"])
@pytest.mark.parametrize("nb", [1, 127, 128, 129, 4096])
@pytest.mark.parametrize("na", [1, 127, 128, 129, 4096])
def test_zprep_gram64_cross_plan(na, nb, offsets):
    """The FP64 Gram's cross mode (the ring's [Ba, Bb] block product at
    float64): a block a tile over (a's row tiles) x (b's row tiles), a's
    row tiles of one b tile neighbours in the launch order, every tile once,
    the panel mode's count for a panel of Ba rows over Bb columns; both
    operands read from L2 (no diagonal tile). At the blocks' offsets in a
    cohort, the plain cross product of the blocks' own splits is bitwise
    the plain panel entries of one split of the cohort for the same rows
    (values on a grid of 1/4, so every sum is exact)."""
    a_off, b_off = offsets
    plan = zprep_gram64_plan(nb, na, "cross")
    t = plan["tile"]
    row_tiles, col_tiles = -(-na // t), -(-nb // t)
    assert plan["blocks"] == row_tiles * col_tiles == zprep_gram64_plan(nb, na, "panel")["blocks"]
    assert {(b % row_tiles, b // row_tiles) for b in range(plan["blocks"])} == {
        (i, j) for i in range(row_tiles) for j in range(col_tiles)}
    assert plan["waves"] == plan["blocks"] / 132 and plan["smem_bytes"] <= H100_SMEM
    assert zprep_gram64_l2_bytes(nb, na, "cross", 1024) == 2 * plan["blocks"] * t * 1024 * 8
    rng = np.random.default_rng(na * 7 + nb + a_off)
    z = torch.tensor(rng.integers(-12, 13, (max(a_off + na, b_off + nb), 3)) / 4.0)
    whole = zprep_split_plain(z, None, None, 2.0)
    a, b = (zprep_split_plain(z[o:o + m], None, None, 2.0) for o, m in ((a_off, na), (b_off, nb)))
    g = zprep_gram_cross_plain(a, b, a_off, b_off)
    assert g.dtype == torch.float64 and g.shape == (na, nb)
    assert torch.equal(g, zprep_gram_panel_plain(whole, a_off, na)[:, b_off:b_off + nb])
    if (na, nb) == (4096, 4096):  # the ring's block at N=16,384 over 4 ranks
        assert plan["blocks"] == 1024 and round(plan["waves"], 2) == 7.76


@pytest.mark.parametrize("n,world", [(301, 2), (300, 3), (97, 4)])
def test_zprep_gram_cross_plain_float64_equals_the_panel_entries(n, world):
    """The cross mode's plain version on float64 splits of the ring's
    blocks (ragged last block padded with zero rows, as the ranks pad it)
    gives the plain panel entries of the whole cohort's split for the same
    two rows, in float64: the ring's CPU route is the flat route's Gram."""
    rng = np.random.default_rng(n + world)
    r = 40
    z = torch.tensor(rng.normal(size=(n, r)) * 3)
    mask = torch.tensor(rng.random((n, r)) > 0.1)
    region = torch.tensor(rng.random(r) > 0.2)
    zp = torch.where(mask, z.clamp(-2.0, 2.0), 0) * region[None, :].double()
    b = -(-n // world)
    zpad = torch.cat([zp, zp.new_zeros((b * world - n, r))])
    whole = zprep_split_plain(zpad, None, None, float("inf"))
    blocks = [zprep_split_plain(zpad[i * b:(i + 1) * b], None, None, float("inf"))
              for i in range(world)]
    for a in range(world):
        panel = zprep_gram_panel_plain(whole, a * b, b)
        for o in range(world):
            g = zprep_gram_cross_plain(blocks[a], blocks[o], a * b, o * b)
            assert g.dtype == torch.float64 and g.shape == (b, b)
            assert_close_to_max(g.numpy(), panel[:, o * b:(o + 1) * b].numpy(), 1e-15)


# ----------------------------------------------------------------- keys ---


def _doubles(rng, subnormal=True):
    """Non-negative doubles with exact ties, zero, the least normal double
    (and a subnormal one), finfo.max and inf: what a float64 d2 row holds.
    XLA on the CPU flushes subnormals to zero, so rows for grid_tpu take
    none."""
    tiny = [5e-324] if subnormal else []
    x = np.concatenate([rng.uniform(0, 5000, 300), np.round(rng.uniform(0, 40, 300)) * 0.25,
                        [0.0, 2.2250738585072014e-308, np.finfo(np.float64).max,
                         np.finfo(np.float64).max, np.inf, 1e300, 1.0, 1.0, *tiny]])
    return rng.permutation(x)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int64_keys_order_non_negative_doubles_as_a_stable_sort(seed):
    x = _doubles(np.random.default_rng(seed))
    keys = x.view(np.int64)
    assert (keys >= 0).all()
    np.testing.assert_array_equal(np.argsort(keys, kind="stable"), np.argsort(x, kind="stable"))
    assert _key_type(torch.float64) is torch.int64
    # the k-th smallest key is the k-th smallest value, ties and finfo.max too
    t = torch.from_numpy(x)[None, :]
    for k in (1, 7, 300, 599, 603, x.size):
        key = _kth_smallest_key(t.view(torch.int64), k)
        assert float(key.view(torch.float64)[0]) == np.sort(x)[k - 1]


@pytest.mark.parametrize("k", [1, 13, 300, 608])
def test_float64_selection_is_the_stable_sort_sliced(k):
    """The port's plain selection (the float64 kernel's contract) and
    grid_tpu's exact selection under x64 give the stable sort's first k,
    ties to the lower column."""
    rng = np.random.default_rng(k)
    d2 = np.stack([_doubles(rng, subnormal=False) for _ in range(4)])
    order = np.argsort(d2, axis=1, kind="stable")[:, :k]
    vals, idx = sorted_smallest_k(torch.from_numpy(d2), k)
    assert vals.dtype == torch.float64
    np.testing.assert_array_equal(idx.numpy(), order)
    np.testing.assert_array_equal(vals.numpy(), np.take_along_axis(d2, order, axis=1))
    j_vals, j_idx = j_sorted_smallest_k(jnp.asarray(d2), k)
    np.testing.assert_array_equal(np.asarray(j_idx), order)
    np.testing.assert_array_equal(np.asarray(j_vals), vals.numpy())


# ------------------------------------------------- the step on the panels ---

N, R = 203, 96


@pytest.fixture(scope="module")
def cohort():
    values, mask, reads = make_matrix(N, R)
    reads_valid = np.ones(N, bool)
    reads_valid[::11] = False
    ring = [[((h + 2) % (2 * N), 1.0), ((h - 2) % (2 * N), 0.5)] for h in range(2 * N)]
    return (values, mask, reads, reads_valid, *pad_hap_neighbors(ring, 2, dtype=np.float64))


@pytest.mark.parametrize("quantize", [False, True])
def test_float64_panel_branch_one_byte_short_matches_grid_tpu(cohort, quantize):
    """At a d2 budget of N * N * 8 - 1 both packages stream row panels in
    float64 (and at N * N * 8 both keep d2 resident): the port's step equals
    grid_tpu's under x64, neighbor indices identical, dipCN within 1e-9."""
    assert jax.config.jax_enable_x64
    values, mask, reads, reads_valid, hi, hw, hv = cohort
    budget = N * N * 8 - 1
    assert not d2_resident(CohortParams(d2_budget_bytes=budget), N, 8)
    assert d2_resident(CohortParams(d2_budget_bytes=budget + 1), N, 8)
    assert d2_resident(CohortParams(d2_budget_bytes=budget), N, 4)  # float32 would stay
    jparams = JCohortParams(num_neighbors=30, n_nbr=12, n_iters=8, quantize=quantize,
                            row_block=64, d2_budget_bytes=budget)
    want = j_cohort_step(jnp.asarray(values), jnp.asarray(mask), jnp.asarray(reads),
                         jnp.asarray(reads_valid), jnp.asarray(hi), jnp.asarray(hw),
                         jnp.asarray(hv), jparams)
    want = jax.tree.map(np.asarray, want)
    assert want.z.dtype == np.float64
    inputs = inputs_to_torch(values, mask, reads, reads_valid, hi, hw, hv, "cpu", torch.float64)
    params = params_from_reference(jparams._asdict())
    assert params.d2_budget_bytes == budget
    got = outputs_to_numpy(cohort_step(*inputs, params))
    assert got.z.dtype == np.float64 and got.nbr_sq_dists.dtype == np.float64
    assert_close_to_max(got.z, want.z, 1e-9)
    np.testing.assert_array_equal(got.nbr_idx, want.nbr_idx)
    assert_close_to_max(got.nbr_sq_dists, want.nbr_sq_dists, 1e-9)
    np.testing.assert_array_equal(got.dipcn_valid, want.dipcn_valid)
    np.testing.assert_allclose(got.dipcn[got.dipcn_valid], want.dipcn[want.dipcn_valid],
                               rtol=1e-9)
    np.testing.assert_array_equal(got.phased, want.phased)
    resident = outputs_to_numpy(cohort_step(*inputs, params._replace(d2_budget_bytes=budget + 1)))
    np.testing.assert_array_equal(resident.nbr_idx, got.nbr_idx)


# ------------------------------------------------------- up-front refusals ---


def test_compute_dtype_takes_float64_on_the_card():
    assert compute_dtype({"device": {"dtype": "float64"}}, CUDA) is torch.float64
    assert compute_dtype({"device": {"dtype": "f64"}}, CUDA) is torch.float64
    assert compute_dtype({"device": {"dtype": "float32"}}, CUDA) is torch.float32
    assert compute_dtype({"device": {"dtype": "float64"}}, torch.device("cpu")) is torch.float64


@pytest.mark.parametrize("config,names", [
    ({"device": {"dtype": "bfloat16", "mesh_shape": [2], "fused": True}}, "mesh_shape"),
    ({"device": {"dtype": "bf16", "mesh_shape": [4]}}, "bfloat16"),
])
def test_compute_dtype_refuses_what_the_card_does_not_carry(config, names):
    """Once a refusal (its message named ``names``), now the rule: bfloat16
    runs on the card without device.mesh_shape
    (``tests/test_torch_bfloat16.py``) and with it, in either form
    (``tests/test_torch_bf16_sharded.py``), and resolves to bfloat16 up
    front."""
    assert compute_dtype({"device": {"dtype": "bfloat16"}}, CUDA) is torch.bfloat16
    assert compute_dtype(config, CUDA) is torch.bfloat16


@pytest.mark.parametrize("config", [
    {"device": {"dtype": "float64"}, "mosdepth": {"neighbors": {"num_neighbors": 500}}},
    {"device": {"dtype": "float64", "mesh_shape": [4]}},
    {"device": {"dtype": "float64", "mesh_shape": [2, 2], "fused": True}},
], ids=["multi-locus-sweep", "mesh-4", "mesh-2x2-fused"])
def test_compute_dtype_takes_float64_where_the_card_now_carries_it(config):
    """The configs compute_dtype refused on the card while the multi-weight
    dipcn_select and the cross-mode Gram were float32 only: the sweep's
    (it resolves the dtype as every entry point does) and the sharded
    steps' (``mesh_shape``, ring and gather form) now compute in float64
    there, as on the CPU."""
    assert compute_dtype(config, CUDA) is torch.float64
    assert compute_dtype(config, torch.device("cpu")) is torch.float64


def test_compute_dtype_refuses_float64_past_the_largest_k():
    """The float64 knn_select takes k <= 8,192 (float32: 16,384); a float64
    config that asks for more neighbors is refused before any step, naming
    the limit, where the wrapper would raise inside the step."""
    def config(dtype, k):
        return {"device": {"dtype": dtype}, "mosdepth": {"neighbors": {"num_neighbors": k}}}

    assert compute_dtype(config("float64", 8192), CUDA) is torch.float64
    assert compute_dtype(config("float32", 10000), CUDA) is torch.float32
    assert compute_dtype(config("float64", 10000), torch.device("cpu")) is torch.float64
    with pytest.raises(ValueError, match="8192"):
        compute_dtype(config("float64", 8193), CUDA)


@pytest.fixture(scope="module")
def disk_cohort(tmp_path_factory):
    return make_synthetic_cohort(tmp_path_factory.mktemp("cohort"), n_samples=12, seed=18)


def _config(disk_cohort, out, **device):
    cfg = copy.deepcopy(disk_cohort["config"])
    out.mkdir(parents=True, exist_ok=True)
    cfg["output_dir"] = str(out)
    cfg["device"] = device
    (out / "read_counts.tsv").write_bytes(disk_cohort["counts_file"].read_bytes())
    return cfg


class _Resolved(Exception):
    """Raised in place of the steps once the entry point has resolved its
    dtype."""


def _stop_after_dtype(module, monkeypatch) -> list:
    """Patch ``module.compute_dtype`` to record what it resolves and then
    stop the entry point before any step; returns the record."""
    real, seen = module.compute_dtype, []

    def resolve(config, device):
        seen.append((real(config, device), device))
        raise _Resolved

    monkeypatch.setattr(module, "compute_dtype", resolve)
    return seen


def test_float64_multi_locus_sweep_resolves_float64_before_any_step(disk_cohort, tmp_path,
                                                                    monkeypatch):
    """``run_multi_locus`` with ``device.dtype: float64`` on the card (the
    multi-weight dipcn_select's float64 form) resolves float64 up front,
    before any step has written a file."""
    import grid_tpu_torch.steps.multilocus as multilocus

    monkeypatch.setattr(multilocus, "config_device", lambda config: CUDA)
    seen = _stop_after_dtype(multilocus, monkeypatch)
    cfg = _config(disk_cohort, tmp_path / "out", dtype="float64")
    before = sorted(p.name for p in (tmp_path / "out").iterdir())
    with pytest.raises(_Resolved):
        multilocus.run_multi_locus(cfg, ["LPA", "APOE"])
    assert seen == [(torch.float64, CUDA)]
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == before


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "files"])
def test_float64_with_a_mesh_resolves_float64_before_any_step(disk_cohort, tmp_path, monkeypatch,
                                                              fused):
    """``run_wgs_pipeline`` with ``device.dtype: float64`` and
    ``mesh_shape`` on the card (the cross-mode Gram's float64 form)
    resolves float64 up front, before any step has written a file."""
    import grid_tpu_torch.pipeline as pipeline

    monkeypatch.setattr(pipeline, "config_device", lambda config: CUDA)
    seen = _stop_after_dtype(pipeline, monkeypatch)
    cfg = _config(disk_cohort, tmp_path / "out", dtype="float64", mesh_shape=[4], fused=fused)
    before = sorted(p.name for p in (tmp_path / "out").iterdir())
    with pytest.raises(_Resolved):
        pipeline.run_wgs_pipeline(console=None, config=cfg)
    assert seen == [(torch.float64, CUDA)]
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == before
