"""``device.dtype: bfloat16``: the port's plain bf16 route against grid_tpu's
bf16 on the CPU, at the contract of ``tests/torch_parity.py`` (BF16_*).

grid_tpu applies ``device.dtype`` to its fused steps 4-6 (a jitted
``cohort_step``) and to its file-mode step 4 (``normalize_cohort`` op by op)
only; its other steps read no dtype. XLA rounds each bf16 op once and sums
in float32, but inside a jit it keeps a product that feeds a reduction in
float32: the fused step sums the exact squares of its variance and of its
distance norms, the file step rounds them. The port follows each
(``normalize_cohort(round_squares=...)``, the norms of ``ops/gpu_kernels``).

- int16 keys order non-negative bf16 (0, subnormals, finfo.max) as a
  stable sort, in the port's plain selection and in grid_tpu's;
- the plain selection, ``dipcn_from_distances`` and ``dipcn_from_lists``
  against ``grid_tpu/ops/select.py``'s;
- ``normalize_cohort`` against ``grid_tpu/ops/normalize.py``'s, op by op
  and jitted;
- ``d2_matrix`` and the panel distances against ``grid_tpu/ops/knn.py``'s
  ``d2_matrix`` and ``knn_squared``;
- ``cohort_step`` on both branches against grid_tpu's bf16 ``cohort_step``
  (bf16 haplotype weights and ``n_iters=0``: with float64 weights grid_tpu's
  phasing scan raises, and its pipeline falls back to the file steps);
- ``run_wgs_pipeline`` in bf16, fused and in file mode, on the CPU;
- ``convert.py`` with bf16, and the step-dtype rule.

grid_tpu's ``lax.approx_max_k`` orders exact distance ties otherwise than a
stable sort in bf16 on the CPU (``lax.top_k`` keeps column order): its
lists are held to the port's under the tie rule with tol 0.
"""

import copy
import gzip
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import grid_tpu.pipeline as jax_pipeline
from bench import make_matrix
from grid_tpu.io.formats import read_counts_tsv as j_read_counts_tsv
from grid_tpu.io.formats import read_samples as j_read_samples
from grid_tpu.models.cohort import CohortParams as JCohortParams
from grid_tpu.models.cohort import cohort_step as j_cohort_step
from grid_tpu.ops import select as j_select
from grid_tpu.ops.knn import d2_matrix as j_d2_matrix
from grid_tpu.ops.knn import knn_squared as j_knn_squared
from grid_tpu.ops.knn import prepare_z as j_prepare_z
from grid_tpu.ops.normalize import normalize_cohort as j_normalize_cohort
from grid_tpu.steps.normalize import _stage as j_stage
from grid_tpu.synth import make_synthetic_cohort
from grid_tpu_torch.convert import (
    inputs_to_torch, outputs_to_numpy, params_from_reference, to_numpy,
)
from grid_tpu_torch.io.formats import read_dipcn, read_neighbors, read_normalized_data
from grid_tpu_torch.io.hap_neighbors import pad_hap_neighbors
from grid_tpu_torch.models.cohort import CohortParams, cohort_step, d2_resident
from grid_tpu_torch.ops.gpu_kernels import (
    masked_column_stats_plain, zprep_gram_plain, zprep_split,
)
from grid_tpu_torch.ops.knn import d2_matrix, d2_panels, knn_squared, sorted_smallest_k
from grid_tpu_torch.ops.normalize import normalize_cohort
from grid_tpu_torch.ops.select import (
    _kth_smallest_key, dipcn_from_distances, dipcn_from_lists, smallest_k_mask,
)
from grid_tpu_torch.pipeline import run_wgs_pipeline
from grid_tpu_torch.utils.device import compute_dtype, step_dtype
from torch_parity import (
    BF16_MIN_EQUAL, BF16_RTOL, assert_close_to_max, dipcn_sets_differ, equal_fraction,
    neighbor_rows_differing,
)

BF = torch.bfloat16
JBF = jnp.bfloat16
CPU, CUDA = torch.device("cpu"), torch.device("cuda")
ARTIFACTS = {
    "normalized": "mosdepth_results_normalized.tsv.gz",
    "neighbors": "neighbor_coverage.zMax2.0.tsv.gz",
    "dipcn": "diploid_genotypes.tsv",
    "haploid": "haploid_genotypes.tsv",
}


def host(a) -> np.ndarray:
    """grid_tpu's arrays (bf16 as ml_dtypes) and the port's tensors as
    float64 numpy arrays; bool stays bool."""
    if isinstance(a, torch.Tensor):
        a = to_numpy(a)
    a = np.asarray(a)
    if a.dtype == bool:
        return a
    return (a.astype(np.float32) if a.dtype.name == "bfloat16" else a).astype(np.float64)


def assert_bf16_close(got, want, label: str) -> float:
    """The values rule of the bf16 contract; returns the fraction of
    entries exactly equal, which must reach BF16_MIN_EQUAL."""
    got, want = host(got), host(want)
    if want.dtype == bool:
        np.testing.assert_array_equal(got, want, err_msg=label)
        return 1.0
    assert_close_to_max(got, want, BF16_RTOL)
    frac = equal_fraction(got, want)
    assert frac >= BF16_MIN_EQUAL, f"{label}: {frac:.4f} of the entries exactly equal"
    return frac


# ------------------------------------------------------------- the keys ---


def _bf16_row(rng, n: int) -> np.ndarray:
    """n non-negative finite bf16 values as their int16 patterns: zero,
    subnormals, the smallest normal and finfo.max among them, and a run of
    repeats (exact ties)."""
    bits = rng.integers(0, 0x7F80, n).astype(np.int16)
    bits[:8] = [0, 1, 2, 0x7F, 0x80, 0x7F7F, 0x7F7F, 0]
    bits[n // 2:n // 2 + 40] = bits[8:48]
    return bits


@pytest.mark.parametrize("k", [1, 17, 64, 256])
def test_int16_keys_order_bfloat16_as_a_stable_sort(k):
    """Non-negative bf16 read as int16 order as the values, so the k-th key,
    the membership mask and the sorted lists are the stable sort's, in the
    port's plain selection and in grid_tpu's exact one."""
    rng = np.random.default_rng(k)
    d2 = torch.from_numpy(np.stack([_bf16_row(rng, 256) for _ in range(4)])).view(BF)
    keys = d2.view(torch.int16)
    assert (keys >= 0).all()
    order = np.argsort(d2.float().numpy(), axis=1, kind="stable")[:, :k]
    np.testing.assert_array_equal(np.argsort(keys.numpy(), axis=1, kind="stable")[:, :k], order)
    vals, idx = sorted_smallest_k(d2, k)
    assert vals.dtype == BF
    np.testing.assert_array_equal(idx.numpy(), order)
    np.testing.assert_array_equal(vals.view(torch.int16).numpy(),
                                  np.take_along_axis(keys.numpy(), order, axis=1))
    np.testing.assert_array_equal(_kth_smallest_key(keys, k).numpy(),
                                  np.sort(keys.numpy(), axis=1)[:, k - 1])
    want_mask = np.zeros(d2.shape, bool)
    np.put_along_axis(want_mask, order, True, axis=1)
    np.testing.assert_array_equal(smallest_k_mask(d2, k).numpy(), want_mask)
    # grid_tpu's exact selection takes the same set by its int16 keys; its
    # final sort by value flushes subnormals to zero on the CPU, so it may
    # order 0 and the subnormals otherwise (ties within the smallest normal)
    jd2 = jnp.asarray(d2.float().numpy()).astype(JBF)
    np.testing.assert_array_equal(np.asarray(j_select.smallest_k_mask(jd2, k)), want_mask)
    j_vals, j_idx = j_select.sorted_smallest_k(jd2, k)
    neighbor_rows_differing(np.asarray(j_idx), host(j_vals), order, host(vals),
                            tol=float(torch.finfo(BF).tiny))


# ---------------------------------------------------- selection and dipCN ---


def _dipcn_case(seed: int, n: int = 96, w: int = 96):
    """Quantized distances (exact ties) with finfo(bf16).max columns, and
    float64 weights: the step hands grid_tpu reads / scales in float64, which
    its dipCN rounds to bf16."""
    rng = np.random.default_rng(seed)
    d2 = np.round(rng.uniform(0, 20, (n, w)) * 4) / 4
    d2[:, rng.random(w) < 0.05] = float(torch.finfo(BF).max)
    return (d2, rng.uniform(0.5, 2.0, n), rng.uniform(0.5, 2.0, w), rng.random(w) > 0.2,
            rng.random(n) > 0.1)


@pytest.mark.parametrize("seed,k,n_nbr", [(0, 20, 7), (1, 50, 30), (2, 95, 95), (3, 96, 40)])
def test_plain_dipcn_matches_grid_tpu(seed, k, n_nbr):
    """dipcn_from_distances and dipcn_from_lists in bf16 against grid_tpu's:
    the same take-sets, the sums rounded where grid_tpu rounds them (measured:
    bitwise equal)."""
    d2, rnorm, w, usable, valid = _dipcn_case(seed)
    td2 = torch.tensor(d2, dtype=BF)
    args = (torch.tensor(rnorm), torch.tensor(w), torch.tensor(usable), torch.tensor(valid))
    dip, ok = dipcn_from_distances(td2, *args, k=k, n_nbr=n_nbr)
    assert dip.dtype == BF
    jargs = (jnp.asarray(rnorm), jnp.asarray(w), jnp.asarray(usable), jnp.asarray(valid))
    jd2 = jnp.asarray(td2.float().numpy()).astype(JBF)
    j_dip, j_ok = j_select.dipcn_from_distances(jd2, *jargs, k=k, n_nbr=n_nbr)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(j_ok))
    assert_bf16_close(host(dip)[ok.numpy()], host(j_dip)[ok.numpy()], "dipcn_from_distances")
    sq, idx = sorted_smallest_k(td2, k)
    l_dip, l_ok = dipcn_from_lists(td2, sq, idx, *args, k=k, n_nbr=n_nbr)
    jl_dip, jl_ok = j_select.dipcn_from_lists(jd2, jnp.asarray(sq.float().numpy()).astype(JBF),
                                              jnp.asarray(idx.numpy()), *jargs, k=k,
                                              n_nbr=n_nbr)
    np.testing.assert_array_equal(l_ok.numpy(), np.asarray(jl_ok))
    np.testing.assert_array_equal(l_ok.numpy(), ok.numpy())
    assert_bf16_close(host(l_dip)[ok.numpy()], host(jl_dip)[ok.numpy()], "dipcn_from_lists")


# ----------------------------------------------------------- normalize ---


@pytest.mark.parametrize("shape", [(203, 96), (512, 256)])
def test_normalize_cohort_matches_grid_tpu(shape):
    """Both of grid_tpu's bf16 normalizes: op by op (its file-mode step 4;
    the squares of the variance sum rounded) and jitted (inside its fused
    step; the squares summed exactly). Each field within the bf16 contract
    (measured: bitwise equal)."""
    values, mask, _ = make_matrix(*shape)
    jv, jm = jnp.asarray(values).astype(JBF), jnp.asarray(mask)
    tv, tm = torch.as_tensor(values, dtype=BF), torch.as_tensor(mask)
    for want, round_squares in ((j_normalize_cohort(jv, jm), True),
                                (jax.jit(j_normalize_cohort)(jv, jm), False)):
        got = normalize_cohort(tv, tm, round_squares=round_squares)
        assert got.z.dtype == BF
        for field in want._fields:
            assert_bf16_close(getattr(got, field), getattr(want, field), field)


def test_column_statistics_plain_follow_the_rounding_asked():
    """The plain column statistics in bf16: x = values / row mean, x - mu
    rounded, the square rounded or exact, float32 sums rounded once."""
    rng = np.random.default_rng(5)
    v = torch.tensor(rng.uniform(10, 60, (64, 40)), dtype=BF)
    m = torch.tensor(rng.random((64, 40)) > 0.15)
    rm = torch.tensor(rng.uniform(20, 40, 64), dtype=BF)
    mu = torch.tensor(rng.uniform(0.8, 1.2, 40), dtype=BF)
    x = torch.where(m, (v.float() / rm.float()[:, None]).to(BF), 0)
    c = torch.where(m, (x.float() - mu.float()).to(BF), 0).float()
    for round_squares, sq in ((True, (c * c).to(BF).float()), (False, c * c)):
        cnt, s, dev = masked_column_stats_plain(v, m, rm, mu, round_squares=round_squares)
        assert cnt.dtype == s.dtype == dev.dtype == BF
        np.testing.assert_array_equal(cnt.float().numpy(), m.sum(0).to(BF).float().numpy())
        np.testing.assert_array_equal(s.float().numpy(), x.float().sum(0).to(BF).float().numpy())
        np.testing.assert_array_equal(dev.float().numpy(), sq.sum(0).to(BF).float().numpy())


# -------------------------------------------------------------- distances ---


@pytest.fixture(scope="module")
def prepared():
    """A jitted grid_tpu bf16 normalize's z, a region mask and valid rows."""
    values, mask, _ = make_matrix(203, 96)
    norm = jax.jit(j_normalize_cohort)(jnp.asarray(values).astype(JBF), jnp.asarray(mask))
    rng = np.random.default_rng(7)
    region = rng.random(96) > 0.2
    valid = rng.random(203) > 0.1
    return np.asarray(norm.z).astype(np.float32), np.asarray(norm.mask), region, valid


def test_d2_matrix_matches_grid_tpu(prepared):
    """The resident distances, from the Gram product and grid_tpu's norms
    (sum(z * z), the squares exact, rounded once), each op of d2 rounded:
    within the bf16 contract of jit(grid_tpu's d2_matrix)."""
    z, mask, region, valid = prepared
    want = jax.jit(lambda z, m, r, v: j_d2_matrix(j_prepare_z(z, m, 2.0, r), v))(
        jnp.asarray(z).astype(JBF), jnp.asarray(mask), jnp.asarray(region), jnp.asarray(valid))
    got = d2_matrix(torch.tensor(z, dtype=BF), torch.tensor(mask), torch.tensor(region), 2.0,
                    row_valid=torch.tensor(valid))
    assert got.dtype == BF
    assert_bf16_close(got, want, "d2")
    g, sq = zprep_gram_plain(torch.tensor(z, dtype=BF), torch.tensor(mask),
                             torch.tensor(region), 2.0, norms=True)
    p = torch.where(torch.tensor(mask), torch.tensor(z, dtype=BF).clamp(-2, 2), 0) * \
        torch.tensor(region).to(BF)
    np.testing.assert_array_equal(sq.float().numpy(),
                                  (p.float() ** 2).sum(1).to(BF).float().numpy())


def test_panel_distances_match_grid_tpu(prepared):
    """Row panels of the split (its norms the resident branch's) give the
    resident distances bitwise, and knn_squared's lists are grid_tpu's
    knn_squared's (``selector="top_k"``: column order among exact ties)."""
    z, mask, region, valid = prepared
    tz = torch.tensor(z, dtype=BF)
    tmask, treg, tvalid = torch.tensor(mask), torch.tensor(region), torch.tensor(valid)
    resident = d2_matrix(tz, tmask, treg, 2.0, row_valid=tvalid)
    split = zprep_split(tz, tmask, treg, 2.0)
    panels = torch.cat([d2 for _, d2 in d2_panels(split, 64, tvalid)])
    np.testing.assert_array_equal(panels.view(torch.int16).numpy(),
                                  resident.view(torch.int16).numpy())
    zp = split.p
    sq, idx = knn_squared(zp, 30, row_valid=tvalid, row_block=64)
    j_sq, j_idx = jax.jit(j_knn_squared, static_argnames=("k", "row_block", "selector"))(
        jnp.asarray(zp.float().numpy()).astype(JBF), k=30, row_valid=jnp.asarray(valid),
        row_block=64, selector="top_k")
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    assert_bf16_close(sq, j_sq, "knn_squared distances")


# ------------------------------------------------------------ the step ---

N, R = 203, 96


@pytest.fixture(scope="module")
def cohort():
    values, mask, reads = make_matrix(N, R)
    reads_valid = np.ones(N, bool)
    reads_valid[::11] = False
    ring = [[((h + 2) % (2 * N), 1.0), ((h - 2) % (2 * N), 0.5)] for h in range(2 * N)]
    return (values, mask, reads, reads_valid, *pad_hap_neighbors(ring, 2, dtype=np.float64))


def _lists_within_contract(got_idx, got_d, want_idx, want_d, usable, n_nbr):
    """The lists rule (ties within BF16_RTOL of the row's k-th distance);
    returns the rows whose dipCN input sets differ."""
    want_d = host(want_d)
    neighbor_rows_differing(got_idx, host(got_d), want_idx, want_d, tol=BF16_RTOL * want_d[:, -1])
    return dipcn_sets_differ(got_idx, want_idx, usable, n_nbr)


@pytest.mark.parametrize("branch", ["resident", "panels"])
@pytest.mark.parametrize("quantize", [False, True])
def test_cohort_step_matches_grid_tpu(cohort, branch, quantize):
    """The port's bf16 step against grid_tpu's jitted bf16 step, at a d2
    budget of N * N * 2 (resident) or one byte short (panels) in both
    packages: every value within the bf16 contract (measured: bitwise
    equal), the lists equal but for the order of exact ties (grid_tpu's
    approx_max_k; tol 0), dipCN where the input sets agree."""
    values, mask, reads, reads_valid, hi, hw, hv = cohort
    budget = N * N * 2 - (branch == "panels")
    assert d2_resident(CohortParams(d2_budget_bytes=budget), N, 2) == (branch == "resident")
    assert not d2_resident(CohortParams(d2_budget_bytes=budget), N, 4)  # float32 would not
    jparams = JCohortParams(num_neighbors=30, n_nbr=12, n_iters=0, quantize=quantize,
                            row_block=64, d2_budget_bytes=budget)
    want = j_cohort_step(jnp.asarray(values).astype(JBF), jnp.asarray(mask), jnp.asarray(reads),
                         jnp.asarray(reads_valid), jnp.asarray(hi), jnp.asarray(hw).astype(JBF),
                         jnp.asarray(hv), jparams)
    want = jax.tree.map(np.asarray, want)
    inputs = inputs_to_torch(values, mask, reads, reads_valid, hi, hw, hv, "cpu", BF,
                             step_dtype({"device": {"dtype": "bf16"}}, CPU))
    assert inputs[2].dtype == torch.float64
    out = cohort_step(*inputs, params_from_reference(jparams._asdict()))
    assert out.z.dtype == out.nbr_sq_dists.dtype == out.dipcn.dtype == BF
    assert out.hap_irrs.dtype == torch.float64  # step 7 as under auto
    got = outputs_to_numpy(out)
    for field in ("z", "col_means", "col_vars", "var_ratio", "scales", "region_selected",
                  "region_used", "z_mask", "dipcn_valid"):
        assert_bf16_close(getattr(got, field), getattr(want, field), field)
    assert int(got.r_use) == int(want.r_use)
    usable = reads_valid & want.z_mask.any(axis=1)
    sets = _lists_within_contract(got.nbr_idx, got.nbr_sq_dists, want.nbr_idx, want.nbr_sq_dists,
                                  usable, 12)
    neighbor_rows_differing(got.nbr_idx, got.nbr_sq_dists, want.nbr_idx,
                            host(want.nbr_sq_dists), tol=0)
    assert_bf16_close(got.nbr_sq_dists, want.nbr_sq_dists, "nbr_sq_dists")
    ok = got.dipcn_valid & ~sets
    assert_bf16_close(got.dipcn[ok], want.dipcn[ok], "dipcn")


# ------------------------------------------------------------- convert ---


def test_convert_carries_bfloat16_through_float32():
    """grid_tpu's bf16 arrays (ml_dtypes) come in through float32 and the
    port's bf16 outputs leave as float32 arrays of the same values: numpy
    has no bf16, and float32 holds every bf16 value exactly."""
    rng = np.random.default_rng(3)
    jvals = jnp.asarray(rng.uniform(0, 100, (6, 5))).astype(JBF)
    bf_host = np.asarray(jvals)
    assert bf_host.dtype.name == "bfloat16"
    hi, hw, hv = pad_hap_neighbors([[] for _ in range(12)], 2, dtype=np.float64)
    ins = inputs_to_torch(bf_host, np.ones((6, 5), bool), np.arange(6.0), np.ones(6, bool),
                          hi, np.asarray(jnp.asarray(hw).astype(JBF)), hv, "cpu", BF,
                          torch.float64)
    assert ins[0].dtype == BF and ins[2].dtype == torch.float64 and ins[5].dtype == torch.float32
    np.testing.assert_array_equal(ins[0].float().numpy(), bf_host.astype(np.float32))
    arr = to_numpy(ins[0])
    assert arr.dtype == np.float32
    np.testing.assert_array_equal(arr, bf_host.astype(np.float32))
    np.testing.assert_array_equal(torch.from_numpy(arr).to(BF).view(torch.int16).numpy(),
                                  bf_host.view(np.int16))
    assert to_numpy(torch.ones(2, dtype=torch.float64)).dtype == np.float64


# ---------------------------------------------------- the step-dtype rule ---


def test_step_dtype_rule():
    """bfloat16 is device.dtype's for steps 4-6 of the fused form and step 4
    of file mode; the steps grid_tpu runs without reading it (file-mode 5
    and 6, step 7, the sweep's batched dipCN) take float32 on the card and
    float64 on the CPU, as under auto. float32 and float64 are unchanged."""
    bf = {"device": {"dtype": "bfloat16"}}
    assert compute_dtype(bf, CPU) is BF and compute_dtype(bf, CUDA) is BF
    assert step_dtype(bf, CPU) is torch.float64 and step_dtype(bf, CUDA) is torch.float32
    for name, want in (("float32", torch.float32), ("float64", torch.float64)):
        cfg = {"device": {"dtype": name}}
        for dev in (CPU, CUDA):
            assert step_dtype(cfg, dev) is compute_dtype(cfg, dev) is want
    assert step_dtype(None, CPU) is torch.float64 and step_dtype(None, CUDA) is torch.float32


@pytest.mark.parametrize("device", [CPU, CUDA])
@pytest.mark.parametrize("fused", [False, True])
def test_bfloat16_with_mesh_shape_is_refused(device, fused):
    """Once a refusal, now the dtype rule with ``device.mesh_shape``: it
    resolves to bfloat16 on either device and in either form (the sharded
    step's bf16 forms, ``tests/test_torch_bf16_sharded.py``), and the
    steps grid_tpu runs without reading it, the reads and step 7 to
    ``step_dtype``, as without ``mesh_shape``."""
    cfg = {"device": {"dtype": "bf16", "mesh_shape": [2], "fused": fused}}
    assert compute_dtype(cfg, device) is BF
    wide = torch.float32 if device.type == "cuda" else torch.float64
    assert step_dtype(cfg, device) is wide


# ---------------------------------------------------------- the pipeline ---


def content(path) -> bytes:
    return gzip.open(path).read() if str(path).endswith(".gz") else path.read_bytes()


def run_config(cohort, out, device, counts=True, **sections):
    cfg = copy.deepcopy(cohort["config"])
    out.mkdir(parents=True, exist_ok=True)
    cfg["output_dir"] = str(out)
    cfg["device"] = dict(device)
    for name, values in sections.items():
        cfg[name].update(values)
    if counts:
        (out / "read_counts.tsv").write_bytes(cohort["counts_file"].read_bytes())
    return cfg


def neighbor_lists(out, ids):
    row = {s: i for i, s in enumerate(ids)}
    nbrs, _ = read_neighbors(out / ARTIFACTS["neighbors"])
    return (np.array([[row[m] for m, _, _ in nbrs[s]] for s in ids]),
            np.array([[dist for _, _, dist in nbrs[s]] for s in ids], np.float64))


@pytest.fixture(scope="module")
def wgs(tmp_path_factory):
    return make_synthetic_cohort(tmp_path_factory.mktemp("bf16_cohort"), n_samples=15, seed=21,
                                 missing_frac=0.02)


def test_bfloat16_with_mesh_shape_writes_nothing(wgs, tmp_path):
    """Once a refusal that wrote nothing, now the run: the fused form in
    bf16 with ``mesh_shape: [2]`` writes the four artifacts; 15 samples sit
    below the ring's crossover, so the dispatch policy runs the flat step,
    and the artifacts are bf16's without ``mesh_shape``, byte for byte
    (the ring in bf16: ``tests/test_torch_bf16_sharded.py``)."""
    for name, device in (("mesh", {"mesh_shape": [2]}), ("flat", {})):
        cfg = run_config(wgs, tmp_path / name, {"dtype": "bfloat16", "fused": True,
                                                "platform": "cpu", **device})
        assert "fused_steps_4_7" in run_wgs_pipeline(console=None, config=cfg)
    for name in ARTIFACTS.values():
        assert content(tmp_path / "mesh" / name) == content(tmp_path / "flat" / name), name


def test_file_mode_bfloat16_matches_grid_tpu(wgs, tmp_path):
    """File mode in bf16 on the CPU: step 4's normalized matrix against
    grid_tpu's bf16 file-mode step 4 (z and the scales bitwise as written;
    the variance-ratio header within a %.3f digit of the bf16 contract:
    grid_tpu's writer divides its bf16 arrays in bf16, the port's its
    float32 copies), and steps 5-7 byte-identical to grid_tpu's steps 5-7 on
    the port's normalized file (float64 on the CPU in both), neighbors
    identical or differing only by exact ties, dipCN within 1e-9 (its
    float64 sums in another order) and the haploid table's cells within
    1e-9."""
    port = run_config(wgs, tmp_path / "torch", {"dtype": "bfloat16", "platform": "cpu"})
    run_wgs_pipeline(console=None, config=port)
    ref = run_config(wgs, tmp_path / "jax", {"dtype": "bfloat16"})
    jax_pipeline.run_wgs_pipeline(console=None, config=ref)
    ids, ratio, z, scales = read_normalized_data(tmp_path / "torch" / ARTIFACTS["normalized"])
    j_ids, j_ratio, j_z, j_scales = read_normalized_data(tmp_path / "jax" / ARTIFACTS["normalized"])
    assert ids == j_ids
    np.testing.assert_array_equal(np.isnan(z), np.isnan(j_z))
    assert_bf16_close(np.nan_to_num(z), np.nan_to_num(j_z), "written z")
    assert scales == j_scales
    assert_close_to_max(ratio, j_ratio, BF16_RTOL)
    # grid_tpu's steps 5-7 (no dtype of theirs) on the port's step-4 file
    again = run_config(wgs, tmp_path / "again", {"dtype": "bfloat16"})
    again["mosdepth"]["normalize"]["run"] = False  # a deep copy: the cohort's stays
    shutil.copy(tmp_path / "torch" / ARTIFACTS["normalized"],
                tmp_path / "again" / ARTIFACTS["normalized"])
    jax_pipeline.run_wgs_pipeline(console=None, config=again)
    got_idx, got_d = neighbor_lists(tmp_path / "torch", ids)
    want_idx, want_d = neighbor_lists(tmp_path / "again", ids)
    neighbor_rows_differing(got_idx, got_d, want_idx, want_d, tol=0)
    if not (got_idx != want_idx).any():
        assert content(tmp_path / "torch" / ARTIFACTS["neighbors"]) == \
            content(tmp_path / "again" / ARTIFACTS["neighbors"])
    d_ids, d_vals, _ = read_dipcn(tmp_path / "torch" / ARTIFACTS["dipcn"])
    w_ids, w_vals, _ = read_dipcn(tmp_path / "again" / ARTIFACTS["dipcn"])
    assert d_ids == w_ids and len(d_ids) > 0
    np.testing.assert_allclose(d_vals, w_vals, rtol=1e-9, atol=0)

    def cells(path):
        lines = path.read_text().splitlines()
        return lines[0], [ln.split("\t")[0] for ln in lines[1:]], np.array(
            [[float(x) for x in ln.split("\t")[1:]] for ln in lines[1:]])

    (g_head, g_ids, g_cells), (w_head, w_ids2, w_cells) = (
        cells(d / ARTIFACTS["haploid"]) for d in (tmp_path / "torch", tmp_path / "again"))
    assert g_head == w_head and g_ids == w_ids2
    np.testing.assert_allclose(g_cells, w_cells, rtol=1e-9, atol=1e-12)


def test_fused_bfloat16_matches_grid_tpu_s_step(wgs, tmp_path):
    """The fused form in bf16 on the CPU writes four artifacts; its
    neighbors and dipCN are held to grid_tpu's bf16 cohort_step on the same
    staged arrays (float64 reads, bf16 placeholder weights, no sweeps: with
    float64 weights grid_tpu's own fused bf16 raises in its phasing scan and
    falls back to its file steps)."""
    port = run_config(wgs, tmp_path, {"dtype": "bfloat16", "fused": True, "platform": "cpu"})
    timings = run_wgs_pipeline(console=None, config=port)
    assert "fused_steps_4_7" in timings
    cfg = wgs["config"]
    ncfg, kcfg = cfg["mosdepth"]["normalize"], cfg["mosdepth"]["neighbors"]
    stage = j_stage(cfg, j_read_samples(cfg["samples_file"]), cfg.get("chrom"),
                    cfg.get("start_bp"), cfg.get("end_bp"), {}, ncfg.get("min_depth", 20),
                    ncfg.get("max_depth", 100), 1, None)
    n = len(stage.sample_ids)
    counts = j_read_counts_tsv(tmp_path / "read_counts.tsv")
    reads = np.array([counts.get(s, np.nan) for s in stage.sample_ids])
    reads_valid = np.array([s in counts for s in stage.sample_ids])
    hi, hw, hv = pad_hap_neighbors([[] for _ in range(2 * n)], 10, dtype=np.float64)
    k = min(kcfg.get("num_neighbors", 500), n - 1)
    n_nbr = cfg["compute_diploid_genotypes"].get("n_nbr", 300)
    jparams = JCohortParams(top_frac=ncfg.get("top_frac", 0.1), zmax=kcfg.get("zmax", 2.0),
                            num_neighbors=k, n_nbr=n_nbr, n_iters=0, quantize=True)
    want = jax.tree.map(np.asarray, j_cohort_step(
        jnp.asarray(stage.values).astype(JBF), jnp.asarray(stage.mask), jnp.asarray(reads),
        jnp.asarray(reads_valid), jnp.asarray(hi), jnp.asarray(hw).astype(JBF),
        jnp.asarray(hv), jparams))
    ids = list(stage.sample_ids)
    got_idx, got_d = neighbor_lists(tmp_path, ids)
    r_use = max(int(want.r_use), 1)
    want_d = host(want.nbr_sq_dists) / (2 * r_use)
    neighbor_rows_differing(got_idx, got_d, want.nbr_idx, want_d,
                            tol=BF16_RTOL * want_d[:, -1] + 1e-6)
    usable = reads_valid & want.z_mask.any(axis=1)
    sets = dipcn_sets_differ(got_idx, want.nbr_idx, usable, n_nbr)
    dip_ids, dip, _ = read_dipcn(tmp_path / ARTIFACTS["dipcn"])
    assert dip_ids == [s for s, ok in zip(ids, want.dipcn_valid) if ok]
    rows = [ids.index(s) for s in dip_ids]
    keep = ~sets[rows]
    np.testing.assert_allclose(np.asarray(dip)[keep], host(want.dipcn)[rows][keep],
                               rtol=BF16_RTOL)
    assert (tmp_path / ARTIFACTS["haploid"]).exists()
    _, ratio, z, _ = read_normalized_data(tmp_path / ARTIFACTS["normalized"])
    assert np.isfinite(z[~np.isnan(z)]).all() and len(ratio) == int(want.region_selected.sum())
