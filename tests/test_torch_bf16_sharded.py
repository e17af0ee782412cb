"""``device.dtype: bfloat16`` with ``device.mesh_shape``: the port's sharded
step in bf16 against grid_tpu's, on gloo ranks on the CPU.

grid_tpu's two sharded forms round in two places, and the port follows
each (``parallel/pstats.py``, ``parallel/pcohort.py``):

- its ring (``sharded_cohort_step``, a ``shard_map`` step) takes each
  shard's ``jnp.sum`` of bf16 (rounded to bf16 once), then ``psum``s the W
  partials (added in float32, rounded once); it sums the exact squares of
  the deviations and of the norms; its reads, dipCN weights and dipCN stay
  in the reads' float64. The port's ring is held to it bitwise in z, the
  column statistics, the ratios, the scales and the region masks, its
  lists under the tie rule at tol 0, its distances bitwise where the lists
  agree, and dipCN and step 7 at 1e-9 in float64;
- its gather form (``auto_sharded_cohort_step``, GSPMD) is its flat bf16
  step bit for bit: the port's gather form sums the ranks' float32
  partials unrounded, and is held to grid_tpu's gather form and to the
  port's flat bf16 panel step at the bf16 contract
  (``tests/torch_parity.py``), the entries apart counted.

Also: ``all_reduce_sum`` in bf16 against a model of XLA's ``psum``; bf16
splits through ``gather_split``; the ring merge on bf16 rows of k + B
columns, sentinels included; the sharded stager in bf16 against grid_tpu's
``stage_cohort_sharded(dtype=bfloat16)`` and its staged step against the
ring from host arrays; the fused pipeline with ``mesh_shape: [4]``,
``dispatch: ring`` and bf16 against grid_tpu's run of the same config; and
file mode with ``mesh_shape`` in bf16. Each fixture runs its cases in one
spawn of W ranks.
"""

import copy
import gzip

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import grid_tpu.pipeline as jax_pipeline
import torch_ranks
from bench import make_matrix
from grid_tpu.io.hap_neighbors import pad_hap_neighbors
from grid_tpu.io.staging import bed_source as jax_bed_source
from grid_tpu.io.staging import stage_cohort_sharded as jax_stage_cohort_sharded
from grid_tpu.models.cohort import CohortParams as JCohortParams
from grid_tpu.parallel.mesh import cohort_mesh
from grid_tpu.parallel.mesh import pad_rows as jax_pad_rows
from grid_tpu.parallel.mesh import shard_cohort_inputs as jax_shard_cohort_inputs
from grid_tpu.parallel.pcohort import auto_sharded_cohort_step as jax_auto_sharded_cohort_step
from grid_tpu.parallel.pcohort import sharded_cohort_step as jax_sharded_cohort_step
from grid_tpu.parallel.pknn import ring_knn as jax_ring_knn
from grid_tpu.synth import make_synthetic_cohort
from grid_tpu_torch.convert import inputs_to_torch, outputs_to_numpy, to_numpy
from grid_tpu_torch.io.formats import read_dipcn, read_neighbors, read_normalized_data
from grid_tpu_torch.models.cohort import CohortOutputs, CohortParams, cohort_step
from grid_tpu_torch.parallel import (
    auto_sharded_cohort_step,
    run_ranks,
    sharded_cohort_step,
    staged_sharded_cohort_step,
)
from grid_tpu_torch.parallel.mesh import RankWorkspace, block_rows
from grid_tpu_torch.parallel.pcohort import _output_handles
from grid_tpu_torch.pipeline import run_wgs_pipeline
from test_torch_staging_sharded import ARRAY_CASES, file_pairs, load, shares
from torch_parity import (
    BF16_MIN_EQUAL,
    BF16_RTOL,
    assert_close_to_max,
    dipcn_sets_differ,
    equal_fraction,
    neighbor_rows_differing,
)

BF, F64 = torch.bfloat16, torch.float64
JBF = jnp.bfloat16
N, R = 601, 48  # no W of 2, 3 or 4 divides N; every column counts > 256 rows
K, N_NBR = 20, 10
PARAMS = dict(num_neighbors=K, n_nbr=N_NBR, n_iters=5, row_block=128)
WORLDS = [2, 3, 4]


def host(a) -> np.ndarray:
    """grid_tpu's arrays (bf16 as ml_dtypes) and the port's tensors as
    float64 numpy arrays; bool and integers stay as they are."""
    if isinstance(a, torch.Tensor):
        a = to_numpy(a)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return a.astype(np.float64) if a.dtype.kind == "f" else a


def bits_equal(got, want, label: str) -> None:
    got, want = host(got), host(want)
    assert got.shape == want.shape, label
    np.testing.assert_array_equal(got, want, err_msg=label)


def bf16_close(got, want, label: str) -> int:
    """The values rule of the bf16 contract; returns the count of entries
    apart (which must leave BF16_MIN_EQUAL of them exactly equal)."""
    got, want = host(got), host(want)
    if want.dtype == bool:
        np.testing.assert_array_equal(got, want, err_msg=label)
        return 0
    assert_close_to_max(got, want, BF16_RTOL)
    frac = equal_fraction(got, want)
    assert frac >= BF16_MIN_EQUAL, f"{label}: {frac:.4f} of the entries exactly equal"
    same = (got == want) | (np.isnan(got) & np.isnan(want))
    return int((~same).sum())


def cohort():
    """bench's matrix (every column valid in ~98% of rows), reads with gaps,
    an empty sample, and a ring of haplotype neighbors with bf16 weights."""
    values, mask, reads = make_matrix(N, R, seed=3)
    mask[11] = False
    values *= mask
    reads_valid = np.ones(N, bool)
    reads_valid[::13] = False
    return values, mask, reads, reads_valid


def hap(n_rows: int):
    """[2 n_rows, 2] haplotype neighbors of the N samples (padding rows
    have none), the weights bf16 values held as float32."""
    ring = [[((h + 2) % (2 * N), 1.0), ((h - 2) % (2 * N), 0.5)] for h in range(2 * N)]
    hi, hw, hv = pad_hap_neighbors(ring + [[]] * (2 * (n_rows - N)), 2, dtype=np.float64)
    return hi, hw.astype(np.float32), hv


def padded(world):
    """The gather form's inputs: N_pad rows, a multiple of ``world``."""
    values, mask, reads, reads_valid = cohort()
    n_pad = block_rows(N, world) * world

    def pad(a, fill=0):
        return np.concatenate([a, np.full((n_pad - N, *a.shape[1:]), fill, a.dtype)])

    return (pad(values), pad(mask, False), pad(reads), pad(reads_valid, False), *hap(n_pad),
            np.arange(n_pad) < N)


# ---------------------------------------------------------- the cases ---


def reduce_case(world: int) -> torch.Tensor:
    """[W, 64] bf16 partials: sums of a few hundred, where sequential bf16
    adds round at every add."""
    rng = np.random.default_rng(world)
    return torch.tensor(rng.uniform(100, 400, (world, 64)), dtype=BF)


SPLIT_N, SPLIT_R = 12, 5
# name: (n, r, k, kind, invalid rows)
KNN_CASES = {"quantized": (64, 12, 9, "quantized", 3), "continuous": (40, 6, 5, "normal", 3),
             "sentinels": (40, 8, 33, "normal", 10)}


def knn_inputs(case):
    """Prepared bf16 z (clipped to ±2): quantized to halves (exact ties),
    or continuous; the last rows invalid (in "sentinels" so many that every
    list ends in finfo(bf16).max entries)."""
    n, r, k, kind, invalid = KNN_CASES[case]
    rng = np.random.default_rng(n + k)
    z = rng.normal(size=(n, r)).clip(-2, 2)
    if kind == "quantized":
        z = np.round(z * 2) / 2
    z = torch.tensor(z, dtype=BF).float().numpy()
    w = rng.uniform(0.1, 3.0, n)
    usable = rng.random(n) > 0.25
    valid = np.ones(n, bool)
    valid[-invalid:] = False
    return z, valid, w, usable, k


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"W{w}")
def bf16_ranks(request):
    """One spawn of W gloo ranks: the bf16 reductions, the ring step (both
    payload forms), the gather form, the bf16 splits and the ring merges."""
    world = request.param
    values, mask, reads, reads_valid = cohort()
    n_pad = block_rows(N, world) * world
    params = CohortParams(**PARAMS)
    with RankWorkspace() as ws:
        reduce_t = reduce_case(world)
        reduce_out = ws.empty((64,), BF)
        rings = {}
        for payload_ring in (True, False):
            inputs = (ws.put(values, BF), ws.put(mask, torch.bool), ws.put(reads, F64),
                      ws.put(reads_valid, torch.bool), *(ws.put(a) for a in hap(N)))
            outputs = _output_handles(ws, n_pad, R, K, N, BF, F64, ring=True)
            rings[payload_ring] = (inputs, outputs, params, payload_ring, BF, F64)
        pv, pm, pr, prv, phi, phw, phv, prow = padded(world)
        auto_in = (ws.put(pv, BF), ws.put(pm), ws.put(pr, F64), ws.put(prv), ws.put(prow),
                   ws.put(phi, torch.int32), ws.put(phw), ws.put(phv))
        auto_out = _output_handles(ws, n_pad, R, K, n_pad, BF, F64, ring=False)
        rng = np.random.default_rng(11)
        splits = {}
        for name, halves in (("card", (1,)), ("cpu", ())):
            p = torch.tensor(rng.normal(size=(*halves, SPLIT_N, SPLIT_R)), dtype=BF)
            norms = torch.tensor(rng.uniform(size=SPLIT_N), dtype=BF)
            splits[name] = (p, norms, ws.empty(p.shape, BF), ws.empty((SPLIT_N,), BF))
        knn = {}
        for case in KNN_CASES:
            z, valid, w, usable, k = knn_inputs(case)
            kn_pad = block_rows(z.shape[0], world) * world
            knn[case] = {"d": ws.empty((kn_pad, k), BF), "idx": ws.empty((kn_pad, k), torch.int32),
                         "w": ws.empty((kn_pad, k), F64),
                         "usable": ws.empty((kn_pad, k), torch.bool),
                         "widest": ws.empty((world,), torch.int64)}
        knn_cases = [(ws.put(z, BF), ws.put(valid), ws.put(w), ws.put(usable), k, knn[case])
                     for case, (z, valid, w, usable, k) in
                     ((c, knn_inputs(c)) for c in KNN_CASES)]
        split_cases = [(ws.put(p), ws.put(nm), op, on) for p, nm, op, on in splits.values()]
        run_ranks(torch_ranks.bf16_sharded_rank, world,
                  ([(ws.put(reduce_t), reduce_out)], list(rings.values()), [(auto_in, auto_out,
                                                                            params, BF, F64)],
                   split_cases, knn_cases), platform="cpu", workspace=ws)
        got = {
            "reduce": (reduce_t, reduce_out.open().clone()),
            "ring": {pr_: CohortOutputs._make(h.open().clone() for h in args[1])
                     for pr_, args in rings.items()},
            "auto": CohortOutputs._make(h.open().clone() for h in auto_out),
            "splits": {name: (p, nm, op.open().clone(), on.open().clone())
                       for name, (p, nm, op, on) in splits.items()},
            "knn": {case: {name: h.open().clone() for name, h in outs.items()}
                    for case, outs in knn.items()},
        }
    return world, got


# ------------------------------------------------------- the reduction ---


def test_bf16_all_reduce_sum_is_xla_s_psum(bf16_ranks):
    """The ranks' bf16 partials added in float32 in rank order and rounded
    once, as XLA's psum sums bf16 on the CPU mesh; added in bf16 rank by
    rank (the sequential form, one rounding an add) they would differ
    where W > 2."""
    world, got = bf16_ranks
    parts, total = got["reduce"]
    assert total.dtype == BF
    model = parts.float().sum(0).to(BF)
    assert torch.equal(total, model)
    sequential = parts[0].clone()
    for part in parts[1:]:
        sequential = sequential + part
    if world > 2:
        assert not torch.equal(sequential, model)


# ------------------------------------------------------------ the ring ---


@pytest.fixture(scope="module")
def jax_rings():
    """grid_tpu's bf16 ring on its virtual devices, per (W, payload_ring)."""
    values, mask, reads, reads_valid = cohort()
    hi, hw, hv = hap(N)
    done = {}

    def run(world, payload_ring):
        if (world, payload_ring) not in done:
            out = jax_sharded_cohort_step(
                cohort_mesh(world), jnp.asarray(values).astype(JBF), mask, reads, reads_valid,
                jnp.asarray(hi), jnp.asarray(hw).astype(JBF), jnp.asarray(hv),
                JCohortParams(**PARAMS), payload_ring=payload_ring)
            done[world, payload_ring] = jax.tree.map(np.asarray, out)
        return done[world, payload_ring]

    return run


@pytest.mark.parametrize("payload_ring", [True, False], ids=["payload_ring", "gather_payloads"])
def test_ring_equals_grid_tpu_s_bf16_sharded_step(bf16_ranks, jax_rings, payload_ring):
    """The port's bf16 ring against grid_tpu's bf16 ``sharded_cohort_step``:
    z, z_mask, the column statistics (counts past 256 rows, summed exact),
    the ratios, the scales and the region masks bitwise; the lists equal
    but for the order of exact ties; the distances bitwise where the lists
    agree; dipCN (float64) within 1e-9 where the input sets agree, fewer
    than 1% of the rows apart; step 7 (float64) within 1e-9."""
    world, got = bf16_ranks
    got = got["ring"][payload_ring]
    want = jax_rings(world, payload_ring)
    for name in ("z", "z_mask", "col_means", "col_vars", "var_ratio", "scales",
                 "region_selected", "region_used", "r_use", "dipcn_valid", "phased"):
        bits_equal(getattr(got, name), getattr(want, name), name)
    assert got.z.dtype == got.col_means.dtype == got.nbr_sq_dists.dtype == BF
    idx, want_idx = got.nbr_idx[:N].numpy(), want.nbr_idx[:N]
    d, want_d = host(got.nbr_sq_dists[:N]), host(want.nbr_sq_dists[:N])
    apart = neighbor_rows_differing(idx, d, want_idx, want_d, tol=0)
    same = np.ones(N, bool)
    same[apart] = False
    np.testing.assert_array_equal(d[same], want_d[same])
    values, mask, reads, reads_valid = cohort()
    sets = dipcn_sets_differ(idx, want_idx, reads_valid & want.z_mask[:N].any(axis=1), N_NBR)
    assert sets.sum() < 0.01 * N, sets.sum()
    ok = want.dipcn_valid[:N] & ~sets
    assert ok.sum() > 0.9 * N
    np.testing.assert_allclose(host(got.dipcn[:N])[ok], host(want.dipcn[:N])[ok], rtol=1e-9)
    for name in ("hap_irrs", "hap_imp", "mean_irrs"):
        g, w = host(getattr(got, name)), host(getattr(want, name))
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        np.testing.assert_allclose(g[~np.isnan(w)], w[~np.isnan(w)], rtol=1e-9)


@pytest.mark.parametrize("payload_ring", [True, False], ids=["payload_ring", "gather_payloads"])
def test_ring_never_rounds_the_reads_or_its_dipcn(bf16_ranks, payload_ring):
    """The ring's dipCN and step 7 are float64, as the reads are: dipCN
    rounded to bf16 (or its weights) would sit on the bf16 grid, and the
    haplotype values with it."""
    _, got = bf16_ranks
    got = got["ring"][payload_ring]
    assert got.dipcn.dtype == got.hap_irrs.dtype == got.hap_imp.dtype == F64
    dip = got.dipcn[:N][got.dipcn_valid[:N]]
    off_grid = dip != dip.to(BF).to(F64)
    assert off_grid.float().mean() > 0.9
    # dipCN from the reads in float64: the weights as the flat float64 step
    # takes them, reads / scales, not rounded
    values, mask, reads, reads_valid = cohort()
    scales = got.scales[:N].to(F64).numpy()
    usable = reads_valid & got.z_mask[:N].numpy().any(axis=1)
    idx = got.nbr_idx[:N].numpy()
    w = np.where(usable, reads, 0) / np.where(scales == 0, 1, scales)
    rows = np.where(got.dipcn_valid[:N].numpy())[0][:50]
    for i in rows:
        take = [j for j in idx[i] if usable[j]][:N_NBR]
        want = (reads[i] / scales[i]) / np.mean(w[take])
        np.testing.assert_allclose(float(got.dipcn[i]), want, rtol=1e-9)


def test_ring_keeps_the_ranks_partials_rounding_not_the_flat_step_s(bf16_ranks):
    """The ring's column sums round each rank's partial first (grid_tpu's
    ring): held above to grid_tpu bitwise. Here: the partials' rounding is
    why it differs from the flat bf16 step in some columns on this cohort,
    and the counts past 256 rows are exact (the flat step's)."""
    world, got = bf16_ranks
    ring = got["ring"][True]
    values, mask, reads, reads_valid = cohort()
    flat = cohort_step(*inputs_to_torch(values, mask, reads, reads_valid, *hap(N), "cpu", BF,
                                        F64), CohortParams(**PARAMS))
    assert (mask.sum(0) > 256).all()
    apart = int((ring.col_means != flat.col_means).sum() + (ring.col_vars != flat.col_vars).sum())
    print(f"W={world}: {apart} of {2 * R} column statistics off the flat bf16 step")
    assert_close_to_max(host(ring.col_means), host(flat.col_means), BF16_RTOL)
    assert_close_to_max(host(ring.col_vars), host(flat.col_vars), 2 * BF16_RTOL)


# ----------------------------------------------------- the gather form ---


@pytest.fixture(scope="module")
def jax_autos():
    done = {}

    def run(world):
        if world not in done:
            values, mask, reads, reads_valid, hi, hw, hv, row_valid = padded(world)
            mesh = cohort_mesh(world)
            vals, msk, rds, rdv, rv = jax_shard_cohort_inputs(
                mesh, jnp.asarray(values[:N]).astype(JBF), mask[:N], reads[:N],
                reads_valid[:N])
            out = jax_auto_sharded_cohort_step(mesh, JCohortParams(**PARAMS))(
                vals, msk, rds, rdv, jnp.asarray(hi), jnp.asarray(hw).astype(JBF),
                jnp.asarray(hv), rv)
            done[world] = jax.tree.map(np.asarray, out)
        return done[world]

    return run


def _hold_gather_form(got, want, label):
    """The gather form against a flat bf16 step (grid_tpu's or the port's):
    every field at the bf16 rule, the lists under the tie rule at tol 0,
    dipCN where the input sets agree. Returns {field: entries apart}."""
    apart = {}
    for name in ("z", "col_means", "col_vars", "var_ratio", "scales", "z_mask",
                 "region_selected", "region_used", "dipcn_valid"):
        apart[name] = bf16_close(getattr(got, name)[:N] if name in ("z", "z_mask", "scales",
                                                                     "dipcn_valid")
                                 else getattr(got, name),
                                 getattr(want, name)[:N] if name in ("z", "z_mask", "scales",
                                                                     "dipcn_valid")
                                 else getattr(want, name), f"{label} {name}")
    assert int(got.r_use) == int(want.r_use)
    idx, want_idx = host(got.nbr_idx[:N]), host(want.nbr_idx[:N])
    rows = neighbor_rows_differing(idx, host(got.nbr_sq_dists[:N]), want_idx,
                                   host(want.nbr_sq_dists[:N]), tol=0)
    apart["list rows"] = len(rows)
    apart["nbr_sq_dists"] = bf16_close(got.nbr_sq_dists[:N], want.nbr_sq_dists[:N],
                                       f"{label} nbr_sq_dists")
    _, _, reads, reads_valid = cohort()
    usable = reads_valid & host(want.z_mask[:N]).any(axis=1)
    sets = dipcn_sets_differ(idx, want_idx, usable, N_NBR)
    apart["dipcn set rows"] = int(sets.sum())
    ok = host(want.dipcn_valid[:N]) & ~sets
    apart["dipcn"] = bf16_close(host(got.dipcn[:N])[ok], host(want.dipcn[:N])[ok],
                                f"{label} dipcn")
    return apart


def test_gather_form_equals_grid_tpu_s_auto_sharded_step(bf16_ranks, jax_autos):
    """grid_tpu's gather form is its flat bf16 step bit for bit; the
    port's, whose ranks add their float32 partials before they round, is
    held to it at the bf16 rule, the entries apart counted (printed)."""
    world, got = bf16_ranks
    apart = _hold_gather_form(got["auto"], jax_autos(world), "grid_tpu")
    print(f"W={world}: entries apart from grid_tpu's gather form: {apart}")
    assert got["auto"].dipcn.dtype == BF and got["auto"].hap_irrs.dtype == F64


def test_gather_form_equals_the_port_s_flat_bf16_panel_step(bf16_ranks):
    """The port's own flat bf16 step on the panel branch, on the same
    padded inputs: the same kernels row for row, so apart from a column
    statistic that rounds one ulp otherwise (and what follows from it),
    the same bits (counted, printed)."""
    world, got = bf16_ranks
    *inputs, row_valid = padded(world)
    flat = cohort_step(*inputs_to_torch(*inputs, "cpu", BF, F64),
                       CohortParams(**PARAMS, d2_budget_bytes=0),
                       row_valid=torch.as_tensor(row_valid))
    apart = _hold_gather_form(got["auto"], flat, "flat")
    print(f"W={world}: entries apart from the port's flat bf16 panel step: {apart}")
    g, w = host(got["auto"].hap_irrs), host(flat.hap_irrs)
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))


def test_gather_split_of_bf16_splits(bf16_ranks):
    """The card's bf16 P ([1, N, R_pad]) and the CPU's ([N, R]) gathered in
    rank order are the whole split, in bf16, bit for bit."""
    _, got = bf16_ranks
    for name, (p, norms, got_p, got_norms) in got["splits"].items():
        assert got_p.dtype == got_norms.dtype == BF, name
        assert got_p.shape == p.shape, name
        assert torch.equal(got_p, p) and torch.equal(got_norms, norms), name


@pytest.mark.parametrize("case", sorted(KNN_CASES))
def test_ring_merge_on_bf16_rows_equals_grid_tpu_s(bf16_ranks, case):
    """The ring kNN on a bf16 prepared z: each merge takes rows of k + B
    columns; the lists (exact ties and finfo(bf16).max sentinels included,
    broken by position as lax.top_k breaks them), the bf16 distances and
    the carried float64 payloads equal grid_tpu's bf16 ring_knn's."""
    world, got = bf16_ranks
    got = got["knn"][case]
    z, valid, w, usable, k = knn_inputs(case)
    n = z.shape[0]
    mesh = cohort_mesh(world)

    def pad(a, fill=0):
        return jax_pad_rows(np.asarray(a), world, fill=fill)[0]

    d, idx, cw, cu = (np.asarray(x) for x in jax_ring_knn(
        jnp.asarray(pad(z)).astype(JBF), k, mesh, row_valid=jnp.asarray(pad(valid, False)),
        payloads=(jnp.asarray(pad(w)), jnp.asarray(pad(usable, False)))))
    assert got["d"].dtype == BF
    bits_equal(got["d"], d, "d")
    np.testing.assert_array_equal(got["idx"].numpy(), idx)
    np.testing.assert_array_equal(got["w"].numpy(), cw)
    np.testing.assert_array_equal(got["usable"].numpy(), cu)
    assert (got["widest"].numpy() == k + block_rows(n, world)).all()
    big = float(torch.finfo(BF).max)
    if case == "sentinels":
        assert (host(got["d"][:n])[:, -1] == big).all()


# ------------------------------------------------------- the stager ---


@pytest.fixture(scope="module")
def files_cohort(tmp_path_factory):
    return make_synthetic_cohort(tmp_path_factory.mktemp("bf16_staged"), n_samples=11, seed=7,
                                 missing_frac=0.05)


@pytest.fixture(scope="module", params=[2, 3], ids=lambda w: f"W{w}")
def staged_bf16(request, files_cohort, tmp_path_factory):
    """One spawn of W gloo ranks staging every case in bf16."""
    world = request.param
    out = tmp_path_factory.mktemp(f"bf16_stage_w{world}")
    cases = [(name, shares(samples, world), lo, hi, BF)
             for name, (samples, lo, hi) in ARRAY_CASES.items()]
    cases.append(("files", [("files", part) for part in shares(file_pairs(files_cohort), world)],
                  10, 100, BF))
    with RankWorkspace() as ws:
        run_ranks(torch_ranks.stage_rank, world, (cases, str(out)), platform="cpu",
                  workspace=ws)
    return world, out


@pytest.mark.parametrize("name", sorted(ARRAY_CASES) + ["files"])
def test_bf16_sharded_stage_equals_grid_tpu_s(staged_bf16, files_cohort, name):
    """The bf16 buffers hold the depths rounded once (by way of float32, as
    ml_dtypes' cast rounds grid_tpu's buffer): bitwise grid_tpu's
    ``stage_cohort_sharded(dtype=bfloat16)``, with the mask, row validity,
    regions, chromosomes, sample IDs and rows."""
    world, out = staged_bf16
    if name == "files":
        source = jax_bed_source(files_cohort["work_dir"], files_cohort["ids"])
        lo, hi = 10, 100
    else:
        samples, lo, hi = ARRAY_CASES[name]
        source = lambda: iter(samples)  # noqa: E731
    want = jax_stage_cohort_sharded(source, cohort_mesh(world), lo, hi, dtype=JBF)
    got = load(out, name, world)
    assert np.asarray(want.values).dtype.name == "bfloat16"
    bits_equal(got["values"], want.values, "values")
    np.testing.assert_array_equal(got["mask"], np.asarray(want.mask))
    np.testing.assert_array_equal(got["row_valid"], np.asarray(want.row_valid))
    np.testing.assert_array_equal(got["regions"], want.regions)
    np.testing.assert_array_equal(got["sample_rows"], np.asarray(want.sample_rows))
    assert got["chroms"] == want.chroms and got["sample_ids"] == want.sample_ids


STAGE_WORLD = 3


def test_bf16_staged_step_is_the_ring_from_host_arrays(tmp_path):
    """``staged_sharded_cohort_step`` in bf16 (each rank stages its share in
    bf16) is bitwise ``sharded_cohort_step`` in bf16 on the staged host
    arrays, in every field; its reads and dipCN stay float64."""
    cohort = make_synthetic_cohort(tmp_path, n_samples=13, seed=3)
    ids = sorted(cohort["ids"])
    n = len(ids)
    reads = np.random.default_rng(0).integers(500, 900, n).astype(np.float64)
    hi, hw, hv = pad_hap_neighbors([[((h + 2) % (2 * n), 1.0)] for h in range(2 * n)], 1,
                                   dtype=np.float64)
    params = CohortParams(num_neighbors=5, n_nbr=3, n_iters=10)
    stage, got = staged_sharded_cohort_step(
        STAGE_WORLD, cohort["work_dir"], cohort["ids"], dict(zip(ids, reads)), hi, hw, hv, params,
        10, 100, platform="cpu", dtype=BF)
    host_stage = jax_stage_cohort_sharded(jax_bed_source(cohort["work_dir"], cohort["ids"]),
                                          cohort_mesh(STAGE_WORLD), 10, 100, dtype=np.float64)
    want = sharded_cohort_step(STAGE_WORLD, np.asarray(host_stage.values)[:n],
                               np.asarray(host_stage.mask)[:n], reads, np.ones(n, bool), hi, hw,
                               hv, params, platform="cpu", dtype=BF)
    assert got.z.dtype == BF and got.dipcn.dtype == F64
    for name in CohortOutputs._fields:
        g, w = getattr(got, name), getattr(want, name)
        if name in ("z", "z_mask", "scales", "nbr_idx", "nbr_sq_dists", "dipcn", "dipcn_valid"):
            g, w = g[:n], w[:n]
        assert g.dtype == w.dtype, name
        assert torch.equal(g, w) or torch.equal(torch.isnan(g), torch.isnan(w)) and torch.equal(
            g[~torch.isnan(g)], w[~torch.isnan(w)]), name


# ------------------------------------------------------- the pipeline ---

ARTIFACTS = {
    "normalized": "mosdepth_results_normalized.tsv.gz",
    "neighbors": "neighbor_coverage.zMax2.0.tsv.gz",
    "dipcn": "diploid_genotypes.tsv",
    "haploid": "haploid_genotypes.tsv",
}


def content(path) -> bytes:
    return gzip.open(path).read() if str(path).endswith(".gz") else path.read_bytes()


def run_config(wgs, out, device):
    cfg = copy.deepcopy(wgs["config"])
    out.mkdir(parents=True, exist_ok=True)
    cfg["output_dir"] = str(out)
    cfg["device"] = dict(device)
    (out / "read_counts.tsv").write_bytes(wgs["counts_file"].read_bytes())
    return cfg


def neighbor_lists(out, ids):
    row = {s: i for i, s in enumerate(ids)}
    nbrs, _ = read_neighbors(out / ARTIFACTS["neighbors"])
    return (np.array([[row[m] for m, _, _ in nbrs[s]] for s in ids]),
            np.array([[dist for _, _, dist in nbrs[s]] for s in ids], np.float64))


@pytest.fixture(scope="module")
def wgs(tmp_path_factory):
    return make_synthetic_cohort(tmp_path_factory.mktemp("bf16_mesh_cohort"), n_samples=15,
                                 seed=21, missing_frac=0.02)


RING_BF16 = {"fused": True, "mesh_shape": [4], "dispatch": "ring", "dtype": "bfloat16"}


def test_fused_ring_config_in_bf16_matches_grid_tpu_s_run(wgs, tmp_path):
    """``mesh_shape: [4]``, ``dispatch: ring``, bf16: four gloo ranks write
    the four artifacts; grid_tpu's run of the same config takes its ring on
    its virtual devices (its ring phases in float64, so nothing falls back).
    The normalized matrix: z and the scales bitwise as written, the ratio
    header within a %.3f digit of the bf16 contract (grid_tpu's writer
    divides its bf16 arrays in bf16, the port's its float32 copies); the
    neighbor lists equal but for the order of exact ties; dipCN, written
    from float64 in both, within 1e-9; the haploid table's cells within
    1e-9."""
    port = run_config(wgs, tmp_path / "torch", {**RING_BF16, "platform": "cpu"})
    timings = run_wgs_pipeline(console=None, config=port)
    assert "fused_steps_4_7" in timings and "fused.device" in timings
    ref = run_config(wgs, tmp_path / "jax", RING_BF16)
    jax_timings = jax_pipeline.run_wgs_pipeline(console=None, config=ref)
    assert "fused_steps_4_7" in jax_timings  # grid_tpu ran its fused ring, no fallback
    t, j = tmp_path / "torch", tmp_path / "jax"
    ids, ratio, z, scales = read_normalized_data(t / ARTIFACTS["normalized"])
    j_ids, j_ratio, j_z, j_scales = read_normalized_data(j / ARTIFACTS["normalized"])
    assert ids == j_ids and scales == j_scales
    np.testing.assert_array_equal(np.isnan(z), np.isnan(j_z))
    np.testing.assert_array_equal(np.nan_to_num(z), np.nan_to_num(j_z))
    assert_close_to_max(ratio, j_ratio, BF16_RTOL)
    got_idx, got_d = neighbor_lists(t, ids)
    want_idx, want_d = neighbor_lists(j, ids)
    neighbor_rows_differing(got_idx, got_d, want_idx, want_d, tol=0)
    d_ids, d_vals, _ = read_dipcn(t / ARTIFACTS["dipcn"])
    w_ids, w_vals, _ = read_dipcn(j / ARTIFACTS["dipcn"])
    assert d_ids == w_ids and len(d_ids) > 0
    np.testing.assert_allclose(d_vals, w_vals, rtol=1e-9, atol=0)

    def cells(path):
        lines = path.read_text().splitlines()
        return lines[0], np.array([[float(x) for x in ln.split("\t")[1:]] for ln in lines[1:]])

    (g_head, g_cells), (w_head, w_cells) = (cells(d / ARTIFACTS["haploid"]) for d in (t, j))
    assert g_head == w_head
    np.testing.assert_allclose(g_cells, w_cells, rtol=1e-9, atol=1e-12)


def test_file_mode_with_mesh_shape_in_bf16_is_file_mode_in_bf16(wgs, tmp_path):
    """File mode reads no ``mesh_shape`` (nor do grid_tpu's file steps):
    in bf16 with ``mesh_shape: [2]`` it writes the four artifacts of bf16
    file mode without it, byte for byte."""
    for name, device in (("mesh", {"dtype": "bfloat16", "mesh_shape": [2], "platform": "cpu"}),
                         ("flat", {"dtype": "bfloat16", "platform": "cpu"})):
        run_wgs_pipeline(console=None, config=run_config(wgs, tmp_path / name, device))
    for artifact in ARTIFACTS.values():
        assert content(tmp_path / "mesh" / artifact) == content(tmp_path / "flat" / artifact), \
            artifact
