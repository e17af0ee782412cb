"""The port's gather form of the sharded step (``auto_sharded_cohort_step``)
against grid_tpu's, on gloo ranks on the CPU.

grid_tpu's ``auto_sharded_cohort_step`` jits the single-device step with
cohort shardings on ``cohort_mesh(W)`` (the conftest's 8 virtual CPU
devices); the port's runs W spawned ranks, each normalizing its block,
all-gathering the split of its prepared rows and taking its own rows
through the flat panel loop. float64, N = 31 (no W of 2, 3 or 4 divides
it): dipCN within 1e-9, neighbor lists equal, z within 1e-9 of max|z|,
padding rows never neighbors. Then the loop itself on quantized z, where
every distance is exact in float64: the gathered split is the whole z's,
and the lists (exact ties included) and dipCN equal the flat panel
branch's. The CPU's ``torch.mm`` promises no bitwise entries across panel
shapes on other data, so the bitwise check of continuous data belongs to
the card (``chip_smoke.py`` phase 16).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from grid_tpu.io.hap_neighbors import pad_hap_neighbors
from grid_tpu.models.cohort import CohortParams as JaxCohortParams
from grid_tpu.parallel.mesh import cohort_mesh
from grid_tpu.parallel.mesh import shard_cohort_inputs as jax_shard_cohort_inputs
from grid_tpu.parallel.pcohort import auto_sharded_cohort_step as jax_auto_sharded_cohort_step
from grid_tpu_torch.convert import inputs_to_torch, outputs_to_numpy
from grid_tpu_torch.models.cohort import CohortParams, cohort_step, panel_knn_dipcn
from grid_tpu_torch.ops.gpu_kernels import zprep_split
from grid_tpu_torch.parallel import auto_sharded_cohort_step, run_ranks
from grid_tpu_torch.parallel.mesh import COUNTED, RankWorkspace, block_rows
from torch_parity import assert_close_to_max

N, R = 31, 16
PARAMS = dict(num_neighbors=4, n_nbr=4, n_iters=10, row_block=8)
SPANS = ("sharded.normalize", "auto.gather", "auto.knn", "sharded.phase")


def step_inputs(world):
    """grid_tpu's test_auto_sharded_cohort_step_runs inputs, at N=31, with
    an empty sample and one without a read count, padded for ``world``."""
    rng = np.random.default_rng(17)
    values = rng.uniform(20, 60, size=(N, R))
    mask = rng.random((N, R)) > 0.1
    mask[6] = False
    values *= mask
    reads = rng.integers(500, 2000, size=N).astype(float)
    reads_valid = np.ones(N, bool)
    reads_valid[9] = False
    n_pad = block_rows(N, world) * world
    hap = [[((h + 2) % (2 * N), 1.0)] for h in range(2 * N)] + [[]] * (2 * (n_pad - N))
    hi, hw, hv = pad_hap_neighbors(hap, 1, dtype=np.float64)

    def pad(a, fill=0):
        return np.concatenate([a, np.full((n_pad - N, *a.shape[1:]), fill, a.dtype)])

    return (pad(values), pad(mask, False), pad(reads), pad(reads_valid, False), hi, hw, hv,
            np.arange(n_pad) < N)


@pytest.fixture(scope="module", params=[2, 3, 4], ids=lambda w: f"W{w}")
def auto_run(request):
    world = request.param
    args = step_inputs(world)
    reports = []
    got = outputs_to_numpy(auto_sharded_cohort_step(
        world, CohortParams(**PARAMS), platform="cpu", reports=reports)(*args))
    return world, args, got, reports


def test_gather_form_equals_grid_tpu_s_auto_sharded_step(auto_run):
    world, (values, mask, reads, reads_valid, hi, hw, hv, row_valid), got, _ = auto_run
    mesh = cohort_mesh(world)
    vals, msk, rds, rdv, rv = jax_shard_cohort_inputs(mesh, values[:N], mask[:N], reads[:N],
                                                      reads_valid[:N])
    want = jax_auto_sharded_cohort_step(mesh, JaxCohortParams(**PARAMS))(
        vals, msk, rds, rdv, jnp.asarray(hi), jnp.asarray(hw), jnp.asarray(hv), rv)
    want = type(got)._make(np.asarray(x) for x in want)
    assert got.z.shape == want.z.shape == values.shape
    assert_close_to_max(got.z, want.z, 1e-9)
    for name in ("col_means", "col_vars", "var_ratio", "scales", "hap_irrs", "hap_imp",
                 "mean_irrs"):
        assert_close_to_max(getattr(got, name), getattr(want, name), 1e-9)
    for name in ("z_mask", "region_selected", "region_used", "r_use", "dipcn_valid", "phased"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    ok = want.dipcn_valid
    assert ok[:N].sum() >= N - 3
    assert_close_to_max(got.dipcn[ok], want.dipcn[ok], 1e-9)
    np.testing.assert_array_equal(got.nbr_idx[:N], want.nbr_idx[:N])
    assert_close_to_max(got.nbr_sq_dists[:N], want.nbr_sq_dists[:N], 1e-9)


def test_gather_form_equals_the_flat_step(auto_run):
    """The port's own single-device step on the same padded inputs."""
    world, args, got, _ = auto_run
    *inputs, row_valid = args
    flat = outputs_to_numpy(cohort_step(*inputs_to_torch(*inputs, "cpu", torch.float64),
                                        CohortParams(**PARAMS),
                                        row_valid=torch.as_tensor(row_valid)))
    assert_close_to_max(got.z, flat.z, 1e-9)
    np.testing.assert_array_equal(got.region_used, flat.region_used)
    np.testing.assert_array_equal(got.dipcn_valid, flat.dipcn_valid)
    ok = flat.dipcn_valid
    assert_close_to_max(got.dipcn[ok], flat.dipcn[ok], 1e-9)
    np.testing.assert_array_equal(got.nbr_idx[:N], flat.nbr_idx[:N])


def test_padding_rows_never_become_neighbors(auto_run):
    world, args, got, _ = auto_run
    assert got.nbr_idx.shape == (block_rows(N, world) * world, PARAMS["num_neighbors"])
    assert (got.nbr_idx[:N] < N).all()
    assert not got.dipcn_valid[N:].any()
    # the empty sample (row 6) is no one's neighbor either
    assert not (got.nbr_idx[:N] == 6).any()


def test_each_rank_reports_the_four_spans_and_no_card_launch(auto_run):
    world, _, _, reports = auto_run
    assert len(reports) == world
    for rep in reports:
        assert all(rep[name] == 0 for name in COUNTED)  # plain versions on the CPU
        assert 0 < rep["start_seconds"] and 0 < rep["seconds"]
        for span in SPANS:
            assert rep[span] >= 0, span
        assert "sharded.ring" not in rep


def test_gather_form_wants_rows_a_multiple_of_the_ranks():
    args = step_inputs(4)  # 32 rows
    with pytest.raises(ValueError, match="multiple of world=3"):
        auto_sharded_cohort_step(3, CohortParams(**PARAMS), platform="cpu")(*args)


KNN_N, KNN_R, KNN_K, KNN_BLOCK = 60, 12, 9, 7  # 60 rows: W = 2, 3, 4 divide it


def knn_inputs():
    rng = np.random.default_rng(7)
    z = np.round(rng.normal(size=(KNN_N, KNN_R)) * 2) / 2  # every distance exact
    w = rng.uniform(0.1, 3.0, KNN_N)
    usable = rng.random(KNN_N) > 0.25
    valid = np.ones(KNN_N, bool)
    valid[-3:] = False  # padding-like rows, never neighbors
    return z, valid, w, usable


@pytest.fixture(scope="module", params=[2, 3, 4], ids=lambda w: f"W{w}")
def knn_run(request):
    """One spawn: each rank splits its block of the quantized z, gathers
    the split and takes its rows through the shared panel loop."""
    world = request.param
    z, valid, w, usable = knn_inputs()
    with RankWorkspace() as ws:
        outs = {"d": ws.empty((KNN_N, KNN_K), torch.float64),
                "idx": ws.empty((KNN_N, KNN_K), torch.int32),
                "dipcn": ws.empty((KNN_N,), torch.float64),
                "dipcn_valid": ws.empty((KNN_N,), torch.bool),
                "p": ws.empty((KNN_N, KNN_R), torch.float64),
                "norms": ws.empty((KNN_N,), torch.float64)}
        case = (ws.put(z), None, None, float("inf"), ws.put(valid), ws.put(w), ws.put(usable),
                KNN_K, 5, KNN_BLOCK, outs)
        run_ranks(torch_ranks.auto_knn_rank, world, ([case],), platform="cpu", workspace=ws)
        got = {name: h.open().numpy() for name, h in outs.items()}
    return world, got


def test_gathered_split_is_the_whole_z_s(knn_run):
    _, got = knn_run
    z = knn_inputs()[0]
    whole = zprep_split(torch.as_tensor(z), None, None, float("inf"))
    np.testing.assert_array_equal(got["p"], whole.p.numpy())
    np.testing.assert_array_equal(got["norms"], whole.norms.numpy())


def test_rank_rows_equal_the_flat_panel_branch_ties_included(knn_run):
    _, got = knn_run
    z, valid, w, usable = knn_inputs()
    t = [torch.as_tensor(a) for a in (z, valid, w, usable)]
    flat = panel_knn_dipcn(zprep_split(t[0], None, None, float("inf")), t[1], t[2], t[3],
                           CohortParams(num_neighbors=KNN_K, n_nbr=5, row_block=16))
    d, idx, dipcn, ok = (x.numpy() for x in flat)
    # quantized z: many exact ties, broken by the lower column in both
    assert (np.diff(d[:, :KNN_K], axis=1) == 0).any()
    np.testing.assert_array_equal(got["idx"], idx)
    np.testing.assert_array_equal(got["d"], d)
    np.testing.assert_array_equal(got["dipcn_valid"], ok)
    np.testing.assert_array_equal(got["dipcn"][ok], dipcn[ok])
    assert valid[got["idx"]].all()


# the split layouts gather_split takes: the card's float64 P as [1, N, R],
# its float32 TF32 halves as [2, N, R], and the CPU's P as [N, R]
SPLIT_LAYOUTS = {"f64-card": (torch.float64, (1,)), "f32-card": (torch.float32, (2,)),
                 "f64-cpu": (torch.float64, ())}


@pytest.fixture(scope="module")
def gathered_splits():
    """One spawn of 2 gloo ranks gathering a split of each layout."""
    rng = np.random.default_rng(11)
    n, r = 12, 5
    with RankWorkspace() as ws:
        cases, want = [], {}
        for name, (dtype, halves) in SPLIT_LAYOUTS.items():
            p = torch.tensor(rng.normal(size=(*halves, n, r)), dtype=dtype)
            norms = torch.tensor(rng.uniform(size=n), dtype=dtype)
            outs = (ws.empty(p.shape, dtype), ws.empty((n,), dtype))
            cases.append((ws.put(p), ws.put(norms), *outs))
            want[name] = (p, norms, outs)
        run_ranks(torch_ranks.gather_split_rank, 2, (cases,), platform="cpu", workspace=ws)
        return {name: (p, norms, outs[0].open().clone(), outs[1].open().clone())
                for name, (p, norms, outs) in want.items()}


@pytest.mark.parametrize("layout", list(SPLIT_LAYOUTS))
def test_gather_split_keeps_each_layout(gathered_splits, layout):
    """The ranks' splits gathered in rank order are the whole split, in its
    own layout and dtype: the float64 P of the card ([1, N, R]) is one half,
    not two (the gather form at ``device.dtype: float64``)."""
    p, norms, got_p, got_norms = gathered_splits[layout]
    assert got_p.dtype == p.dtype and got_p.shape == p.shape
    assert torch.equal(got_p, p) and torch.equal(got_norms, norms)
