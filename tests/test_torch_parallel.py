"""The port's sharded layer against grid_tpu's, on gloo ranks on the CPU.

The same numpy inputs, made from a seed, go through ``grid_tpu.parallel``
on the virtual 8-device CPU mesh (``tests/conftest.py``) and through
``grid_tpu_torch.parallel`` on W spawned ranks, in float64. Bounds: z,
the column statistics and dipCN within 1e-9 of the largest entry (the
port scales rows by the reciprocal mean where grid_tpu divides, and sums
in another order); neighbor indices equal, exact ties included (both rings
visit the blocks in one order); where two float64 routes may reorder a
near-tie, the rule of ``tests/torch_parity.py``. A spawn costs a few
seconds, so each fixture runs its cases in one spawn.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from grid_tpu.io.hap_neighbors import pad_hap_neighbors
from grid_tpu.parallel.mesh import cohort_mesh
from grid_tpu.parallel.mesh import pad_rows as jax_pad_rows
from grid_tpu.parallel.pcohort import sharded_cohort_step as jax_sharded_cohort_step
from grid_tpu.parallel.pknn import ring_knn as jax_ring_knn
from grid_tpu.parallel.pstats import normalize_cohort_sharded as jax_normalize_sharded
from grid_tpu_torch.convert import inputs_to_torch, outputs_to_numpy
from grid_tpu_torch.models.cohort import CohortParams, cohort_step
from grid_tpu_torch.ops.gpu_kernels import (
    SplitZ,
    zprep_gram_cross,
    zprep_gram_cross_plain,
    zprep_split,
)
from grid_tpu_torch.ops.knn import knn_squared
from grid_tpu_torch.ops.normalize import normalize_cohort, select_high_variance_mask
from grid_tpu_torch.parallel import RankFailure, run_ranks, sharded_cohort_step
from grid_tpu_torch.parallel.mesh import RankWorkspace, block_rows
from torch_parity import assert_close_to_max, neighbor_rows_differing

NORM_SHAPE = (23, 20)  # N not divisible by 2, 3 or 4
TIED = (5, 9)  # two exactly equal columns
EMPTY_ROW = 3  # a row with every cell masked
KNN_CASES = {"quantized": (64, 12, 9, True), "continuous": (40, 6, 5, False)}


def norm_inputs():
    rng = np.random.default_rng(13)
    n, r = NORM_SHAPE
    values = rng.uniform(20, 60, size=(n, r))
    mask = rng.random((n, r)) > 0.1
    values[:, TIED[1]], mask[:, TIED[1]] = values[:, TIED[0]], mask[:, TIED[0]]
    mask[EMPTY_ROW] = False
    return values * mask, mask


def knn_inputs(case):
    n, r, k, quantized = KNN_CASES[case]
    rng = np.random.default_rng(7 if quantized else 8)
    z = rng.normal(size=(n, r))
    if quantized:
        z = np.round(z * 2) / 2  # every distance exact in float64: many exact ties
    w = rng.uniform(0.1, 3.0, n)
    usable = rng.random(n) > 0.25
    valid = np.ones(n, bool)
    valid[-3:] = False  # padding-like rows, never neighbors
    return z, valid, w, usable, k


def padded(a, world, fill=0):
    return jax_pad_rows(np.asarray(a), world, fill=fill)[0]


@pytest.fixture(scope="module", params=[2, 3, 4], ids=lambda w: f"W{w}")
def ranks_run(request):
    """One spawn of W gloo ranks: the sharded normalize and the ring kNN
    cases, written into shared tensors."""
    world = request.param
    values, mask = norm_inputs()
    n, r = NORM_SHAPE
    n_pad = block_rows(n, world) * world
    with RankWorkspace() as ws:
        norm_out = {"z": ws.empty((n_pad, r), torch.float64),
                    "mask": ws.empty((n_pad, r), torch.bool),
                    "row_means_raw": ws.empty((n_pad,), torch.float64),
                    "col_means": ws.empty((r,), torch.float64),
                    "col_vars": ws.empty((r,), torch.float64),
                    "var_ratio": ws.empty((r,), torch.float64),
                    "scale": ws.empty((), torch.float64),
                    "selected": ws.empty((r,), torch.bool)}
        norm_cases = [(ws.put(values), ws.put(mask), norm_out)]
        knn_cases, knn_out = [], {}
        for case in KNN_CASES:
            z, valid, w, usable, k = knn_inputs(case)
            kn_pad = block_rows(z.shape[0], world) * world
            outs = {"d": ws.empty((kn_pad, k), torch.float64),
                    "idx": ws.empty((kn_pad, k), torch.int32),
                    "w": ws.empty((kn_pad, k), torch.float64),
                    "usable": ws.empty((kn_pad, k), torch.bool),
                    "widest": ws.empty((world,), torch.int64)}
            knn_cases.append((ws.put(z), ws.put(valid), ws.put(w), ws.put(usable), k, outs))
            knn_out[case] = outs
        reports = run_ranks(torch_ranks.both_rank, world, (norm_cases, knn_cases),
                            platform="cpu", workspace=ws)
        got = {name: h.open().numpy() for name, h in norm_out.items()}
        knn = {case: {name: h.open().numpy() for name, h in outs.items()}
               for case, outs in knn_out.items()}
    return world, got, knn, reports


def test_sharded_normalize_equals_grid_tpu_s_and_the_flat_one(ranks_run):
    world, got, _, reports = ranks_run
    values, mask = norm_inputs()
    n = values.shape[0]
    want = jax_normalize_sharded(jnp.asarray(padded(values, world)),
                                 jnp.asarray(padded(mask, world, False)), cohort_mesh(world),
                                 n_rows=n)
    flat = normalize_cohort(torch.as_tensor(values), torch.as_tensor(mask))
    for name in ("z", "row_means_raw"):
        assert_close_to_max(got[name], np.asarray(getattr(want, name)), 1e-9)
        assert_close_to_max(got[name][:n], getattr(flat, name).numpy(), 1e-9)
    np.testing.assert_array_equal(got["mask"], np.asarray(want.mask))
    assert not got["mask"][EMPTY_ROW].any() and np.isnan(got["row_means_raw"][EMPTY_ROW])
    for name in ("col_means", "col_vars", "var_ratio", "scale"):
        assert_close_to_max(got[name], np.asarray(getattr(want, name)), 1e-9)
        assert_close_to_max(got[name], getattr(flat, name).numpy(), 1e-9)
    assert [rep["masked_column_stats"] for rep in reports] == [0] * world  # plain on the CPU


def test_sharded_normalize_keeps_exactly_tied_columns_tied(ranks_run):
    """The partial sums are added in rank order for every column, so two
    equal columns stay bitwise equal, and the strict > of the selection
    keeps both or neither, as grid_tpu's and the flat step's do."""
    world, got, _, _ = ranks_run
    values, mask = norm_inputs()
    a, b = TIED
    for name in ("col_means", "col_vars", "var_ratio"):
        assert got[name][a] == got[name][b], name
    want = jax_normalize_sharded(jnp.asarray(padded(values, world)),
                                 jnp.asarray(padded(mask, world, False)), cohort_mesh(world),
                                 n_rows=values.shape[0])
    from grid_tpu.ops.normalize import select_high_variance_mask as jax_select

    flat = normalize_cohort(torch.as_tensor(values), torch.as_tensor(mask))
    np.testing.assert_array_equal(got["selected"], np.asarray(jax_select(want.var_ratio)))
    np.testing.assert_array_equal(got["selected"], select_high_variance_mask(flat.var_ratio))
    assert got["selected"][a] == got["selected"][b]


def jax_ring(case, world):
    z, valid, w, usable, k = knn_inputs(case)
    out = jax_ring_knn(jnp.asarray(padded(z, world)), k, cohort_mesh(world),
                       row_valid=jnp.asarray(padded(valid, world, False)),
                       payloads=(jnp.asarray(padded(w, world)),
                                 jnp.asarray(padded(usable, world, False))))
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("case", sorted(KNN_CASES))
def test_ring_knn_equals_grid_tpu_s(ranks_run, case):
    world, _, knn, _ = ranks_run
    got = knn[case]
    d, idx, cw, cu = jax_ring(case, world)
    z, valid, w, usable, k = knn_inputs(case)
    n = z.shape[0]
    if KNN_CASES[case][3]:  # exact distances: equal lists, exact ties included
        np.testing.assert_array_equal(got["idx"], idx)
        np.testing.assert_array_equal(got["d"], d)
    else:
        assert_close_to_max(got["d"], d, 1e-9)
        neighbor_rows_differing(got["idx"][:n], got["d"][:n], idx[:n], d[:n],
                                tol=1e-9 * d[:n, -1])
    np.testing.assert_array_equal(got["w"], cw)
    np.testing.assert_array_equal(got["usable"], cu)


@pytest.mark.parametrize("case", sorted(KNN_CASES))
def test_ring_knn_payloads_are_a_gather_at_the_indices(ranks_run, case):
    """The carried payloads equal the payload vectors gathered at the
    returned indices, and no invalid row is ever a neighbor (the twin of
    tests/test_parallel.py's payload test)."""
    world, _, knn, _ = ranks_run
    got = knn[case]
    z, valid, w, usable, k = knn_inputs(case)
    n = z.shape[0]
    idx = got["idx"][:n]
    np.testing.assert_array_equal(got["w"][:n], w[idx])
    np.testing.assert_array_equal(got["usable"][:n], usable[idx])
    assert valid[idx].all()
    # and the lists are the flat kNN's but for ties (the ring breaks exact
    # ties by visit order, the flat selection by column)
    flat_d, flat_i = knn_squared(torch.as_tensor(z), k, row_valid=torch.as_tensor(valid),
                                 row_block=16)
    neighbor_rows_differing(idx[valid], got["d"][:n][valid], flat_i.numpy()[valid],
                            flat_d.numpy()[valid], tol=1e-9 * flat_d.numpy()[valid, -1])


def test_ring_never_holds_a_row_of_all_n_columns(ranks_run):
    """Structure canary (twin of tests/test_parallel.py's): every merge
    takes the running k and one visiting block, never a row of N."""
    world, _, knn, _ = ranks_run
    for case, got in knn.items():
        n, _, k, _ = KNN_CASES[case]
        b = block_rows(n, world)
        assert (got["widest"] == k + b).all(), case
        assert k + b < n


HAP_K = 2


def step_inputs():
    rng = np.random.default_rng(31)
    n, r = 22, 30
    values = rng.uniform(20, 60, size=(n, r))
    mask = rng.random((n, r)) > 0.1
    mask[5] = False  # a sample with no valid cell
    reads = rng.integers(500, 2000, size=n).astype(float)
    reads_valid = np.ones(n, dtype=bool)
    reads_valid[7] = False  # a sample without a read count
    hap = [[((h + 2) % (2 * n), 1.0), ((h + 5) % (2 * n), 0.7)] for h in range(2 * n)]
    hi, hw, hv = pad_hap_neighbors(hap, HAP_K, dtype=np.float64)
    params = CohortParams(num_neighbors=6, n_nbr=6, n_iters=40, row_block=8)
    return (values * mask, mask, reads, reads_valid, hi, hw, hv), params


STEP_WORLD = 4


@pytest.fixture(scope="module", params=[True, False], ids=["payload_ring", "gather"])
def step_run(request):
    args, params = step_inputs()
    reports = []
    got = outputs_to_numpy(sharded_cohort_step(STEP_WORLD, *args, params,
                                               payload_ring=request.param, platform="cpu",
                                               reports=reports))
    want = jax_sharded_cohort_step(cohort_mesh(STEP_WORLD), *args, params,
                                   payload_ring=request.param)
    return got, type(got)._make(np.asarray(x) for x in want), reports


def test_sharded_cohort_step_equals_grid_tpu_s(step_run):
    got, want, reports = step_run
    assert len(reports) == STEP_WORLD
    n = 22
    for name in ("z", "col_means", "col_vars", "var_ratio", "scales", "dipcn", "hap_irrs",
                 "hap_imp", "mean_irrs"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.shape == w.shape, name
        if name in ("dipcn",):
            ok = want.dipcn_valid
            g, w = g[ok], w[ok]
        assert_close_to_max(g, w, 1e-9)
    for name in ("z_mask", "region_selected", "region_used", "r_use", "dipcn_valid", "phased"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    np.testing.assert_array_equal(got.nbr_idx[:n], want.nbr_idx[:n])
    assert_close_to_max(got.nbr_sq_dists[:n], want.nbr_sq_dists[:n], 1e-9)


def test_sharded_cohort_step_equals_the_flat_step(step_run):
    """The twin of tests/test_parallel.py's fused-step test: the port's
    sharded step against its own single-device step."""
    got, _, _ = step_run
    args, params = step_inputs()
    flat = outputs_to_numpy(cohort_step(*inputs_to_torch(*args, "cpu", torch.float64), params))
    n = 22
    np.testing.assert_array_equal(got.dipcn_valid[:n], flat.dipcn_valid)
    ok = flat.dipcn_valid
    assert_close_to_max(got.dipcn[:n][ok], flat.dipcn[ok], 1e-9)
    assert_close_to_max(got.z[:n], flat.z, 1e-9)
    neighbor_rows_differing(got.nbr_idx[:n], got.nbr_sq_dists[:n], flat.nbr_idx,
                            flat.nbr_sq_dists, tol=1e-9 * flat.nbr_sq_dists[:, -1])
    nan = np.isnan(flat.hap_irrs)
    np.testing.assert_array_equal(np.isnan(got.hap_irrs), nan)
    assert_close_to_max(got.hap_irrs[~nan], flat.hap_irrs[~nan], 1e-9)


def test_a_rank_that_raises_makes_the_parent_raise_and_leaves_nothing(tmp_path, monkeypatch):
    import tempfile

    import grid_tpu_torch.parallel.pcohort as pcohort

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setattr(pcohort, "_rank_step", torch_ranks.rank_step_failing_on_rank_1)
    args, params = step_inputs()
    with pytest.raises(RankFailure, match="rank 1 fails on purpose"):
        sharded_cohort_step(2, *args, params, platform="cpu")
    # the workspace (shared tensors, the store, the ranks' error files) is gone
    assert not list(tmp_path.glob("grid_tpu_torch_ranks_*"))


def test_zprep_gram_cross_plain_is_p_a_p_b_t():
    rng = np.random.default_rng(3)
    pa, pb = torch.as_tensor(rng.normal(size=(7, 5))), torch.as_tensor(rng.normal(size=(4, 5)))
    a, b = SplitZ(pa, (pa * pa).sum(1)), SplitZ(pb, (pb * pb).sum(1))
    before = zprep_gram_cross.launches
    want = pa @ pb.T
    assert torch.equal(zprep_gram_cross_plain(a, b), want)
    # the wrapper takes the plain version for CPU tensors and counts nothing
    assert torch.equal(zprep_gram_cross(a, b, 7, 0), want)
    assert zprep_gram_cross.launches == before
    # the split's prepared rows and norms feed it as the ring feeds it
    split = zprep_split(pa, None, None, float("inf"))
    assert torch.equal(zprep_gram_cross(split, split), pa @ pa.T)


_ENV_INIT = r"""
import os, socket, sys
import torch, torch.distributed as dist
from grid_tpu_torch.parallel.mesh import CohortGroup, init_distributed

with socket.socket() as s:  # a free port on this host, as torchrun would pick one
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
init_distributed(1, 0, "gloo")  # no FileStore path: env://, as under torchrun
group = CohortGroup(1, 0, torch.device("cpu"), "gloo")
t = torch.arange(6, dtype=torch.float64).reshape(2, 3)
assert torch.equal(group.all_reduce_sum(t), t)
assert torch.equal(group.all_gather_rows(t), t)
assert group.ring_shift([t])[0] is t
dist.destroy_process_group()
print("env init ok")
"""


def test_init_distributed_takes_env_without_a_store_path():
    """A process started by torchrun joins through env:// (the port's own
    ranks always get a FileStore path); the collectives of one rank give
    their input back."""
    import subprocess
    import sys
    from pathlib import Path

    proc = subprocess.run([sys.executable, "-c", _ENV_INIT], capture_output=True, text=True,
                          timeout=120, cwd=Path(__file__).resolve().parent.parent)
    assert proc.returncode == 0, proc.stderr
    assert "env init ok" in proc.stdout
