"""The port's sharded stager against grid_tpu's, on gloo ranks on the CPU.

``grid_tpu_torch.io.staging.stage_cohort_sharded`` runs inside W spawned
ranks, each streaming its own contiguous share of the samples (the layout
of the JAX package's single process on a W-device mesh, the padding last);
``grid_tpu.io.staging.stage_cohort_sharded`` runs in this process on
``cohort_mesh(W)`` (the conftest's 8 virtual CPU devices). The stage is
held to it bitwise, in float64 and float32: values, mask, row validity,
regions, chromosomes, sample IDs and rows. The cases are those of
``tests/test_staging_sharded.py``, plus uneven shares (the layout of
``tests/test_multihost.py``'s two processes) and the three end mismatches.
A spawn costs a few seconds, so each W stages every case in one spawn.
"""

import json

import numpy as np
import pytest
import torch

import torch_ranks
from grid_tpu.io.hap_neighbors import pad_hap_neighbors
from grid_tpu.io.staging import bed_source as jax_bed_source
from grid_tpu.io.staging import stage_cohort_sharded as jax_stage_cohort_sharded
from grid_tpu.parallel.mesh import cohort_mesh
from grid_tpu.synth import make_synthetic_cohort
from grid_tpu_torch.convert import outputs_to_numpy
from grid_tpu_torch.io.bed import map_bed_gz_to_samples
from grid_tpu_torch.io.staging import ShardedCohortStage, bed_source, stage_cohort
from grid_tpu_torch.models.cohort import CohortParams
from grid_tpu_torch.parallel import (
    RankFailure,
    run_ranks,
    sharded_cohort_step,
    staged_sharded_cohort_step,
)
from grid_tpu_torch.parallel.mesh import RankWorkspace, block_rows

DTYPES = {"f64": (torch.float64, np.float64), "f32": (torch.float32, np.float32)}


def _seg(chrom, rows):
    s = np.array([r[0] for r in rows], np.int64)
    e = np.array([r[1] for r in rows], np.int64)
    d = np.array([r[2] for r in rows], np.float64)
    return (chrom, s, e, d)


def multichrom():
    # chr10 before chr2: the contract is sorted NAME order; irregular bins
    return [
        ("S0", [_seg("chr2", [(0, 700, 30.0), (1000, 2000, 31.0)]),
                _seg("chr10", [(500, 1500, 29.0)])]),
        ("S1", [_seg("chr2", [(0, 700, 32.0)]),
                _seg("chr10", [(500, 1500, 28.0), (9999, 10007, 5.0)])]),
        ("S2", [_seg("chr10", [(500, 1500, 30.5)])]),
    ]


def duplicates():
    return [("A", [_seg("chr1", [(0, 1000, 10.0), (0, 1000, 50.0)])]),
            ("B", [_seg("chr1", [(0, 1000, 30.0)])])]


def bounded():
    n, r = 64, 128
    rng = np.random.default_rng(1)
    starts = np.arange(r, dtype=np.int64) * 1000
    return [(f"S{i:03d}", [("chr1", starts, starts + 1000, rng.uniform(25, 35, r))])
            for i in range(n)]


def with_empty_sample():
    n, r = 19, 16
    starts = np.arange(r, dtype=np.int64) * 1000
    out = []
    for i in range(n):
        if i == 4:  # the sole sample on chr9, with depths no region keeps
            out.append(("S004", [("chr9", starts, starts + 1000, np.full(r, 5000.0))]))
        else:
            out.append((f"S{i:03d}", [("chr1", starts, starts + 1000, np.full(r, 30.0 + i))]))
    return out


def uneven_union():
    rng = np.random.default_rng(77)
    starts = np.arange(32, dtype=np.int64) * 1000
    return [(f"U{i}", [("chr6", starts, starts + 1000, rng.uniform(20.0, 60.0, 32))])
            for i in range(7)]


# name -> (samples, min_depth, max_depth)
ARRAY_CASES = {
    "multichrom": (multichrom(), 20, 100),
    "duplicates": (duplicates(), 20, 100),
    "bounded": (bounded(), 10, 100),
    "empty": (with_empty_sample(), 1, 1000),
}


def shares(items, world):
    """The r-th contiguous share of ceil(N / W) items, for each rank."""
    b = block_rows(len(items), world)
    return [items[r * b:(r + 1) * b] for r in range(world)]


@pytest.fixture(scope="module")
def files_cohort(tmp_path_factory):
    return make_synthetic_cohort(tmp_path_factory.mktemp("staged"), n_samples=11, seed=7,
                                 missing_frac=0.05)


def file_pairs(cohort):
    found = map_bed_gz_to_samples(cohort["work_dir"], cohort["ids"])
    return [(sid, str(found[sid])) for sid in sorted(found)]


@pytest.fixture(scope="module", params=[2, 3, 4], ids=lambda w: f"W{w}")
def staged(request, files_cohort, tmp_path_factory):
    """One spawn of W gloo ranks staging every case in both dtypes."""
    world = request.param
    out = tmp_path_factory.mktemp(f"stage_w{world}")
    cases = []
    for tag, (dtype, _) in DTYPES.items():
        for name, (samples, lo, hi) in ARRAY_CASES.items():
            cases.append((f"{name}.{tag}", shares(samples, world), lo, hi, dtype))
        cases.append((f"files.{tag}",
                      [("files", part) for part in shares(file_pairs(files_cohort), world)],
                      10, 100, dtype))
        union = uneven_union()  # 5 samples on rank 0, 2 on rank 1, none on the others
        cases.append((f"uneven.{tag}", [union[:5], union[5:]] + [[]] * (world - 2), 10, 100,
                      dtype))
    with RankWorkspace() as ws:
        run_ranks(torch_ranks.stage_rank, world, (cases, str(out)), platform="cpu",
                  workspace=ws)
    return world, out


def load(out, name, world):
    """The ranks' blocks in rank order, and the stage's fields (equal on
    every rank)."""
    blocks, metas = [], []
    for rank in range(world):
        blocks.append(np.load(out / f"{name}.rank{rank}.npz"))
        metas.append(json.loads((out / f"{name}.rank{rank}.json").read_text()))
    for rank in range(1, world):
        assert metas[rank] | {"row0": 0} == metas[0] | {"row0": 0}, rank
        for key in ("regions", "sample_rows"):
            np.testing.assert_array_equal(blocks[rank][key], blocks[0][key])
    rows_per = blocks[0]["values"].shape[0]
    assert [m["row0"] for m in metas] == [r * rows_per for r in range(world)]
    got = {key: np.concatenate([b[key] for b in blocks])
           for key in ("values", "mask", "row_valid")}
    got.update(regions=blocks[0]["regions"], sample_rows=blocks[0]["sample_rows"],
               rows_per=rows_per, **metas[0])
    return got


def assert_stage_equal(got, want):
    """Bitwise: the port's assembled blocks against grid_tpu's stage."""
    values = np.asarray(want.values)
    assert got["values"].dtype == values.dtype
    np.testing.assert_array_equal(got["values"], values)
    np.testing.assert_array_equal(got["mask"], np.asarray(want.mask))
    np.testing.assert_array_equal(got["row_valid"], np.asarray(want.row_valid))
    np.testing.assert_array_equal(got["regions"], want.regions)
    np.testing.assert_array_equal(got["sample_rows"], np.asarray(want.sample_rows))
    assert got["chroms"] == want.chroms
    assert got["sample_ids"] == want.sample_ids
    assert got["n"] == want.n


@pytest.mark.parametrize("tag", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(ARRAY_CASES))
def test_sharded_stage_equals_grid_tpu_s(staged, name, tag):
    world, out = staged
    samples, lo, hi = ARRAY_CASES[name]
    want = jax_stage_cohort_sharded(lambda: iter(samples), cohort_mesh(world), lo, hi,
                                    dtype=DTYPES[tag][1])
    assert_stage_equal(load(out, f"{name}.{tag}", world), want)


def test_multichrom_irregular_grid_in_name_order(staged):
    world, out = staged
    got = load(out, "multichrom.f64", world)
    assert got["chroms"] == ["chr10", "chr2"]
    regions = [(got["chroms"][c], s, e) for c, s, e in got["regions"].tolist()]
    # (chr10, 9999) has mean 5 < min_depth: dropped
    assert regions == [("chr10", 500, 1500), ("chr2", 0, 700), ("chr2", 1000, 2000)]
    vals = got["values"][got["sample_rows"]]
    np.testing.assert_array_equal(vals, [[29.0, 30.0, 31.0], [28.0, 32.0, 0.0],
                                         [30.5, 0.0, 0.0]])
    assert got["mask"][got["sample_rows"][1]].tolist() == [True, True, False]
    assert got["row_valid"].tolist() == [True] * 3 + [False] * (world * got["rows_per"] - 3)


def test_duplicate_lines_last_wins(staged):
    world, out = staged
    got = load(out, "duplicates.f64", world)
    rows = got["sample_rows"]
    assert got["values"][rows[0], 0] == 50.0 and got["values"][rows[1], 0] == 30.0


def test_each_rank_holds_rows_per_by_r(staged):
    """The host buffers are [rows_per, R]: no rank holds the [N, R] matrix."""
    world, out = staged
    n, r = 64, 128
    for rank in range(world):
        block = np.load(out / f"bounded.f32.rank{rank}.npz")
        assert block["values"].shape == (block_rows(n, world), r)
        assert block["values"].dtype == np.float32


def test_an_empty_sample_keeps_its_row(staged):
    world, out = staged
    got = load(out, "empty.f64", world)
    rows = got["sample_rows"]
    assert got["n"] == 19 and rows.shape == (19,)
    assert not got["row_valid"][rows[4]]
    for i in (0, 3, 5, 18):
        assert got["row_valid"][rows[i]]
        assert np.all(got["values"][rows[i]][got["mask"][rows[i]]] == 30.0 + i)


@pytest.mark.parametrize("tag", sorted(DTYPES))
def test_files_through_bed_source_equal_grid_tpu_s_and_the_in_memory_stager(staged,
                                                                           files_cohort, tag):
    world, out = staged
    got = load(out, f"files.{tag}", world)
    want = jax_stage_cohort_sharded(
        jax_bed_source(files_cohort["work_dir"], files_cohort["ids"]), cohort_mesh(world), 10,
        100, dtype=DTYPES[tag][1])
    assert_stage_equal(got, want)
    ref = stage_cohort(files_cohort["work_dir"], files_cohort["ids"], "chr6", None, None, {}, 10,
                       100)
    n = got["n"]
    assert got["sample_ids"] == ref.sample_ids
    np.testing.assert_array_equal(got["regions"][:, 1:], ref.regions)
    np.testing.assert_array_equal(got["values"][:n], ref.values.astype(DTYPES[tag][1]))
    np.testing.assert_array_equal(got["mask"][:n], ref.mask)


def test_bed_source_is_a_fresh_sorted_iterator_per_call(files_cohort):
    src = bed_source(files_cohort["work_dir"], files_cohort["ids"])
    first, second = list(src()), list(src())
    assert [sid for sid, _ in first] == sorted(files_cohort["ids"])
    assert [sid for sid, _ in second] == [sid for sid, _ in first]
    with pytest.raises(FileNotFoundError, match="No mosdepth files"):
        bed_source(files_cohort["work_dir"], ["no-such-sample"])


@pytest.mark.parametrize("tag", sorted(DTYPES))
def test_uneven_shares_follow_the_multi_process_layout(staged, tag):
    """Rank 0 yields 5 samples and rank 1 yields 2 (the two processes of
    tests/test_multihost.py; any further rank none): rows_per is the
    largest count, rank 1's rows start at 5, each rank is padded on its
    own, and every sample's row holds what grid_tpu's single-process stage
    of the union holds at that sample's row."""
    world, out = staged
    got = load(out, f"uneven.{tag}", world)
    assert got["rows_per"] == 5
    np.testing.assert_array_equal(got["sample_rows"], [0, 1, 2, 3, 4, 5, 6])
    assert got["row_valid"].tolist() == [True] * 7 + [False] * (5 * world - 7)
    assert got["sample_ids"] == [f"U{i}" for i in range(7)] and got["n"] == 7
    union = uneven_union()
    want = jax_stage_cohort_sharded(lambda: iter(union), cohort_mesh(world), 10, 100,
                                    dtype=DTYPES[tag][1])
    np.testing.assert_array_equal(got["regions"], want.regions)
    rows = np.asarray(want.sample_rows)
    np.testing.assert_array_equal(got["values"][got["sample_rows"]],
                                  np.asarray(want.values)[rows])
    np.testing.assert_array_equal(got["mask"][got["sample_rows"]], np.asarray(want.mask)[rows])


END_CASES = {
    # one sample with (chr1, 0) ending at 1000 and at 1200
    "within_a_sample": (
        [[("A", [_seg("chr1", [(0, 1000, 30.0), (0, 1200, 31.0)])])], []],
        "duplicate \\(chrom, start\\) with differing end within one sample"),
    # two samples of one rank disagree
    "within_pass_1": (
        [[("A", [_seg("chr1", [(0, 1000, 30.0)])]), ("B", [_seg("chr1", [(0, 1200, 30.0)])])],
         []],
        "two regions share a \\(chrom, start\\) but differ in end"),
    # two ranks disagree
    "across_ranks": (
        [[("A", [_seg("chr1", [(0, 1000, 30.0)])])], [("B", [_seg("chr1", [(0, 1200, 30.0)])])]],
        "processes disagree on a region's end"),
}


@pytest.mark.parametrize("case", sorted(END_CASES))
def test_an_end_mismatch_raises_grid_tpu_s_message_through_rank_failure(case, tmp_path):
    per_rank, message = END_CASES[case]
    with RankWorkspace() as ws, pytest.raises(RankFailure, match=message):
        run_ranks(torch_ranks.stage_rank, 2,
                  ([(case, per_rank, 20, 100, torch.float64)], str(tmp_path)),
                  platform="cpu", workspace=ws)
    if case != "across_ranks":  # one process sees both regions there
        with pytest.raises(ValueError, match=message):
            jax_stage_cohort_sharded(lambda: iter(per_rank[0] + per_rank[1]), cohort_mesh(2),
                                     20, 100)


STEP_WORLD = 3  # 13 samples: the last rank padded


@pytest.fixture(scope="module")
def staged_step(tmp_path_factory):
    cohort = make_synthetic_cohort(tmp_path_factory.mktemp("step"), n_samples=13, seed=3)
    ids = sorted(cohort["ids"])
    n = len(ids)
    rng = np.random.default_rng(0)
    reads = rng.integers(500, 900, n).astype(np.float64)
    hi, hw, hv = pad_hap_neighbors([[((h + 2) % (2 * n), 1.0)] for h in range(2 * n)], 1,
                                   dtype=np.float64)
    params = CohortParams(num_neighbors=5, n_nbr=3, n_iters=10)
    reports = []
    stage, out = staged_sharded_cohort_step(
        STEP_WORLD, cohort["work_dir"], cohort["ids"], dict(zip(ids, reads)), hi, hw, hv, params,
        10, 100, platform="cpu", reports=reports)
    return cohort, ids, reads, (hi, hw, hv), params, stage, outputs_to_numpy(out), reports


def test_staged_step_equals_the_step_from_host_arrays(staged_step):
    """The twin of tests/test_staging_sharded.py's prestaged test: neighbor
    indices equal, dipCN within rtol 1e-6."""
    cohort, ids, reads, hap, params, stage, got, _ = staged_step
    n = len(ids)
    want_stage = jax_stage_cohort_sharded(jax_bed_source(cohort["work_dir"], cohort["ids"]),
                                          cohort_mesh(STEP_WORLD), 10, 100, dtype=np.float64)
    host_vals = np.asarray(want_stage.values)[:n]
    host_mask = np.asarray(want_stage.mask)[:n]
    want = outputs_to_numpy(sharded_cohort_step(STEP_WORLD, host_vals, host_mask, reads,
                                                np.ones(n, bool), *hap, params, platform="cpu"))
    np.testing.assert_array_equal(got.nbr_idx[:n], want.nbr_idx[:n])
    np.testing.assert_allclose(got.dipcn[:n], want.dipcn[:n], rtol=1e-6, equal_nan=True)
    np.testing.assert_array_equal(got.dipcn_valid[:n], want.dipcn_valid[:n])
    assert got.z.shape == (block_rows(n, STEP_WORLD) * STEP_WORLD, len(stage.regions))


def test_staged_step_returns_the_stage_s_host_fields(staged_step):
    cohort, ids, _, _, _, stage, _, reports = staged_step
    want = jax_stage_cohort_sharded(jax_bed_source(cohort["work_dir"], cohort["ids"]),
                                    cohort_mesh(STEP_WORLD), 10, 100)
    assert isinstance(stage, ShardedCohortStage)
    assert stage.values is None and stage.mask is None and stage.row0 == 0
    assert stage.sample_ids == want.sample_ids == ids and stage.n == want.n
    assert stage.chroms == want.chroms
    np.testing.assert_array_equal(stage.regions, want.regions)
    np.testing.assert_array_equal(stage.sample_rows, np.asarray(want.sample_rows))
    np.testing.assert_array_equal(stage.row_valid.numpy(), np.asarray(want.row_valid))
    r = len(stage.regions)
    rows_per = block_rows(len(ids), STEP_WORLD)
    assert len(reports) == STEP_WORLD
    for rep in reports:
        assert rep["r"] == r and rep["rows_per"] == rows_per
        assert rep["host_buffer_bytes"] == rows_per * r * 8 + rows_per * r + rows_per
        assert rep["peak_rss_bytes"] >= rep["rss_bytes"] > 0 and rep["start_seconds"] > 0
        for span in ("stage.pass1", "stage.pass2", "sharded.normalize", "sharded.ring",
                     "sharded.dipcn", "sharded.phase"):
            assert rep[span] >= 0, span
