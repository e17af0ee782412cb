"""Each host module the port copied, against its grid_tpu twin on the same
files and arrays: formats written by one package are read by the other,
writers give the same bytes (gzipped files are compared decompressed: a gzip
header holds a time, and grid_tpu may write through its native library),
stagers give identical arrays, loaders identical lists, the config
validator the same messages and defaults, the cohort generator the same
files."""

import copy
import gzip
import json
from pathlib import Path

import numpy as np
import pytest

import grid_tpu.config as jax_config
import grid_tpu.io.bed as jax_bed
import grid_tpu.io.formats as jax_formats
import grid_tpu.io.hap_neighbors as jax_hap
import grid_tpu.io.staging as jax_staging
import grid_tpu.steps.normalize as jax_normalize
import grid_tpu.synth as jax_synth
import grid_tpu.utils.timing as jax_timing
import grid_tpu_torch.config as torch_config
import grid_tpu_torch.io.bed as torch_bed
import grid_tpu_torch.io.formats as torch_formats
import grid_tpu_torch.io.hap_neighbors as torch_hap
import grid_tpu_torch.io.staging as torch_staging
import grid_tpu_torch.steps.normalize as torch_normalize
import grid_tpu_torch.synth as torch_synth
import grid_tpu_torch.utils.timing as torch_timing
from grid_tpu_torch.utils.logging import log, make_console

PACKAGES = {"jax": jax_formats, "torch": torch_formats}


def content(path) -> bytes:
    return gzip.open(path).read() if str(path).endswith(".gz") else Path(path).read_bytes()


def normalized_arrays(dtype, seed=0, n=7, r=23):
    rng = np.random.default_rng(seed)
    ids = [f"S{i:03d}" for i in range(n)]
    z = (rng.normal(size=(n, r)) * 3).astype(dtype)
    mask = rng.random((n, r)) > 0.2
    mask[3] = False  # a sample with no valid cell
    means = rng.uniform(0.5, 1.5, r).astype(dtype)
    means[5], means[6] = np.nan, 0.0  # NA mean; ratio undefined
    col_vars = rng.uniform(0, 0.01, r).astype(dtype)
    scales = rng.uniform(20, 40, n).astype(dtype)
    selected = np.sort(rng.choice(r, size=17, replace=False))
    return ids, scales, z, mask, means, col_vars, selected


# ------------------------------------------------------------- formats ---


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("native", ["1", "0"])
def test_normalized_writer_bytes_and_cross_reads(tmp_path, monkeypatch, dtype, native):
    monkeypatch.setenv("GRID_TPU_NATIVE_WRITERS", native)
    args = normalized_arrays(dtype)
    paths = {}
    for name, mod in PACKAGES.items():
        paths[name] = tmp_path / f"{name}.tsv.gz"
        mod.write_normalized_output(paths[name], *args)
    assert content(paths["torch"]) == content(paths["jax"])
    for writer, reader in (("jax", torch_formats), ("torch", jax_formats)):
        ids, ratios, data, scales = reader.read_normalized_data(paths[writer])
        want = jax_formats.read_normalized_data(paths["jax"])
        assert ids == want[0] == args[0] and scales == want[3]
        np.testing.assert_array_equal(ratios, want[1])
        np.testing.assert_array_equal(data, want[2])
        assert data.shape == (7, 17) and np.isnan(data[3]).all()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("k", [0, 1, 6])
def test_neighbors_writer_bytes_and_cross_reads(tmp_path, dtype, k):
    rng = np.random.default_rng(k)
    n = 9
    ids = [f"id_{i}" for i in range(n)]
    scales = rng.uniform(20, 40, n).astype(dtype)
    idx = np.stack([rng.permutation(n)[:k] for _ in range(n)]).astype(np.int32).reshape(n, k)
    dists = np.sort(rng.uniform(0, 3, (n, k)), axis=1).astype(dtype)
    paths = {}
    for name, mod in PACKAGES.items():
        paths[name] = mod.neighbors_filename(tmp_path / name, "nbr", 2.0, "tsv")
        mod.write_neighbors_dense(paths[name], ids, scales, idx, dists)
    assert paths["torch"].name == paths["jax"].name == "nbr.zMax2.0.tsv.gz"
    assert content(paths["torch"]) == content(paths["jax"])
    for writer, reader in (("jax", torch_formats), ("torch", jax_formats)):
        nbrs, own = reader.read_neighbors(paths[writer])
        assert (nbrs, own) == jax_formats.read_neighbors(paths["jax"])
        assert list(nbrs) == ids and all(len(v) == k for v in nbrs.values())
        if k:
            assert [nid for nid, _, _ in nbrs["id_2"]] == [ids[j] for j in idx[2]]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_dipcn_writer_bytes_and_cross_reads(tmp_path, dtype):
    ids = ["a", "b_1", "c"]
    vals = np.array([1.0000001, 0.93660894642164, 2.5], dtype=dtype)
    for name, mod in PACKAGES.items():
        mod.write_dipcn(tmp_path / f"{name}.tsv", ids, list(vals))
    assert content(tmp_path / "torch.tsv") == content(tmp_path / "jax.tsv")
    for writer, reader in (("jax", torch_formats), ("torch", jax_formats)):
        got_ids, got_vals, index = reader.read_dipcn(tmp_path / f"{writer}.tsv")
        assert got_ids == ids and index == {"a": 0, "b_1": 1, "c": 2}
        # a float32 widened to a Python float prints its own digits: it
        # comes back as that float32, not as the float64 it was rounded from
        np.testing.assert_array_equal(np.asarray(got_vals, dtype=dtype), vals)


@pytest.mark.parametrize("suffix", ["tsv", "tsv.gz"])
def test_haploid_writer_bytes(tmp_path, suffix):
    rng = np.random.default_rng(3)
    ids = [f"S{i}" for i in range(6)]
    cols = [rng.uniform(0.5, 2.5, 6) for _ in range(5)]
    cols[1][2] = cols[2][2] = np.nan  # an unphased sample
    for name, mod in PACKAGES.items():
        mod.write_haploid_output(tmp_path / f"{name}.{suffix}", ids, *cols)
    got = content(tmp_path / f"torch.{suffix}")
    assert got == content(tmp_path / f"jax.{suffix}")
    assert got.splitlines()[3].split(b"\t")[2:4] == [b"nan", b"nan"]


def test_samples_and_counts_readers(tmp_path):
    ids = ["HG001", "HG002", "NA12878"]
    for name, mod in PACKAGES.items():
        mod.write_samples(tmp_path / f"{name}.txt", ids)
    assert content(tmp_path / "torch.txt") == content(tmp_path / "jax.txt")
    (tmp_path / "gaps.txt").write_text("HG001\n\n  HG002  \n")
    counts = tmp_path / "counts.tsv"
    counts.write_text("Sample\tchr6:1-2\nHG001\t120\nHG002\tNA\nbroken line\nNA12878\t7.5\n")
    with gzip.open(tmp_path / "counts.tsv.gz", "wt") as f:
        f.write(counts.read_text())
    for mod in PACKAGES.values():
        assert mod.read_samples(tmp_path / "torch.txt") == ids
        assert mod.read_samples(tmp_path / "gaps.txt") == ["HG001", "HG002"]
        for path in (counts, tmp_path / "counts.tsv.gz"):
            assert mod.read_counts_tsv(path) == {"HG001": 120.0, "NA12878": 7.5}
        with mod.open_maybe_gz(tmp_path / "counts.tsv.gz") as f:
            assert f.readline() == "Sample\tchr6:1-2\n"


# ----------------------------------------------------------------- bed ---

BED_LINES = [
    "chr6\t1000\t2000\t30.50",
    "chr6\t2000\t3000\t0.00",      # zero depth: dropped
    "chr6\t3000\t4000\t28.25",
    "chr6\t3000\t4000\t29.75",     # duplicate region: last wins
    "chr6\t5000\t6000\t31.00",     # under the repeat mask
    "chr7\t1000\t2000\t33.00",     # another chromosome
    "chr6\tx\t8000\t30.00",        # unparsable
    "chr6\t9000",                  # short
    "chr6\t9000\t10000\t27.00",
    "chr6\t12000\t13000\t35.00",   # outside the window
]


def write_bed(path, lines):
    with gzip.open(path, "wt") as f:
        f.write("\n".join(lines) + "\n")


@pytest.mark.parametrize("window", [(None, None), (1000, 10000), (3500, 9000)])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("chrom", ["chr6", "6", None])
def test_read_regions_bed_gz(tmp_path, window, masked, chrom):
    bed = tmp_path / "s.regions.bed.gz"
    write_bed(bed, BED_LINES)
    mask_file = tmp_path / "mask.bed"
    mask_file.write_text("# repeats\nchr6\t5200\t5300\n6\t700000\t701500\nbad line\n")
    excluded = {mod: mod.load_repeat_mask(mask_file if masked else None)
                for mod in (jax_bed, torch_bed)}
    assert excluded[torch_bed] == excluded[jax_bed]
    want = jax_bed.read_regions_bed_gz(bed, chrom, *window, excluded[jax_bed])
    got = torch_bed.read_regions_bed_gz(bed, chrom, *window, excluded[torch_bed])
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    if chrom and window == (1000, 10000) and masked:
        assert got[0].tolist() == [1000, 3000, 3000, 9000]


def test_bed_file_mapping(tmp_path):
    samples = ["HG001", "HG002_A", "HG003"]
    for name in ("HG001_LPA.regions.bed.gz", "HG002_A_LPA.regions.bed.gz", "other.regions.bed.gz",
                 "HG003.per-base.bed.gz"):
        (tmp_path / name).write_bytes(b"")
    got = torch_bed.map_bed_gz_to_samples(tmp_path, samples)
    assert got == jax_bed.map_bed_gz_to_samples(tmp_path, samples)
    assert sorted(got) == ["HG001", "HG002_A"]
    for sid in samples:
        assert (torch_bed.find_bed_gz_for_sample(sid, tmp_path)
                == jax_bed.find_bed_gz_for_sample(sid, tmp_path))
    assert torch_bed.norm_chrom("6") == jax_bed.norm_chrom("6") == "chr6"
    assert torch_bed.region_overlaps_mask("chr6", 1500, 2500, {"chr6": {2}})
    assert not torch_bed.region_overlaps_mask("chr6", 3000, 3999, {"chr6": {2}})


# ------------------------------------------------------------- staging ---


@pytest.fixture(scope="module")
def ragged_cohort(tmp_path_factory):
    """Seven samples on a 1 kb grid: duplicate lines, missing bins, an
    unsorted file, a sample with no usable line, a sample whose file is
    absent, a bin under the repeat mask and bins outside the depth range."""
    work = tmp_path_factory.mktemp("ragged")
    rng = np.random.default_rng(11)
    starts = 100_000 + 1000 * np.arange(40)
    samples = [f"R{i}" for i in range(7)]
    for i, sid in enumerate(samples[:6]):
        lines = []
        for j, s in enumerate(starts):
            depth = rng.normal(30, 2) * (0.1 if j in (7, 8) else 1.0)  # two bins too shallow
            if rng.random() < 0.1 and i != 0:
                continue
            lines.append(f"chr6\t{s}\t{s + 1000}\t{depth:.2f}")
            if rng.random() < 0.1:
                lines.append(f"chr6\t{s}\t{s + 1000}\t{depth + 1:.2f}")  # later line wins
        if i == 2:
            lines = lines[::-1]
        if i == 4:
            lines = [f"chr6\t{s}\t{s + 1000}\t0.00" for s in starts]  # nothing survives
        write_bed(work / f"{sid}_LPA.regions.bed.gz", lines)
    mask_file = work / "mask.bed"
    mask_file.write_text("chr6\t112100\t112200\n")
    return work, samples, mask_file


def assert_same_stage(got, want):
    assert got.sample_ids == want.sample_ids
    for field in ("regions", "values", "mask"):
        g, w = getattr(got, field), getattr(want, field)
        assert g.dtype == w.dtype and g.shape == w.shape, field
        np.testing.assert_array_equal(g, w, err_msg=field)


@pytest.mark.parametrize("threads", [1, 3])
@pytest.mark.parametrize("stager", ["stage_cohort", "stage_cohort_streaming"])
def test_stagers_match(ragged_cohort, stager, threads):
    work, samples, mask_file = ragged_cohort
    args = (work, samples, "chr6", 100_000, 140_000)
    want = getattr(jax_staging, stager)(*args, jax_bed.load_repeat_mask(mask_file), 20, 100,
                                        threads=threads)
    got = getattr(torch_staging, stager)(*args, torch_bed.load_repeat_mask(mask_file), 20, 100,
                                         threads=threads)
    assert_same_stage(got, want)
    assert got.sample_ids == ["R0", "R1", "R2", "R3", "R5"]  # R4 empty, R6 has no file
    # 40 bins less two too shallow and the two that touch the masked kb bin 112
    assert got.values.dtype == np.float64 and got.values.shape[1] == 36
    assert not got.mask.all() and (got.values[~got.mask] == 0).all()


def test_streaming_stager_equals_in_memory(ragged_cohort):
    work, samples, mask_file = ragged_cohort
    excluded = torch_bed.load_repeat_mask(mask_file)
    args = (work, samples, "chr6", 100_000, 140_000, excluded, 20, 100)
    assert_same_stage(torch_staging.stage_cohort_streaming(*args), torch_staging.stage_cohort(*args))
    # no chromosome: the streaming stager hands over to the in-memory one
    no_chrom = (work, samples, None, None, None, excluded, 20, 100)
    assert_same_stage(torch_staging.stage_cohort_streaming(*no_chrom),
                      jax_staging.stage_cohort_streaming(*no_chrom))


def test_stage_from_prescanned_arrays(ragged_cohort):
    """The ``per_sample`` handoff: arrays scanned once stage as the files do."""
    work, samples, mask_file = ragged_cohort
    excluded = torch_bed.load_repeat_mask(mask_file)
    beds = torch_bed.map_bed_gz_to_samples(work, samples)
    scanned = torch_staging.scan_cohort_regions(beds, "chr6", 100_000, 140_000, excluded, threads=2)
    want = jax_staging.scan_cohort_regions(beds, "chr6", 100_000, 140_000, excluded, threads=2)
    assert list(scanned) == list(want)
    for sid in scanned:
        for g, w in zip(scanned[sid], want[sid]):
            np.testing.assert_array_equal(g, w)
    args = (work, samples, "chr6", 100_000, 140_000, excluded, 20, 100)
    assert_same_stage(torch_staging.stage_cohort(*args, per_sample=scanned),
                      torch_staging.stage_cohort(*args))
    uniq, means = torch_staging.population_mean_depths(scanned)
    j_uniq, j_means = jax_staging.population_mean_depths(want)
    np.testing.assert_array_equal(uniq, j_uniq)
    np.testing.assert_array_equal(means, j_means)


def test_staging_errors(tmp_path, ragged_cohort):
    work, samples, _ = ragged_cohort
    for stager in (torch_staging.stage_cohort, torch_staging.stage_cohort_streaming):
        with pytest.raises(FileNotFoundError, match="No mosdepth files"):
            stager(tmp_path, samples, "chr6", 0, 10, {}, 20, 100)
        with pytest.raises(ValueError, match="No valid samples"):
            stager(work, ["R4"], "chr6", 100_000, 140_000, {}, 20, 100)


def test_dedupe_last_wins_unsorted():
    starts = np.array([3000, 1000, 3000, 2000, 1000], np.int64)
    ends = starts + 1000
    depths = np.array([1.0, 2.0, 3.0, 4.0, 5.0])
    got = torch_staging._dedupe_last_wins(starts, ends, depths)
    want = jax_staging._dedupe_last_wins(starts, ends, depths)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].tolist() == [1000, 2000, 3000] and got[2].tolist() == [5.0, 4.0, 3.0]
    np.testing.assert_array_equal(torch_staging._composite(starts, ends),
                                  jax_staging._composite(starts, ends))


@pytest.mark.parametrize("mode,n,streams", [("auto", 3, False), ("auto", 5001, True),
                                            ("true", 3, True), ("false", 5001, False)])
def test_stage_choice(tmp_path, ragged_cohort, mode, n, streams):
    samples_file = tmp_path / "samples.txt"
    samples_file.write_text("".join(f"X{i}\n" for i in range(n)))
    cfg = {"samples_file": str(samples_file), "chrom": "chr6", "device": {"streaming_stage": mode}}
    assert torch_normalize.stage_would_stream(cfg) == jax_normalize.stage_would_stream(cfg) == streams
    assert not torch_normalize.stage_would_stream({**cfg, "chrom": None})
    assert not torch_normalize.stage_would_stream({**cfg, "samples_file": str(tmp_path / "none")}) \
        or mode == "true"
    work, samples, mask_file = ragged_cohort
    run_cfg = {"mosdepth": {"work_dir": str(work)}, "device": {"streaming_stage": mode}}
    args = (samples, "chr6", 100_000, 140_000, torch_bed.load_repeat_mask(mask_file), 20, 100, 1,
            None)
    assert_same_stage(torch_normalize._stage(run_cfg, *args), jax_normalize._stage(run_cfg, *args))


# ------------------------------------------------------- hap neighbors ---


def test_ibs_loader(tmp_path):
    path = tmp_path / "ibs.tsv.gz"
    rows = ["ID\thap\tnbrInd\tcMlen\tcMedge\tIDnbr\thapNbr",
            "A\t1\t1\t2.5\t0.1\tB\t2", "A\t1\t2\t2.0\t0.1\tC\t1", "A\t1\t0\t1.0\t0.1\tB\t1",
            "A\t2\t1\t2.5\t0.1\tZ\t1",      # unknown neighbor
            "B\t3\t0\t2.5\t0.1\tA\t1",      # hap out of range
            "B\tx\t0\t2.5\t0.1\tA\t1", "short\tline", "",
            "C\t2\t0\t2.5\t0.1\tA\t2"]
    with gzip.open(path, "wt") as f:
        f.write("\n".join(rows) + "\n")
    index = {"A": 0, "B": 1, "C": 2}
    for max_nbr in (1, 2, 10):
        got = torch_hap.load_ibs_neighbors(path, index, max_nbr)
        assert got == jax_hap.load_ibs_neighbors(path, index, max_nbr)
    assert got[0] == [(3, 1.0), (4, 1.0), (2, 1.0)] and got[5] == [(1, 1.0)] and got[1] == []


@pytest.mark.parametrize("weighted", [False, True])
def test_ibd_loader(tmp_path, weighted):
    path = tmp_path / "ibd.tsv"
    rows = ["A\tA_0\tB\tB_1\t6\t900\t1500\t0\t0\t3.2\t0.95",
            "A\tA_0\tC\tC_0\t6\t5000\t9000\t0\t0\t4.0\t0.80",   # past the region: distance weight
            "A A_0 B B_0 6 10 20 0 0 1.0 0.99",                # space separated, before the region
            "B\tB_0\tC\tC_1\t6\t900\t1500\t0\t0\t0.2\t0.95",    # too short
            "B\tB_0\tC\tC_1\t6\t900\t1500\t0\t0\t3.0\t0.50",    # poor match
            "B\tB_2\tC\tC_1\t6\t900\t1500\t0\t0\t3.0\t0.90",    # hap out of range
            "B\tB_0\tZ\tZ_1\t6\t900\t1500\t0\t0\t3.0\t0.90",    # unknown sample
            "B\tB_0\tC\tC_1\t6\tx\t1500\t0\t0\t3.0\t0.90", "too\tfew"]
    path.write_text("\n".join(rows) + "\n")
    index = {"A": 0, "B": 1, "C": 2}
    for max_nbr in (1, 5):
        got = torch_hap.load_ibd_neighbors(path, index, max_nbr, 1000, 2000, weighted=weighted)
        assert got == jax_hap.load_ibd_neighbors(path, index, max_nbr, 1000, 2000,
                                                 weighted=weighted)
    assert [j for j, _ in got[0]] == [4, 3, 2]  # by segment length, descending
    if weighted:
        assert got[0][0][1] == pytest.approx(1_000_000 / 1_003_000 * 0.80)
    assert torch_hap.segment_distance(10, 20, 1000, 2000) == jax_hap.segment_distance(10, 20, 1000, 2000) == 980.0
    padded = torch_hap.pad_hap_neighbors(got, 2, dtype=np.float64)
    for g, w in zip(padded, jax_hap.pad_hap_neighbors(got, 2, dtype=np.float64)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


# -------------------------------------------------------------- config ---


@pytest.fixture(scope="module")
def good_config(tmp_path_factory):
    return torch_synth.make_synthetic_cohort(tmp_path_factory.mktemp("cfg"), n_samples=4)["config"]


def spoil(cfg, case):
    cfg = copy.deepcopy(cfg)
    if case == "missing_top_level":
        del cfg["chrom"], cfg["threads"]
    elif case == "wrong_types":
        cfg["threads"], cfg["start_bp"] = "2", True
    elif case == "missing_files":
        cfg["samples_file"] = "/nonexistent/samples.txt"
        cfg["mosdepth"]["normalize"]["repeat_mask_file"] = "/nonexistent/mask.bed"
    elif case == "required_step_fields":
        cfg["count_reads"] = {"run": True}
        cfg["compute_ibs"] = {"run": True}
        del cfg["mosdepth"]["normalize"]["repeat_mask_file"]
    elif case == "mapq_quirk":
        cfg["count_reads"] = {"run": True, "flags": [83], "min_mapq": 20}
    elif case == "bare":
        cfg = {k: v for k, v in cfg.items() if not isinstance(v, dict)}
    return cfg


class Recorder:
    def __init__(self):
        self.lines = []

    def print(self, msg, style=None):
        self.lines.append((msg, style))


@pytest.mark.parametrize("case", ["good", "missing_top_level", "wrong_types", "missing_files",
                                  "required_step_fields", "mapq_quirk", "bare"])
@pytest.mark.parametrize("schema", ["wgs", "wes"])
def test_config_validation_and_defaults(good_config, case, schema):
    cfg = spoil(good_config, case)
    seen = {}
    for name, mod in (("jax", jax_config), ("torch", torch_config)):
        console = Recorder()
        table = None if schema == "wgs" else mod.WES_SCHEMA
        try:
            mod.error_check_config(copy.deepcopy(cfg), console, schema=table)
            raised = None
        except ValueError as e:
            raised = str(e)
        seen[name] = (raised, console.lines, mod.apply_defaults(cfg, schema=table))
    assert seen["torch"] == seen["jax"]
    raised, lines, defaults = seen["torch"]
    if schema == "wgs":
        assert (raised is None) == (case in ("good", "mapq_quirk", "bare"))
    if case == "mapq_quirk" and schema == "wgs":
        assert any("quirk Q3" in msg for msg, _ in lines)
    if schema == "wgs" and case == "good":
        assert defaults["device"]["fused"] is False and defaults["device"]["dtype"] == "auto"
        assert defaults["mosdepth"]["neighbors"]["frac_r"] == 1.0
        assert "device" not in cfg  # the input is not modified


def test_config_schemas_and_yaml(tmp_path, good_config):
    for table in ("REQUIRED_TOP_LEVEL", "REQUIRED_FILES_TOP_LEVEL", "STEP_SCHEMA", "DEVICE_SCHEMA",
                  "WES_SCHEMA"):
        assert getattr(torch_config, table) == getattr(jax_config, table), table
    import yaml

    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump(good_config, sort_keys=False))
    assert torch_config.load_config(path) == jax_config.load_config(path) == good_config


# --------------------------------------------------------------- synth ---


@pytest.mark.parametrize("kwargs", [
    dict(n_samples=5, seed=0),
    dict(n_samples=9, seed=5, missing_frac=0.05),
    dict(n_samples=6, seed=2, flank_bins=7, window_end=160_611_500, mean_depth=22.0),
], ids=["default", "missing", "ragged_window"])
def test_synthetic_cohort_files_are_identical(tmp_path, kwargs):
    """The same draws in the same order: one seed, the same files. Both
    write into one path in turn, so the configs (which hold paths) match."""
    out = tmp_path / "cohort"
    snapshots, results = {}, {}
    for name, mod in (("jax", jax_synth), ("torch", torch_synth)):
        results[name] = mod.make_synthetic_cohort(out, **kwargs)
        snapshots[name] = {str(p.relative_to(out)): content(p)
                           for p in sorted(out.rglob("*")) if p.is_file()}
        for p in sorted(out.rglob("*"), reverse=True):
            p.unlink() if p.is_file() else p.rmdir()
    assert sorted(snapshots["torch"]) == sorted(snapshots["jax"])
    assert len(snapshots["torch"]) == kwargs["n_samples"] + 7
    for name in snapshots["jax"]:
        assert snapshots["torch"][name] == snapshots["jax"][name], name
    jax_res, torch_res = results["jax"], results["torch"]
    assert set(torch_res) == set(jax_res) and torch_res["config"] == jax_res["config"]
    for key in ("hap_cn", "dip_cn", "base_depth"):
        np.testing.assert_array_equal(torch_res[key], jax_res[key])
    assert torch_res["ids"] == jax_res["ids"]


# ------------------------------------------------------ timing, logging ---


def test_step_timer_and_log(tmp_path, capsys):
    reports = {}
    for name, mod in (("jax", jax_timing), ("torch", torch_timing)):
        timer = mod.StepTimer()
        with mod.step_timer("outer", timer):
            with mod.step_timer("inner", timer):
                pass
            with mod.step_timer("inner", timer):
                pass
        with pytest.raises(KeyError):
            with mod.step_timer("failing", timer):
                raise KeyError("x")
        timer.record("fixed", 1.5)
        timer.record("fixed", 0.25)
        timer.dump(tmp_path / name / "step_timings.json")
        reports[name] = timer.report()
        assert json.loads((tmp_path / name / "step_timings.json").read_text()) == reports[name]
    assert list(reports["torch"]) == list(reports["jax"]) == ["inner", "outer", "failing", "fixed"]
    assert reports["torch"]["fixed"] == 1.75 and reports["torch"]["outer"] >= reports["torch"]["inner"]
    console = Recorder()
    with torch_timing.step_timer("shown", None, console):
        pass
    assert console.lines[0][0].startswith("[shown] ") and console.lines[0][1] == "info"
    log(None, "plain line")
    assert capsys.readouterr().out == "plain line\n"
    log(console, "styled", style="warning")
    log(console, "bare")
    assert console.lines[1:] == [("styled", "warning"), ("bare", None)]
    made = make_console()
    assert made is None or hasattr(made, "print")
