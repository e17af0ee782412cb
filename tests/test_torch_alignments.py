"""The port's host steps 1-3 from BAM/CRAM against grid_tpu's on the same
fabricated cohorts (CPU only: these steps do no device work).

Byte-identical: the fabricated BAM and CRAM files, the readers' counts,
binned depths (decompressed), fetched reads, built ``.bai``/``.crai``, and
the pipeline's step 1-3 artifacts (the counts and coverage TSVs have the
same header and rows; the rows are appended as samples finish, so they are
compared sorted, as ``tests/test_fused_ingest.py`` does). Steps 4-7 from
alignments, in float64, follow the file-mode rules of
``tests/test_torch_filemode.py``: normalized file byte-identical, neighbors
byte-identical or differing by exact ties only, dipCN and haploid values to
1e-9. CRAM runs through the native reader and through ``cramlite`` (the
plain version, forced). The gzip header's time is frozen while cohorts and
indexes are written: CRAM blocks and ``.crai`` files are gzip members.
"""

import copy
import gzip
import shutil
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import grid_tpu.ingest.alignments as jax_aln
import grid_tpu.pipeline as jax_pipeline
from grid_tpu.native import bam as jax_bam
from grid_tpu.native import cram as jax_cram
from grid_tpu.steps.index import create_index as jax_create_index
from grid_tpu.steps.multilocus import run_multi_locus as jax_run_multi_locus
from grid_tpu.synth import make_synthetic_cohort_with_alignments as jax_make
from grid_tpu_torch import native_host
from grid_tpu_torch.ingest import alignments
from grid_tpu_torch.io import cramlite
from grid_tpu_torch.io.formats import read_dipcn, read_neighbors
from grid_tpu_torch.native_host import bam as port_bam
from grid_tpu_torch.native_host import cram as port_cram
from grid_tpu_torch.pipeline import run_wgs_pipeline
from grid_tpu_torch.steps import index as port_index
from grid_tpu_torch.steps.multilocus import run_multi_locus
from grid_tpu_torch.synth import make_synthetic_cohort_with_alignments
from torch_parity import neighbor_rows_differing

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ toolchain")

REPO = Path(__file__).resolve().parent.parent
N, SEED = 6, 11
FLAGS = [83, 147, 81, 145]
# case -> (file type, indel fraction)
COHORTS = {"bam": ("bam", 0.0), "bam_indel": ("bam", 0.2), "cram": ("cram", 0.0),
           "cram_indel": ("cram", 0.2)}
# (case, reader): every cohort through the native reader, the CRAMs also
# through cramlite
READERS = [(case, "native") for case in COHORTS] + [("cram", "cramlite"),
                                                    ("cram_indel", "cramlite")]
STEP_1_3 = ("read_counts.tsv", "mosdepth_results.tsv")
NORMALIZED = "mosdepth_results_normalized.tsv.gz"
NEIGHBORS = "neighbor_coverage.zMax2.0.tsv.gz"
DIPCN, HAPLOID = "diploid_genotypes.tsv", "haploid_genotypes.tsv"


class Recorder:
    """A console that keeps what the pipeline logs."""

    def __init__(self):
        self.lines = []

    def print(self, msg, style=None):
        self.lines.append((msg, style))

    def styled(self, *styles):
        return [msg for msg, style in self.lines if style in styles]


@pytest.fixture(scope="module")
def frozen_gzip():
    """Freeze the gzip header's time for the whole module (see the module
    docstring)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(gzip, "time", SimpleNamespace(time=lambda: 1.0e9))
        yield


@pytest.fixture(scope="module")
def jax_native():
    from grid_tpu import native

    native.lib()  # grid_tpu's own build (make)


@pytest.fixture(scope="module")
def cohorts(tmp_path_factory, frozen_gzip, jax_native):
    """case -> (grid_tpu's cohort, the port's cohort), each fabricated by its
    own package from the same seed."""
    out = {}
    for case, (file_type, indel) in COHORTS.items():
        base = tmp_path_factory.mktemp(case)
        out[case] = tuple(make(base / name, n_samples=N, seed=SEED, file_type=file_type,
                               indel_frac=indel)
                          for name, make in (("jax", jax_make),
                                             ("torch", make_synthetic_cohort_with_alignments)))
    return out


def files_of(cohort) -> list:
    return sorted(Path(cohort["config"]["directory_loc"]).iterdir())


def rows(path) -> tuple:
    """(header, sorted rows) of a counts or coverage TSV."""
    lines = Path(path).read_text().splitlines()
    return lines[0], sorted(lines[1:])


def content(path) -> bytes:
    return gzip.open(path).read() if str(path).endswith(".gz") else Path(path).read_bytes()


# ----------------------------------------------------------- fabrication ---


def test_copied_modules_are_byte_copies():
    for name in ("bamlite.py", "cramlite.py"):
        ours = (REPO / "grid_tpu_torch" / "io" / name).read_bytes()
        assert ours == (REPO / "grid_tpu" / "io" / name).read_bytes(), name


@pytest.mark.parametrize("case", sorted(COHORTS))
def test_fabricated_cohorts_are_byte_identical(cohorts, case):
    jax_c, port_c = cohorts[case]
    ours, theirs = files_of(port_c), files_of(jax_c)
    assert [p.name for p in ours] == [p.name for p in theirs] and len(ours) == N
    assert all(p.suffix == f".{COHORTS[case][0]}" for p in ours)
    for a, b in zip(ours, theirs):
        assert a.read_bytes() == b.read_bytes(), a.name
    np.testing.assert_array_equal(port_c["dip_cn"], jax_c["dip_cn"])
    np.testing.assert_array_equal(port_c["base_depth"], jax_c["base_depth"])
    jax_root, port_root = str(Path(jax_c["samples_file"]).parent), str(
        Path(port_c["samples_file"]).parent)
    assert str(port_c["config"]).replace(port_root, "") == str(jax_c["config"]).replace(
        jax_root, "")
    for name in ("samples_file", "ibs_file", "mask_file"):
        assert content(port_c[name]) == content(jax_c[name]), name


def test_parallel_fabrication_writes_the_same_files(cohorts, tmp_path, monkeypatch):
    """Three samples a writer: the files are written by two spawned
    processes, the draws made here; the bytes are those of one process
    (BAM: the writers do not share the frozen gzip time a CRAM's bytes
    depend on)."""
    import grid_tpu_torch.synth as synth

    _, port_c = cohorts["bam_indel"]
    monkeypatch.setattr(synth, "SAMPLES_PER_WRITER", 3)
    again = make_synthetic_cohort_with_alignments(tmp_path, n_samples=N, seed=SEED,
                                                  file_type="bam", indel_frac=0.2)
    for a, b in zip(files_of(again), files_of(port_c)):
        assert a.read_bytes() == b.read_bytes(), a.name


# --------------------------------------------------------------- readers ---


def windows(cfg) -> list:
    """The config's window, the VNTR bins alone, a window across the left
    edge of the reads, one on the other naming of the chromosome, and an
    empty one."""
    chrom, start, end = cfg["chrom"], cfg["start_bp"], cfg["end_bp"]
    return [(chrom, start, end), (chrom, 160_605_000, 160_615_000),
            (chrom, start - 5_000, start + 2_500), (chrom, end + 1_000_000, end + 1_001_000)]


@pytest.mark.parametrize("case,reader", READERS)
def test_count_reads_in_region_matches_grid_tpu(cohorts, monkeypatch, case, reader):
    jax_c, port_c = cohorts[case]
    if reader == "cramlite":
        monkeypatch.setattr(alignments, "_native_cram", lambda: None)
    before = dict(native_host.fallbacks)
    for ours, theirs in zip(files_of(port_c), files_of(jax_c)):
        for chrom, start, end in windows(port_c["config"]):
            for min_mapq in (1, 61):
                got = alignments.count_reads_in_region(ours, None, chrom, start, end, FLAGS,
                                                       min_mapq)
                want = jax_aln.count_reads_in_region(theirs, None, chrom, start, end, FLAGS,
                                                     min_mapq)
                assert got == want, (ours.name, chrom, start, end, min_mapq)
                assert (got > 0) == (min_mapq == 1 and start < 160_700_000)
    assert dict(native_host.fallbacks) == before  # no file left the route it was given


@pytest.mark.parametrize("case,reader", READERS)
def test_fetch_reads_region_matches_grid_tpu(cohorts, case, reader):
    """BAM through the native reader; CRAM, in both packages, through
    cramlite (there is no native CRAM fetch)."""
    jax_c, port_c = cohorts[case]
    chrom, start, end = windows(port_c["config"])[1]
    for ours, theirs in zip(files_of(port_c)[:2], files_of(jax_c)[:2]):
        got = alignments.fetch_reads_region(ours, None, chrom, start, end)
        want = jax_aln.fetch_reads_region(theirs, None, chrom, start, end)
        for g, w in zip(got[:3], want[:3]):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        assert got[3] == want[3] and len(got[0]) > 100


@pytest.mark.parametrize("case,reader", READERS)
@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_binned_depth_matches_grid_tpu(cohorts, tmp_path, case, reader, sparse):
    jax_c, port_c = cohorts[case]
    jax_binner = jax_cram if case.startswith("cram") else jax_bam
    port_binner = {"native": port_cram if case.startswith("cram") else port_bam,
                   "cramlite": cramlite}[reader]
    for i, (ours, theirs) in enumerate(zip(files_of(port_c), files_of(jax_c))):
        got, want = tmp_path / f"port{i}.regions.bed.gz", tmp_path / f"jax{i}.regions.bed.gz"
        port_binner.binned_depth(str(ours), str(got), 1000, skip_zero=sparse)
        jax_binner.binned_depth(str(theirs), str(want), 1000, skip_zero=sparse)
        assert content(got) == content(want), ours.name
        assert content(got).count(b"\n") > 20


BED_TEXTS = {  # name -> the text of a regions.bed.gz
    "multi_chrom": "chr6\t0\t1000\t1.5\nchr60\t0\t5000\t9\n6\t1000\t2000\t2.25\n"
                   "chr6\t1000\t2000\t.5\nchr6\t2000\t3000\t0\nchr6\t3000\t3500\t7.\n"
                   "chr7\t0\t9000\t4\nchr6\t3500\t4000\t0012.125",
    "five_fields": "chr6\t0\t1000\t1.5\tx\nchr6\t1000\t2000\t2\n",
    "short_line": "chr6\t0\t1000\t1.5\nchr6\t1000\n\nchr6\t1000\t2000\t2\n",
    "spaces": "chr6\t0\t1000\t1.5 \n chr6\t1000\t2000\t2\r\n",
    "exponent": "chr6\t0\t1000\t1e1\nchr6\t1000\t2000\tnan\n",
    "bad_number": "chr7\t0\t1000\tx\nchr6\t0\t1000\t2\n",
    "negative": "chr6\t-5\t1000\t2\n",
    "empty": "",
}


@pytest.mark.parametrize("name", list(BED_TEXTS))
@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_region_coverage_matches_grid_tpu_s(tmp_path, name, sparse):
    """The port's copy against grid_tpu's on odd files too: the same
    integer, or the same error."""
    from grid_tpu.steps.coverage import compute_region_coverage as jax_coverage
    from grid_tpu_torch.steps.coverage import compute_region_coverage

    path = tmp_path / "t.regions.bed.gz"
    path.write_bytes(gzip.compress(BED_TEXTS[name].encode()))
    for window in ((500, 3700), (0, 10_000), (2000, 3000), (5000, 6000)):
        try:
            want = jax_coverage(path, "chr6", *window, sparse=sparse)
        except ValueError as e:
            with pytest.raises(type(e)):
                compute_region_coverage(path, "chr6", *window, sparse=sparse)
            continue
        assert compute_region_coverage(path, "chr6", *window, sparse=sparse) == want, window


@pytest.mark.parametrize("case", ["bam_indel", "cram"])
@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_region_coverage_of_binner_output_matches_grid_tpu_s(cohorts, tmp_path, case, sparse):
    from grid_tpu.steps.coverage import compute_region_coverage as jax_coverage
    from grid_tpu_torch.steps.coverage import compute_region_coverage

    _, port_c = cohorts[case]
    cfg = port_c["config"]
    binner = port_cram if case.startswith("cram") else port_bam
    for i, path in enumerate(files_of(port_c)[:3]):
        bed = tmp_path / f"{i}.regions.bed.gz"
        binner.binned_depth(str(path), str(bed), 1000, skip_zero=sparse)
        for window in ((cfg["start_bp"], cfg["end_bp"]), (160_605_000, 160_615_000),
                       (160_605_500, 160_605_700)):
            got = compute_region_coverage(bed, cfg["chrom"], *window, sparse=sparse)
            assert got == jax_coverage(bed, cfg["chrom"], *window, sparse=sparse) > 0


@pytest.mark.parametrize("case", sorted(COHORTS))
def test_built_indexes_match_grid_tpu(cohorts, tmp_path, frozen_gzip, case):
    """A ``.bai`` from the native builder, a ``.crai`` from cramlite's (as
    ``create_index_for_file`` picks them without pysam); the port's native
    count through its own index equals grid_tpu's through grid_tpu's."""
    jax_c, port_c = cohorts[case]
    ours, theirs = files_of(port_c)[0], files_of(jax_c)[0]
    work = {}
    for name, path in (("port", ours), ("jax", theirs)):
        work[name] = tmp_path / name / path.name
        work[name].parent.mkdir()
        shutil.copy(path, work[name])
    file_type = COHORTS[case][0]
    alignments.create_index_for_file(str(work["port"]), file_type, None)
    jax_aln.create_index_for_file(str(work["jax"]), file_type, None)
    suffix = ".crai" if file_type == "cram" else ".bai"
    got, want = (Path(f"{work[name]}{suffix}") for name in ("port", "jax"))
    assert got.read_bytes() == want.read_bytes() and got.stat().st_size > 0
    assert alignments.has_index(str(work["port"]), file_type)
    chrom, start, end = windows(port_c["config"])[1]
    assert alignments.count_reads_in_region(work["port"], None, chrom, start, end, FLAGS) == \
        jax_aln.count_reads_in_region(work["jax"], None, chrom, start, end, FLAGS)


@pytest.mark.parametrize("case", ["cram", "cram_indel"])
def test_native_cram_records_and_references_match_cramlite(cohorts, case):
    _, port_c = cohorts[case]
    path = files_of(port_c)[0]
    recs = port_cram.dump_records(str(path))
    np.testing.assert_array_equal(recs, jax_cram.dump_records(str(path)))
    with cramlite.CramReader(str(path)) as reader:
        assert port_cram.references(str(path)) == [tuple(r) for r in reader.references] \
            == jax_cram.references(str(path))
        assert len(recs) == sum(1 for _ in reader.iter_records(decode_seq=False))


def test_bam_references_match_grid_tpu(cohorts):
    jax_c, port_c = cohorts["bam"]
    assert port_bam.references(files_of(port_c)[0]) == jax_bam.references(files_of(jax_c)[0])


@pytest.mark.parametrize("sample,hit", [("SYN00001", "SYN00001.bam"), ("SYN0000", "SYN00000.bam"),
                                        ("SYN*3", "SYN00003.bam"), ("NOPE", None)])
def test_find_files_matches_grid_tpu(cohorts, sample, hit):
    _, port_c = cohorts["bam"]
    directory = port_c["config"]["directory_loc"]
    got = alignments.find_files(directory, [sample], "bam")[sample]
    assert got == jax_aln.find_files(directory, [sample], "bam")[sample]
    assert got == alignments.find_file(directory, sample, "bam")
    assert (Path(got).name if got else None) == hit


# -------------------------------------------------------------- pipeline ---


def pipeline_config(cohort, out: Path, device: dict, index_run, **sections) -> dict:
    """The cohort's config with its own alignments copy, output and work
    directories under ``out``; ``sections`` update the named sections."""
    cfg = copy.deepcopy(cohort["config"])
    out.mkdir(parents=True)
    aln = out / "alignments"
    shutil.copytree(cfg["directory_loc"], aln)
    cfg.update(directory_loc=str(aln), output_dir=str(out / "results"), threads=2,
               device=dict(device))
    cfg["mosdepth"]["work_dir"] = str(out / "work")
    cfg["index"]["run"] = index_run
    for name, values in sections.items():
        cfg[name].update(values)
    return cfg


def run_both(cohorts, case, base: Path, device: dict, index_run=True, port_patch=None,
             **sections):
    """grid_tpu's and the port's pipelines on their own copies of one
    cohort's files. A check of the indexes (``index_run`` False) finds the
    indexes each package's own step 1 made first. Returns the two configs
    and timings and the port's console."""
    jax_c, port_c = cohorts[case]
    jax_cfg = pipeline_config(jax_c, base / "jax", device, index_run, **sections)
    port_cfg = pipeline_config(port_c, base / "torch", {**device, "platform": "cpu"}, index_run,
                               **sections)
    if index_run is False:
        jax_create_index(jax_cfg, None)
        port_index.create_index(port_cfg, None)
    with pytest.MonkeyPatch.context() as mp:
        for obj, name, value in port_patch or ():
            mp.setattr(obj, name, value)
        console = Recorder()
        t_port = run_wgs_pipeline(console=console, config=copy.deepcopy(port_cfg))
    t_jax = jax_pipeline.run_wgs_pipeline(console=None, config=copy.deepcopy(jax_cfg))
    return SimpleNamespace(jax=jax_cfg, port=port_cfg, t_jax=t_jax, t_port=t_port,
                           console=console)


def assert_steps_1_3_identical(run, file_type):
    jax_out, port_out = Path(run.jax["output_dir"]), Path(run.port["output_dir"])
    for name in STEP_1_3:
        got, want = rows(port_out / name), rows(jax_out / name)
        assert got == want, name
        assert len(got[1]) == N and "Error" not in str(got[1])
    status = sorted(p.name for p in jax_out.glob("index_file_results.*"))
    assert sorted(p.name for p in port_out.glob("index_file_results.*")) == status
    for name in status:
        assert (port_out / name).read_bytes() == (jax_out / name).read_bytes()
    beds = sorted(p.name for p in Path(run.jax["mosdepth"]["work_dir"]).iterdir())
    assert sorted(p.name for p in Path(run.port["mosdepth"]["work_dir"]).iterdir()) == beds
    assert len(beds) == N
    for name in beds:
        assert content(Path(run.port["mosdepth"]["work_dir"]) / name) == content(
            Path(run.jax["mosdepth"]["work_dir"]) / name), name
    suffix = ".crai" if file_type == "cram" else ".bai"
    for ours, theirs in zip(sorted(Path(run.port["directory_loc"]).glob(f"*{suffix}")),
                            sorted(Path(run.jax["directory_loc"]).glob(f"*{suffix}"))):
        assert ours.read_bytes() == theirs.read_bytes(), ours.name


def assert_steps_4_7_within_contract(run):
    jax_out, port_out = Path(run.jax["output_dir"]), Path(run.port["output_dir"])
    assert content(port_out / NORMALIZED) == content(jax_out / NORMALIZED)
    if content(port_out / NEIGHBORS) != content(jax_out / NEIGHBORS):
        lists = []
        for out in (port_out, jax_out):
            nbrs, _ = read_neighbors(out / NEIGHBORS)
            row = {s: i for i, s in enumerate(nbrs)}
            lists.append((np.array([[row[n] for n, _, _ in nbrs[s]] for s in nbrs]),
                          np.array([[d for _, _, d in nbrs[s]] for s in nbrs])))
        np.testing.assert_array_equal(lists[0][1], lists[1][1])
        neighbor_rows_differing(lists[0][0], lists[0][1], lists[1][0], lists[1][1], tol=0.0)
    t_ids, t_vals, _ = read_dipcn(port_out / DIPCN)
    j_ids, j_vals, _ = read_dipcn(jax_out / DIPCN)
    assert t_ids == j_ids and len(t_ids) == N
    np.testing.assert_allclose(t_vals, j_vals, rtol=1e-9, atol=0)
    t_lines, j_lines = ((out / HAPLOID).read_text().splitlines() for out in (port_out, jax_out))
    assert t_lines[0] == j_lines[0] and len(t_lines) == len(j_lines) == N + 1
    for t, j in zip(t_lines[1:], j_lines[1:]):
        assert t.split("\t")[0] == j.split("\t")[0]
        np.testing.assert_allclose(np.array(t.split("\t")[1:], float),
                                   np.array(j.split("\t")[1:], float), rtol=0, atol=1e-9)


WGS = {  # id -> (cohort, device, index.run, port's CRAM reader)
    "bam-fused-create": ("bam", {"fused": True, "dtype": "float64"}, True, "native"),
    "bam-files-check": ("bam_indel", {"dtype": "float64"}, False, "native"),
    "cram-fused-check": ("cram_indel", {"fused": True, "dtype": "float64"}, False, "native"),
    "cram-files-create": ("cram", {"dtype": "float64"}, True, "native"),
    "cramlite-fused-create": ("cram_indel", {"fused": True, "dtype": "float64"}, True,
                              "cramlite"),
}


@pytest.mark.parametrize("key", list(WGS))
def test_wgs_from_alignments_matches_grid_tpu(cohorts, tmp_path, key):
    """The example config's shape (steps 1-7 on, BAM or CRAM): the port's
    ``run_wgs_pipeline`` against grid_tpu's. The cramlite case hides the
    host library from the port, so its readers are cramlite's and the
    one-pass ingest is off (the sequential steps run)."""
    case, device, index_run, reader = WGS[key]
    patch = [(native_host, "lib", lambda: None)] if reader == "cramlite" else None
    run = run_both(cohorts, case, tmp_path, device, index_run, port_patch=patch)
    assert_steps_1_3_identical(run, COHORTS[case][0])
    assert_steps_4_7_within_contract(run)
    step1 = "create_index" if index_run else "check_index"
    assert step1 in run.t_port and step1 in run.t_jax
    one_pass = reader == "native"
    assert ("fused_ingest_2_3" in run.t_port) is one_pass
    assert ("count_reads" in run.t_port and "mosdepth" in run.t_port) is not one_pass
    assert ("fused_steps_4_7" in run.t_port) is bool(device.get("fused"))
    assert run.console.styled("danger") == []
    assert not [m for m in run.console.styled("warning") if "failed" in m or "loop" in m]


def test_steps_1_3_alone_need_no_card(cohorts, tmp_path, monkeypatch):
    """Steps 4-7 off and no platform named: the pipeline resolves no device
    (it would raise here), as grid_tpu runs these steps on the host."""
    import grid_tpu_torch.pipeline as pipeline

    def no_device(config):
        raise AssertionError("a device was resolved")

    monkeypatch.setattr(pipeline, "config_device", no_device)
    off = {"run": False}
    jax_c, port_c = cohorts["bam"]
    cfgs = []
    for name, cohort in (("jax", jax_c), ("torch", port_c)):
        cfg = pipeline_config(cohort, tmp_path / name, {}, True,
                              compute_diploid_genotypes=off, compute_haploid_genotypes=off)
        cfg["mosdepth"]["normalize"]["run"] = cfg["mosdepth"]["neighbors"]["run"] = False
        cfgs.append(cfg)
    jax_pipeline.run_wgs_pipeline(console=None, config=copy.deepcopy(cfgs[0]))
    timings = run_wgs_pipeline(console=None, config=copy.deepcopy(cfgs[1]))
    assert set(timings) == {"create_index", "fused_ingest_2_3"}
    assert_steps_1_3_identical(SimpleNamespace(jax=cfgs[0], port=cfgs[1]), "bam")
    assert sorted(p.name for p in Path(cfgs[1]["output_dir"]).iterdir()) == sorted([
        ".grid_tpu_state.json", *STEP_1_3, "step_timings.json"])


def test_missing_and_unindexed_files_are_reported_as_grid_tpu_does(cohorts, tmp_path):
    """One sample's file removed, another's index removed: the check writes
    the same status file; counting and coverage skip the missing sample."""
    jax_c, port_c = cohorts["bam"]
    outs = []
    for name, cohort, create, run in (
            ("jax", jax_c, jax_create_index, jax_pipeline.run_wgs_pipeline),
            ("torch", port_c, port_index.create_index, run_wgs_pipeline)):
        cfg = pipeline_config(cohort, tmp_path / name, {"platform": "cpu"}, False)
        for section in ("compute_diploid_genotypes", "compute_haploid_genotypes"):
            cfg[section]["run"] = False
        cfg["mosdepth"]["normalize"]["run"] = cfg["mosdepth"]["neighbors"]["run"] = False
        create(cfg, None)
        aln = Path(cfg["directory_loc"])
        (aln / "SYN00002.bam").unlink()
        (aln / "SYN00002.bam.bai").unlink()
        (aln / "SYN00004.bam.bai").unlink()
        run(console=None, config=cfg)
        outs.append(Path(cfg["output_dir"]))
    status = (outs[1] / "index_file_results.tsv").read_text()
    assert status == (outs[0] / "index_file_results.tsv").read_text()
    assert "SYN00002\tMissing file" in status and "SYN00004\tMissing index" in status
    for name in STEP_1_3:
        assert rows(outs[1] / name) == rows(outs[0] / name)
        assert len(rows(outs[1] / name)[1]) == N - 1


# ------------------------------------------------------------------- CLI ---


def test_step_commands_match_grid_tpu_s_steps(cohorts, tmp_path):
    """``crai``, ``check-index``, ``count-reads`` and ``mosdepth`` from a
    YAML config, against grid_tpu's step functions on their own copy."""
    import yaml
    from click.testing import CliRunner

    from grid_tpu.steps.count_reads import count_reads as jax_count_reads
    from grid_tpu.steps.coverage import compute_mosdepth as jax_compute_mosdepth
    from grid_tpu.steps.index import check_index as jax_check_index
    from grid_tpu_torch.cli import cli

    jax_c, port_c = cohorts["cram_indel"]
    port_cfg = pipeline_config(port_c, tmp_path / "torch", {}, False)
    jax_cfg = pipeline_config(jax_c, tmp_path / "jax", {}, False)
    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump(port_cfg))
    for command, jax_step in (("crai", jax_create_index), ("check-index", jax_check_index),
                              ("count-reads", jax_count_reads),
                              ("mosdepth", jax_compute_mosdepth)):
        result = CliRunner().invoke(cli, [command, str(path)])
        assert result.exit_code == 0, result.output
        jax_step(copy.deepcopy(jax_cfg), None)
    run = SimpleNamespace(jax=jax_cfg, port=port_cfg)
    assert_steps_1_3_identical(run, "cram")
    status = Path(port_cfg["output_dir"]) / "index_file_results.tsv"
    assert status.read_text().count("\tHas index\n") == N


# ---------------------------------------------------------- multi-locus ---

GENES = ("GENEA", "GENEB", "GENEC")
CATALOG = (
    "CHR\tBP_START_HG38\tBP_END_HG38\tSAMTOOLS_START_HG38\tSAMTOOLS_END_HG38\tIBD2R\tGENE\n"
    "6\t160605000\t160610000\t160605000\t160610000\t0.9\tGENEA\n"
    "6\t160607000\t160612000\t160607000\t160612000\t0.8\tGENEB\n"
    "6\t160610000\t160615000\t160610000\t160615000\t0.7\tGENEC\n"
)


@pytest.mark.parametrize("one_pass", [True, False], ids=["one_pass", "per_locus"])
def test_multi_locus_counts_reads_as_grid_tpu(cohorts, tmp_path, one_pass):
    """``count_reads.run: true`` in the sweep: every locus's window counted
    in the shared one-pass scan, or (one-pass ingest off) one count per
    locus; the per-locus counts files and dipCN tables against grid_tpu's."""
    catalog = tmp_path / "catalog.txt"
    catalog.write_text(CATALOG)
    jax_c, port_c = cohorts["bam"]
    device = {"fused_ingest": "true" if one_pass else "false", "dtype": "float64"}
    cfgs = [pipeline_config(c, tmp_path / name, device, None,
                            compute_haploid_genotypes={"run": False})
            for name, c in (("jax", jax_c), ("torch", port_c))]
    cfgs[1]["device"]["platform"] = "cpu"
    console = Recorder()
    jax_run_multi_locus(copy.deepcopy(cfgs[0]), list(GENES), None, catalog)
    run_multi_locus(copy.deepcopy(cfgs[1]), list(GENES), console, catalog)
    outs = [Path(cfg["output_dir"]) for cfg in cfgs]
    counted = [m for m in console.styled("info") if " count_reads " in m]
    assert len(counted) == (0 if one_pass else len(GENES))
    for gene in GENES:
        name = f"read_counts.{gene}.tsv"
        got, want = rows(outs[1] / name), rows(outs[0] / name)
        assert got == want and len(got[1]) == N
        t_ids, t_vals, _ = read_dipcn(outs[1] / f"diploid_genotypes.{gene}.tsv")
        j_ids, j_vals, _ = read_dipcn(outs[0] / f"diploid_genotypes.{gene}.tsv")
        assert t_ids == j_ids
        np.testing.assert_allclose(t_vals, j_vals, rtol=1e-9, atol=0)
    assert not (outs[1] / "read_counts.tsv").exists()
