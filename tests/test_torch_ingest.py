"""The port's one-pass ingest (steps 2-3 in one native pass per file,
``grid_tpu_torch/steps/ingest.py``) against grid_tpu's and against the
sequential steps, on fabricated BAM/CRAM cohorts (CPU only).

Each case of :func:`test_one_pass_cases` runs the pipeline's steps 1-4 in
the port and in grid_tpu on the same files: the counts and coverage TSVs
(header and rows; rows compared sorted, they are appended as samples
finish), every regions.bed.gz (decompressed) and the normalized matrix are
identical, and the port's one-pass form equals its sequential form. The
batch call, the staged handoff, the window counts, resume across the two
forms and the fallback counters are held separately.
"""

import copy
import gzip
import json
import shutil
from pathlib import Path

import numpy as np
import pytest

import grid_tpu.pipeline as jax_pipeline
import grid_tpu.steps.ingest as jax_ingest
from grid_tpu.native import _ingest as jax_native_ingest
from grid_tpu.native import bam as jax_bam
from grid_tpu_torch import native_host
from grid_tpu_torch.io.bed import read_regions_bed_gz
from grid_tpu_torch.native_host import _ingest as port_native_ingest
from grid_tpu_torch.native_host import bam as port_bam
from grid_tpu_torch.native_host import cram as port_cram
from grid_tpu_torch.pipeline import run_wgs_pipeline
from grid_tpu_torch.steps import ingest
from grid_tpu_torch.synth import make_synthetic_cohort_with_alignments

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ toolchain")

N = 5
FLAGS = [83, 147, 81, 145]
NORMALIZED = "mosdepth_results_normalized.tsv.gz"


class Recorder:
    def __init__(self):
        self.lines = []

    def print(self, msg, style=None):
        self.lines.append((msg, style))

    def styled(self, *styles):
        return [msg for msg, style in self.lines if style in styles]


@pytest.fixture(scope="module")
def cohorts(tmp_path_factory):
    """file type -> one cohort's files (the port's fabrication equals
    grid_tpu's, ``tests/test_torch_alignments.py``); both packages read
    copies of it."""
    from grid_tpu import native

    native.lib()
    return {ft: make_synthetic_cohort_with_alignments(tmp_path_factory.mktemp(ft), n_samples=N,
                                                      seed=23, file_type=ft, indel_frac=0.1)
            for ft in ("bam", "cram")}


@pytest.fixture(autouse=True)
def clear_fallbacks():
    native_host.fallbacks.clear()
    yield
    native_host.fallbacks.clear()


def config(cohort, out: Path, fused_ingest, **device) -> dict:
    """Steps 1-4 of the cohort's config on a copy of its files under
    ``out`` (index created; neighbors, dipCN and phasing off)."""
    cfg = copy.deepcopy(cohort["config"])
    out.mkdir(parents=True)
    shutil.copytree(cfg["directory_loc"], out / "alignments")
    cfg.update(directory_loc=str(out / "alignments"), output_dir=str(out / "results"),
               threads=2, device={"fused_ingest": fused_ingest, **device})
    cfg["mosdepth"]["work_dir"] = str(out / "work")
    cfg["mosdepth"]["neighbors"]["run"] = False
    cfg["compute_diploid_genotypes"]["run"] = cfg["compute_haploid_genotypes"]["run"] = False
    return cfg


def outputs(cfg) -> dict:
    out, work = Path(cfg["output_dir"]), Path(cfg["mosdepth"]["work_dir"])
    got = {}
    for name in ("read_counts.tsv", "mosdepth_results.tsv"):
        if (out / name).exists():
            lines = (out / name).read_text().splitlines()
            got[name] = (lines[0], sorted(lines[1:]))
    got["beds"] = {p.name: gzip.open(p).read() for p in sorted(work.glob("*.regions.bed.gz"))}
    if (out / NORMALIZED).exists():
        got["normalized"] = gzip.open(out / NORMALIZED).read()
    return got


def corrupt_second_file(cfg):
    victim = sorted(Path(cfg["directory_loc"]).glob(f"*.{cfg['file_type']}"))[1]
    victim.write_bytes(b"not an alignment file at all")
    return victim


def fail_native_ingest(mp, bam_module):
    def boom(*args, **kwargs):
        raise IOError("native ingest refused by the test")

    mp.setattr(bam_module, "ingest", boom)
    mp.setenv("GRID_TPU_BATCH_INGEST", "0")


# case -> (file type, config edits, what to do to both packages' runs)
CASES = {
    "bam": ("bam", {}, None),
    "cram": ("cram", {}, None),
    "sparse": ("bam", {"mosdepth": {"sparse_bed": True}}, None),
    "coverage_only": ("cram", {"count_reads": {"run": False}}, None),
    "bad_sample": ("bam", {}, "corrupt"),
    "per_sample_fallback": ("bam", {}, "native_fails"),
    "threaded_loop": ("cram", {}, "no_batch"),
    "ram_guard": ("bam", {}, "ram_guard"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_one_pass_cases(cohorts, tmp_path, case):
    file_type, edits, action = CASES[case]
    runs = {}
    for name, fused_ingest in (("port", "true"), ("port_seq", "false"), ("jax", "true")):
        cfg = config(cohorts[file_type], tmp_path / name, fused_ingest,
                     **({"platform": "cpu"} if name.startswith("port") else {}))
        for section, values in edits.items():
            cfg[section].update(values)
        console = Recorder()
        with pytest.MonkeyPatch.context() as mp:
            if action == "corrupt":
                corrupt_second_file(cfg)
            elif action == "native_fails":
                fail_native_ingest(mp, port_bam if name.startswith("port") else jax_bam)
            elif action == "no_batch":
                mp.setenv("GRID_TPU_BATCH_INGEST", "0")
            elif action == "ram_guard":
                mp.setattr(ingest if name.startswith("port") else jax_ingest,
                           "_available_ram_bytes", lambda: 1)
            native_host.fallbacks.clear()
            if name == "jax":
                timings = jax_pipeline.run_wgs_pipeline(console=None, config=cfg)
            else:
                timings = run_wgs_pipeline(console=console, config=cfg)
        runs[name] = (outputs(cfg), timings, console, dict(native_host.fallbacks))

    port, port_seq, jax = (runs[name][0] for name in ("port", "port_seq", "jax"))
    assert port == jax
    assert port == port_seq
    assert len(port["beds"]) == N - (action == "corrupt")
    assert "normalized" in port
    assert ("read_counts.tsv" in port) is (case != "coverage_only")
    t_port, t_seq = runs["port"][1], runs["port_seq"][1]
    assert "fused_ingest_2_3" in t_port and "mosdepth" not in t_port
    assert "fused_ingest_2_3" not in t_seq and "mosdepth" in t_seq
    if action == "corrupt":
        assert port["read_counts.tsv"][1][1].endswith("\tError")
        assert len(port["mosdepth_results.tsv"][1]) == N - 1
    # the fallbacks each case takes, counted by kind, in the one-pass run;
    # none in the sequential run
    want = {"bad_sample": {"per_sample": 1}, "per_sample_fallback": {"per_sample": N},
            "ram_guard": {"per_sample_loop": 1}}.get(case, {})
    assert runs["port"][3] == want and runs["port_seq"][3] == {}
    warned = runs["port"][2].styled("warning")
    assert any("using the per-sample loop" in m for m in warned) is (case == "ram_guard")
    assert not any(m.startswith("One-pass ingest failed") for m in warned)


def test_staged_bins_equal_the_written_files_and_grid_tpu_s(cohorts, tmp_path):
    """The staged arrays handed to step 4 equal a re-read of the bed.gz the
    same pass wrote, bitwise, and grid_tpu's staged arrays."""
    staged = {}
    for name, run in (("port", ingest.run_fused_ingest), ("jax", jax_ingest.run_fused_ingest)):
        cfg = config(cohorts["bam"], tmp_path / name, "true")
        cfg["mosdepth"]["normalize"]["repeat_mask_file"] = None
        _, _, staged[name] = run(cfg, None)
        work = Path(cfg["mosdepth"]["work_dir"])
        if name == "port":
            for sample, arrays in staged[name].items():
                again = read_regions_bed_gz(work / f"{sample}_SYN.regions.bed.gz", cfg["chrom"],
                                            cfg["start_bp"], cfg["end_bp"], {})
                for got, want in zip(arrays, again):
                    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert sorted(staged["port"]) == sorted(staged["jax"]) and len(staged["port"]) == N
    for sample in staged["port"]:
        for got, want in zip(staged["port"][sample], staged["jax"][sample]):
            assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("file_type", ["bam", "cram"])
def test_batch_matches_per_file_and_grid_tpu_s_batch(cohorts, tmp_path, file_type):
    """One ``grid_ingest_batch`` call against the per-file wrapper and
    grid_tpu's batch call: counts, coverage, staged bins, window counts
    (one window on a chromosome the file lacks) and the bed.gz bytes."""
    cfg = cohorts[file_type]["config"]
    chrom, start, end = cfg["chrom"], cfg["start_bp"], cfg["end_bp"]
    paths = sorted(Path(cfg["directory_loc"]).glob(f"*.{file_type}"))
    windows = [(chrom, start, (start + end) // 2), ("chrMISSING", 0, 100),
               (chrom.removeprefix("chr"), 160_605_000, 160_615_000)]
    got, want = {}, {}
    for name, batch, out in (("port", port_native_ingest.ingest_batch, got),
                             ("jax", jax_native_ingest.ingest_batch, want)):
        entries = [(str(p), str(tmp_path / f"{name}{i}.bed.gz")) for i, p in enumerate(paths)]
        progress, stats = np.zeros(1, np.int64), {}
        out["res"] = batch(entries, chrom, start, end, FLAGS, threads=3, windows=windows,
                           progress=progress, thread_stats=stats)
        out["beds"] = [Path(b).read_bytes() for _, b in entries]
        assert int(progress[0]) == len(paths)
        assert stats["n_threads"] == 3 and len(stats["busy_s"]) == 3 == len(stats["cpu_s"])
    status, counts, covs, bins, wc = got["res"]
    assert list(status) == [0] * len(paths)
    for a, b in zip(got["res"][:3], want["res"][:3]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(wc, want["res"][4])
    assert (wc[:, 1] == (-1 if file_type == "cram" else 0)).all()
    assert got["beds"] == want["beds"]
    backend = port_cram if file_type == "cram" else port_bam
    for i, path in enumerate(paths):
        one = backend.ingest(str(path), str(tmp_path / f"one{i}.bed.gz"), chrom, start, end,
                             FLAGS, windows=windows)
        assert (one[0], one[1]) == (int(counts[i]), int(covs[i]))
        for a, b, c in zip(one[2:6], bins[i], want["res"][3][i]):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(one[6], wc[i])
        assert (tmp_path / f"one{i}.bed.gz").read_bytes() == got["beds"][i]


def test_batch_isolates_a_bad_file(cohorts, tmp_path):
    cfg = copy.deepcopy(cohorts["bam"]["config"])
    paths = sorted(Path(cfg["directory_loc"]).glob("*.bam"))
    bad = tmp_path / "bad.bam"
    bad.write_bytes(b"garbage, not a BAM")
    entries = [(str(paths[0]), ""), (str(bad), ""), (str(paths[1]), "")]
    status, counts, _, bins, _ = port_native_ingest.ingest_batch(
        entries, cfg["chrom"], cfg["start_bp"], cfg["end_bp"], FLAGS, threads=2)
    assert int(status[1]) != 0 and int(status[0]) == int(status[2]) == 0
    assert int(counts[0]) > 0 and int(counts[2]) > 0 and bins[1] is None
    want = jax_native_ingest.ingest_batch(entries, cfg["chrom"], cfg["start_bp"],
                                          cfg["end_bp"], FLAGS, threads=2)
    np.testing.assert_array_equal(status, want[0])


def test_a_failed_one_pass_falls_back_to_the_sequential_steps(cohorts, tmp_path, monkeypatch):
    """The one-pass step itself raising: a warning, one count of
    ``sequential_steps``, and the sequential steps write the same files."""
    import grid_tpu_torch.pipeline as pipeline

    def boom(*args, **kwargs):
        raise RuntimeError("one pass refused by the test")

    cfg = config(cohorts["bam"], tmp_path / "failed", "true", platform="cpu")
    monkeypatch.setattr(pipeline, "run_fused_ingest", boom)
    console = Recorder()
    timings = run_wgs_pipeline(console=console, config=cfg)
    assert "count_reads" in timings and "mosdepth" in timings
    assert console.styled("warning")[-1] == (
        "One-pass ingest failed (one pass refused by the test); falling back to sequential "
        "steps 2-3")
    assert dict(native_host.fallbacks) == {"sequential_steps": 1}
    monkeypatch.undo()
    again = config(cohorts["bam"], tmp_path / "one_pass", "true", platform="cpu")
    run_wgs_pipeline(console=None, config=again)
    assert outputs(cfg) == outputs(again)


def state(cfg) -> dict:
    return json.loads((Path(cfg["output_dir"]) / ".grid_tpu_state.json").read_text())


@pytest.mark.parametrize("first", ["true", "false"], ids=["one_pass_first", "sequential_first"])
def test_resume_across_one_pass_and_sequential(cohorts, tmp_path, first):
    """Either form's resume marks let the other skip steps 2-3; a changed
    count_reads section re-runs only step 2, sequentially (the one pass
    would rewrite the valid coverage file)."""
    cfg = config(cohorts["bam"], tmp_path / "run", first, platform="cpu")
    cfg["index"]["run"] = None
    cfg["mosdepth"]["normalize"]["run"] = False
    run_wgs_pipeline(console=None, config=copy.deepcopy(cfg))
    marks = state(cfg)
    assert {"count_reads", "mosdepth"} <= set(marks)
    other = copy.deepcopy(cfg)
    other["resume"] = True
    other["device"]["fused_ingest"] = "false" if first == "true" else "true"
    console = Recorder()
    timings = run_wgs_pipeline(console=console, config=copy.deepcopy(other))
    assert not {"count_reads", "mosdepth", "fused_ingest_2_3"} & set(timings)
    assert any("up-to-date, skipped (resume)" in m for m in console.styled("info"))
    assert state(cfg) == marks
    other["count_reads"]["flags"] = [83, 147]
    console = Recorder()
    timings = run_wgs_pipeline(console=console, config=copy.deepcopy(other))
    assert "count_reads" in timings and "mosdepth" not in timings
    assert "fused_ingest_2_3" not in timings
    assert state(cfg)["mosdepth"] == marks["mosdepth"]


def test_fused_ingest_enabled_follows_grid_tpu_s_rule(cohorts, monkeypatch):
    base = cohorts["bam"]["config"]
    variants = [({}, None), ({"fused_ingest": "false"}, None), ({}, "mosdepth_off"),
                ({}, "vcf"), ({"fused_ingest": "true"}, "mosdepth_on_path"),
                ({}, "mosdepth_on_path")]
    for device, edit in variants:
        cfg = copy.deepcopy(base)
        cfg["device"] = dict(device)
        if edit == "mosdepth_off":
            cfg["mosdepth"]["run"] = False
        if edit == "vcf":
            cfg["file_type"] = "vcf"
        with monkeypatch.context() as mp:
            if edit == "mosdepth_on_path":
                mp.setattr(ingest, "mosdepth_available", lambda: True)
                mp.setattr(jax_ingest, "mosdepth_available", lambda: True)
            assert ingest.fused_ingest_enabled(cfg) == jax_ingest.fused_ingest_enabled(cfg), \
                (device, edit)
    monkeypatch.setattr(native_host, "lib", lambda: None)
    assert not ingest.fused_ingest_enabled(copy.deepcopy(base))


def test_available_ram_bytes_readable():
    avail = ingest._available_ram_bytes()
    assert avail is None or avail > 0
    assert (avail is None) == (jax_ingest._available_ram_bytes() is None)
