"""The port's utilities: per-step traces (``GRID_TPU_PROFILE_DIR``) and the
build cache (``device.compilation_cache``).

Traces: with the variable set, ``run_wgs_pipeline`` in file mode and in
fused mode writes one Chrome trace per outermost step, holds the inner
spans as ranges of it, and writes the four artifacts byte for byte as an
unprofiled run does (grid_tpu's nested ``jax.profiler`` traces raise
there, ROADMAP.md queue 3). The cache: the directory resolves from the
argument, then ``GRID_TPU_COMPILE_CACHE``; the first call wins; spawned
ranks build there too; a directory that cannot be made raises; and the
host library builds into it here (g++ is present; nvcc and Triton are not,
so their libraries' place is checked by path, and by build on the card in
``tests/test_torch_gpu.py``).
"""

import copy
import gzip
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import torch_ranks
from grid_tpu_torch import native, native_host
from grid_tpu_torch.parallel import run_ranks
from grid_tpu_torch.parallel.mesh import RankWorkspace
from grid_tpu_torch.pipeline import run_wgs_pipeline
from grid_tpu_torch.synth import make_synthetic_cohort
from grid_tpu_torch.utils import device, timing
from grid_tpu_torch.utils.timing import PROFILE_ENV, StepTimer, step_timer

REPO = Path(__file__).resolve().parent.parent
ARTIFACTS = ("mosdepth_results_normalized.tsv.gz", "neighbor_coverage.zMax2.0.tsv.gz",
             "diploid_genotypes.tsv", "haploid_genotypes.tsv")
FILE_STEPS = ("normalize", "neighbors", "compute_diploid_genotypes", "compute_haploid_genotypes")
INNER = {"normalize": ("normalize.stage", "normalize.device"),
         "neighbors": ("neighbors.read", "neighbors.device"),
         "compute_diploid_genotypes": ("dipcn.read", "dipcn.stage", "dipcn.device"),
         "compute_haploid_genotypes": ("haploid.phase",),
         "fused_steps_4_7": ("fused.stage", "fused.device", "fused.phase", "fused.write")}


class Recorder:
    """A console that keeps what the pipeline logs."""

    def __init__(self):
        self.lines = []

    def print(self, msg, style=None):
        self.lines.append((msg, style))


def content(path) -> bytes:
    return gzip.open(path).read() if str(path).endswith(".gz") else path.read_bytes()


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    return make_synthetic_cohort(tmp_path_factory.mktemp("cohort"), n_samples=5, seed=1)


def config(cohort, out: Path, **device_keys) -> dict:
    cfg = copy.deepcopy(cohort["config"])
    out.mkdir(parents=True, exist_ok=True)
    cfg["output_dir"] = str(out)
    cfg["device"] = {"platform": "cpu", **device_keys}
    (out / "read_counts.tsv").write_bytes(cohort["counts_file"].read_bytes())
    return cfg


def event_names(trace: Path) -> set:
    return {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}


@pytest.fixture(scope="module", params=["files", "fused"])
def profiled(request, cohort, tmp_path_factory):
    """One profiled and one unprofiled run of the pipeline."""
    mode = {"files": {}, "fused": {"fused": True}}[request.param]
    base = tmp_path_factory.mktemp(request.param)
    plain = run_wgs_pipeline(config=config(cohort, base / "plain", **mode))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(PROFILE_ENV, str(base / "traces"))
        timings = run_wgs_pipeline(config=config(cohort, base / "profiled", **mode))
    return request.param, base, plain, timings


def test_one_trace_per_outermost_step_with_its_spans_as_ranges(profiled):
    mode, base, _, timings = profiled
    steps = FILE_STEPS if mode == "files" else ("fused_steps_4_7",)
    outer = [name for name in timings if "." not in name]  # check_index among them
    assert set(steps) <= set(outer)
    traces = base / "traces"
    assert sorted(p.name for p in traces.iterdir()) == sorted(outer)
    for step in outer:
        trace = traces / step / "trace.json"
        assert sorted(p.name for p in trace.parent.iterdir()) == ["trace.json"]
        names = event_names(trace)
        for span in INNER.get(step, ()):
            assert span in names, (step, span)
            assert span in timings, span  # and timed as without the variable


def test_profiled_artifacts_equal_the_unprofiled_run_s(profiled):
    _, base, plain, timings = profiled
    assert set(plain) == set(timings)
    for name in ARTIFACTS:
        assert content(base / "profiled" / name) == content(base / "plain" / name), name


def test_a_step_that_raises_still_writes_its_trace(tmp_path, monkeypatch):
    monkeypatch.setenv(PROFILE_ENV, str(tmp_path))
    timer = StepTimer()
    with pytest.raises(ValueError, match="on purpose"):
        with step_timer("failing", timer):
            with step_timer("failing.inner", timer):
                torch.ones(3).sum()
                raise ValueError("on purpose")
    trace = tmp_path / "failing" / "trace.json"
    assert "failing.inner" in event_names(trace)
    assert not (tmp_path / "failing.inner").exists()
    assert set(timer.report()) == {"failing", "failing.inner"}
    assert timing._OPEN["depth"] == 0
    # the next outermost step opens a profiler of its own
    with step_timer("next", timer):
        pass
    assert (tmp_path / "next" / "trace.json").exists()


def test_without_the_variable_no_trace_is_written(tmp_path, monkeypatch):
    monkeypatch.delenv(PROFILE_ENV, raising=False)
    monkeypatch.chdir(tmp_path)
    timer = StepTimer()
    with step_timer("quiet", timer):
        with step_timer("quiet.inner", timer):
            pass
    assert list(tmp_path.iterdir()) == []
    assert set(timer.report()) == {"quiet", "quiet.inner"}


@pytest.fixture
def fresh_cache(monkeypatch):
    """No build cache named yet in this process; the variables restored
    after the test."""
    monkeypatch.setattr(device, "_CACHE", {})
    for name in (device.CACHE_ENV, device.TRITON_CACHE_ENV):
        # set first so that the restore also removes a variable that was
        # not set before (delenv alone records nothing then, and the
        # cache's own os.environ writes would outlive the test)
        monkeypatch.setenv(name, "")
        monkeypatch.delenv(name)


def test_the_argument_names_the_cache_and_the_first_call_wins(fresh_cache, tmp_path):
    first = device.enable_compilation_cache(tmp_path / "a")
    assert first == tmp_path / "a" and first.is_dir()
    assert device.enable_compilation_cache(tmp_path / "b") == first
    assert not (tmp_path / "b").exists()
    assert native.build_dir() == native_host.build_dir() == first
    for name in native.KERNELS:
        assert native.library_path(name).parent == first
    assert native_host.library_path().parent == first
    assert device.os.environ[device.TRITON_CACHE_ENV] == str(first / "triton")


def test_the_variable_names_the_cache_when_no_argument_does(fresh_cache, tmp_path, monkeypatch):
    monkeypatch.setenv(device.CACHE_ENV, str(tmp_path / "env"))
    monkeypatch.setenv(device.TRITON_CACHE_ENV, str(tmp_path / "own-triton"))
    assert device.enable_compilation_cache() == tmp_path / "env"
    assert (tmp_path / "env").is_dir()
    # a Triton cache named already stays
    assert device.os.environ[device.TRITON_CACHE_ENV] == str(tmp_path / "own-triton")


def test_with_no_directory_the_default_stays(fresh_cache, tmp_path):
    assert device.enable_compilation_cache() is None
    assert device.enable_compilation_cache(tmp_path / "late") is None  # the first call won
    assert native.build_dir() == native.BUILD_DIR
    assert native_host.build_dir() == native_host.BUILD_DIR == REPO / "build" / "grid_tpu_torch"
    assert device.CACHE_ENV not in device.os.environ


def test_a_directory_that_cannot_be_made_raises_with_its_path(fresh_cache, tmp_path):
    (tmp_path / "file").write_text("")
    bad = tmp_path / "file" / "cache"
    with pytest.raises(OSError, match=str(bad)):
        device.enable_compilation_cache(bad)
    assert device.CACHE_ENV not in device.os.environ
    assert device.enable_compilation_cache(tmp_path / "ok") == tmp_path / "ok"


def test_spawned_ranks_build_into_the_parent_s_cache(fresh_cache, tmp_path):
    cache = device.enable_compilation_cache(tmp_path / "cache")
    with RankWorkspace() as ws:
        reports = run_ranks(torch_ranks.cache_rank, 2, (), platform="cpu", workspace=ws)
    for rep in reports:
        assert rep["build_dir"] == str(cache)
        assert rep["triton_cache"] == str(cache / "triton")


def test_the_pipeline_names_the_cache_and_logs_a_library_loaded_elsewhere(fresh_cache, cohort,
                                                                        tmp_path):
    assert native_host.route() == "native"
    loaded = native_host.loaded_paths()[0]
    cfg = config(cohort, tmp_path / "out", compilation_cache=str(tmp_path / "cache"))
    console = Recorder()
    run_wgs_pipeline(console=console, config=cfg)
    assert device._CACHE["dir"] == tmp_path / "cache"
    said = [msg for msg, _ in console.lines if "stays loaded from" in msg]
    assert said == [f"{loaded.name} stays loaded from {loaded.parent}: it was built before the "
                    f"build cache {tmp_path / 'cache'} was named"]
    assert native_host.loaded_paths() == [loaded]  # not loaded again


_BUILD_HOST = r"""
import sys
from grid_tpu_torch.utils.device import enable_compilation_cache
cache = enable_compilation_cache(sys.argv[1])
from grid_tpu_torch import native_host
assert native_host.route() == "native", native_host.route()
print(native_host.loaded_paths()[0])
"""


def test_the_host_library_builds_into_the_cache(tmp_path):
    env = {k: v for k, v in device.os.environ.items()
           if k not in (device.CACHE_ENV, device.TRITON_CACHE_ENV)}
    proc = subprocess.run([sys.executable, "-c", _BUILD_HOST, str(tmp_path)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    built = Path(proc.stdout.strip())
    assert built.parent == tmp_path and built.name == native_host.library_path().name
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        [built.name, built.with_suffix(".log").name])
