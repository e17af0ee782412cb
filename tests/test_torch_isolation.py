"""grid_tpu_torch stands alone: it imports neither jax nor grid_tpu (the
machines with the card have no JAX), loads no kernel on import, and never
puts a CUDA request on the CPU."""

import ctypes
import os
import subprocess
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from grid_tpu_torch import native
from grid_tpu_torch.utils.device import get_device, resolve_dtype

REPO = Path(__file__).resolve().parent.parent

_IMPORT_ALL = r"""
import importlib, pkgutil, sys

REFUSED = ("jax", "jaxlib", "grid_tpu")

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError(f"grid_tpu_torch must not import {name}")
        return None

for name in [m for m in sys.modules if m.split(".")[0] in REFUSED]:
    del sys.modules[name]
sys.meta_path.insert(0, Refuse())

import grid_tpu_torch
names = sorted(m.name for m in pkgutil.walk_packages(grid_tpu_torch.__path__, "grid_tpu_torch."))
for name in names:
    importlib.import_module(name)
from grid_tpu_torch.io.staging import ShardedCohortStage, bed_source, stage_cohort_sharded
from grid_tpu_torch.parallel import auto_sharded_cohort_step, staged_sharded_cohort_step
from grid_tpu_torch.utils.device import enable_compilation_cache
from grid_tpu_torch.utils.timing import PROFILE_ENV
leaked = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
assert not leaked, leaked
assert "triton" not in sys.modules, "triton is imported at launch time only"
from grid_tpu_torch import native_host
assert not native_host._LOADED, "the host library is built and loaded at first use only"
print("\n".join(names))
"""


def test_every_module_imports_without_jax_or_grid_tpu():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    imported = set(proc.stdout.split())
    for name in ("grid_tpu_torch.models.cohort", "grid_tpu_torch.ops.gpu_kernels",
                 "grid_tpu_torch.ops.gpu_select", "grid_tpu_torch.convert",
                 "grid_tpu_torch.io.hap_neighbors", "grid_tpu_torch.utils.device",
                 "grid_tpu_torch.pipeline", "grid_tpu_torch.steps.fused", "grid_tpu_torch.config",
                 "grid_tpu_torch.synth", "grid_tpu_torch.cli", "grid_tpu_torch.io.staging",
                 "grid_tpu_torch.io.formats", "grid_tpu_torch.io.bed",
                 "grid_tpu_torch.native_host", "grid_tpu_torch.native_host.bedgz",
                 "grid_tpu_torch.steps.normalize", "grid_tpu_torch.steps.neighbors",
                 "grid_tpu_torch.steps.dipcn", "grid_tpu_torch.steps.haploid",
                 "grid_tpu_torch.ops.dipcn", "grid_tpu_torch.data.loci",
                 "grid_tpu_torch.steps.multilocus", "grid_tpu_torch.native_host.bam",
                 "grid_tpu_torch.native_host.cram", "grid_tpu_torch.native_host._ingest",
                 "grid_tpu_torch.io.bamlite", "grid_tpu_torch.io.cramlite",
                 "grid_tpu_torch.ingest.alignments", "grid_tpu_torch.steps.index",
                 "grid_tpu_torch.steps.count_reads", "grid_tpu_torch.steps.coverage",
                 "grid_tpu_torch.steps.ingest", "grid_tpu_torch.ops.align",
                 "grid_tpu_torch.ops.gpu_align", "grid_tpu_torch.models.kiv",
                 "grid_tpu_torch.models.kiv_io", "grid_tpu_torch.models.realign",
                 "grid_tpu_torch.io.fasta", "grid_tpu_torch.parallel.mesh",
                 "grid_tpu_torch.parallel.pstats", "grid_tpu_torch.parallel.pknn",
                 "grid_tpu_torch.parallel.pcohort", "grid_tpu_torch.parallel",
                 "grid_tpu_torch.utils.timing"):
        assert name in imported


_PIPELINE_WITHOUT_EXTRAS = r"""
import sys
for name in ("yaml", "click", "rich", "jax", "jaxlib", "grid_tpu"):
    for loaded in [m for m in sys.modules if m.split(".")[0] == name]:
        del sys.modules[loaded]
    sys.modules[name] = None  # any import of it now raises ImportError

import grid_tpu_torch.config, grid_tpu_torch.pipeline, grid_tpu_torch.steps.fused
from grid_tpu_torch.synth import make_synthetic_cohort
from grid_tpu_torch.utils.logging import make_console

assert make_console() is None
out = sys.argv[1]
cohort = make_synthetic_cohort(out, n_samples=8, seed=3)
assert cohort["config_file"] is None  # no yaml: the dict carries the config
config = cohort["config"]
config["device"] = {"fused": True, "platform": "cpu"}
timings = grid_tpu_torch.pipeline.run_wgs_pipeline(config=config)
assert "fused_steps_4_7" in timings, timings
try:
    grid_tpu_torch.pipeline.run_wgs_pipeline(config=out + "/config.yaml")
except ValueError as e:
    assert "Failed to read the config file" in str(e), e
else:
    raise AssertionError("a config path needs yaml")
print("pipeline ran")
"""


def test_pipeline_runs_without_yaml_click_rich(tmp_path):
    """The machine with the card has none of the three: the pipeline, the
    fused step, the config module and the cohort generator import and run
    from a dict without them."""
    proc = subprocess.run([sys.executable, "-c", _PIPELINE_WITHOUT_EXTRAS, str(tmp_path)], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("pipeline ran")
    assert (tmp_path / "results" / "haploid_genotypes.tsv").exists()


@pytest.mark.parametrize("device", [{"fused": True}, {"fused": True, "platform": "auto"}, {}],
                         ids=["absent", "auto", "file_mode"])
def test_pipeline_without_a_platform_wants_the_card(tmp_path, device):
    """No platform named means the card: on a machine without one the
    pipeline raises get_device's error and never runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    from grid_tpu_torch.pipeline import run_wgs_pipeline
    from grid_tpu_torch.synth import make_synthetic_cohort

    config = make_synthetic_cohort(tmp_path, n_samples=6, seed=1)["config"]
    config["device"] = device
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_wgs_pipeline(config=config)
    assert not (tmp_path / "results" / "diploid_genotypes.tsv").exists()


def test_kernel_library_is_keyed_by_source_and_flags(monkeypatch, tmp_path):
    """A built library is reused only for the same source text and nvcc
    flags, whatever the files' times."""
    for name in native.KERNELS:
        assert native.library_path(name) == native.library_path(name)
        assert native.library_path(name).parent == native.BUILD_DIR
    first = native.library_path("zprep_gram")
    monkeypatch.setattr(native, "NVCC_FLAGS", native.NVCC_FLAGS + ("-lineinfo",))
    assert native.library_path("zprep_gram") != first
    monkeypatch.undo()
    src = tmp_path / "zprep_gram.cu"
    src.write_text((native.CSRC / "zprep_gram.cu").read_text())
    monkeypatch.setattr(native, "CSRC", tmp_path)
    assert native.library_path("zprep_gram") == first
    src.write_text(src.read_text() + "// edited\n")
    assert native.library_path("zprep_gram") != first


def test_a_kernel_library_is_built_and_loaded_once_from_many_threads(monkeypatch, tmp_path):
    """The realignment's workers reach their first launch together: eight
    threads asking for one library build it once and load it once, and
    all get the same handle."""
    builds, loads = [], []
    start = threading.Barrier(8)

    def counting_build(name):
        builds.append(name)
        time.sleep(0.05)  # long enough for every other thread to arrive
        return tmp_path / f"lib{name}.so"

    def fake_cdll(path):
        loads.append(path)
        return SimpleNamespace(fake_kernel_error_string=SimpleNamespace())

    monkeypatch.setattr(native, "build", counting_build)
    monkeypatch.setattr(native, "ctypes", SimpleNamespace(
        CDLL=fake_cdll, c_int=ctypes.c_int, c_char_p=ctypes.c_char_p))
    monkeypatch.setattr(native, "_LOADED", {})
    got = [None] * 8

    def worker(i):
        start.wait()
        got[i] = native.load("fake_kernel")

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert builds == ["fake_kernel"] and len(loads) == 1
    assert all(lib is got[0] for lib in got)


def test_launch_counts_from_many_threads_add_up():
    """More threads than cores, switching as often as the interpreter
    allows: no count is lost."""
    def wrapper():
        pass

    wrapper.launches = 0
    n = 4 * max(os.cpu_count() or 1, 4)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [native.count_launch(wrapper)
                                                    for _ in range(2000)]) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert wrapper.launches == 2000 * n


def test_get_device_never_substitutes_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_device("cuda")
    with pytest.raises(RuntimeError):
        get_device("cuda:0")
    assert get_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        get_device("meta")


def test_resolve_dtype():
    assert resolve_dtype(None) is None
    assert resolve_dtype({"device": {"dtype": "auto"}}) is None
    assert resolve_dtype({"device": {"dtype": "f32"}}) is torch.float32
    assert resolve_dtype({"device": {"dtype": "float64"}}) is torch.float64
    assert resolve_dtype({"device": {"dtype": "bf16"}}) is torch.bfloat16
    with pytest.raises(ValueError):
        resolve_dtype({"device": {"dtype": "int8"}})


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
