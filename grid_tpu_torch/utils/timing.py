"""Per-step wall-clock timing and per-step traces (twin of
``grid_tpu/utils/timing.py``).

``StepTimer`` accumulates wall-clock seconds per named step and dumps them
as JSON next to the pipeline's artifacts; ``step_timer`` times one step.
PyTorch returns from a CUDA call before the device has finished, so a step
that ends with work in flight must synchronize before its ``with`` block
closes (``steps/fused.py`` does).

Traces. With ``GRID_TPU_PROFILE_DIR`` set, the outermost open
``step_timer`` of the process runs a ``torch.profiler.profile`` (the CPU,
and CUDA where a card is present) and writes ``<dir>/<name>/trace.json``, a
Chrome trace; on exit it synchronises the card, so the trace holds the
step's kernels. The spans opened inside it (``fused.device``,
``normalize.stage``, ...) open no second profiler: they are
``torch.profiler.record_function`` ranges in the open one. The JAX package
opens a ``jax.profiler`` trace for every span, nested ones included, and
its second trace raises, so there a profiled step fails; here every step
runs and writes what it writes without the variable. A step that raises
still writes its trace, and the exception goes on. The spans of a rank of
the sharded step (``parallel/pcohort.py``) write no trace: ``run_ranks``
starts its ranks without the variable, so W processes never write W traces
of one name over each other.
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from pathlib import Path

from grid_tpu_torch.utils.logging import log

PROFILE_ENV = "GRID_TPU_PROFILE_DIR"

# how many step_timers are open in this process, whatever the thread: the
# first opens the profiler, the others are ranges in it
_OPEN = {"depth": 0}
_OPEN_LOCK = threading.Lock()


class StepTimer:
    """Accumulates per-step wall-clock timings across a pipeline run."""

    def __init__(self):
        self.timings: dict[str, float] = {}

    def record(self, name: str, seconds: float) -> None:
        self.timings[name] = self.timings.get(name, 0.0) + seconds

    def report(self) -> dict[str, float]:
        return dict(self.timings)

    def dump(self, path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.timings, f, indent=2, sort_keys=True)


def _start_profiler():
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.__enter__()
    return prof


def _write_trace(prof, path: Path) -> None:
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))


@contextmanager
def step_timer(name: str, timer: StepTimer | None = None, console=None):
    """Time a pipeline step into ``timer``; with a console, log it too.
    With ``GRID_TPU_PROFILE_DIR`` set, the outermost step writes a trace
    and the steps inside it are ranges of that trace (module docstring)."""
    profile_dir = os.environ.get(PROFILE_ENV)
    prof = rng = None
    if profile_dir:
        with _OPEN_LOCK:
            outermost = _OPEN["depth"] == 0
            _OPEN["depth"] += 1
        if outermost:
            prof = _start_profiler()
        else:
            import torch

            rng = torch.profiler.record_function(name)
            rng.__enter__()
    start = time.perf_counter()
    try:
        yield
    finally:
        elapsed = time.perf_counter() - start
        if profile_dir:
            try:
                if rng is not None:
                    rng.__exit__(None, None, None)
                if prof is not None:
                    _write_trace(prof, Path(profile_dir) / name / "trace.json")
            finally:
                with _OPEN_LOCK:
                    _OPEN["depth"] -= 1
        if timer is not None:
            timer.record(name, elapsed)
        if console is not None:
            log(console, f"[{name}] {elapsed:.2f}s", style="info")
