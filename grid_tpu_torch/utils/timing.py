"""Per-step wall-clock timing (twin of ``grid_tpu/utils/timing.py``).

``StepTimer`` accumulates wall-clock seconds per named step and dumps them
as JSON next to the pipeline's artifacts; ``step_timer`` times one step.
PyTorch returns from a CUDA call before the device has finished, so a step
that ends with work in flight must synchronize before its ``with`` block
closes (``steps/fused.py`` does).

The JAX package's ``GRID_TPU_PROFILE_DIR`` branch (a ``jax.profiler`` trace
per step) is not ported; the variable has no effect here.
"""

from __future__ import annotations

import json
import time
from contextlib import contextmanager
from pathlib import Path

from grid_tpu_torch.utils.logging import log


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


@contextmanager
def step_timer(name: str, timer: StepTimer | None = None, console=None):
    """Time a pipeline step into ``timer``; with a console, log it too."""
    start = time.perf_counter()
    try:
        yield
    finally:
        elapsed = time.perf_counter() - start
        if timer is not None:
            timer.record(name, elapsed)
        if console is not None:
            log(console, f"[{name}] {elapsed:.2f}s", style="info")
