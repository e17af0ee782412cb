"""Dispatch policy: flat (single-device) vs ring (sharded) kNN (twin of
``grid_tpu/parallel/policy.py``).

The JAX package's mesh sweep measured the ring kNN losing 2x to the
single-device op at N=8,192 and winning 1.8x at N=32,768 on an 8-device
mesh: below a cohort-size crossover the ring's per-step collective and merge
overhead outweighs the O(N^2 R / n_dev) work it saves. A config that sets
``device.mesh_shape`` for a small cohort would pay that 2x, so the fused step
asks this policy instead of following the config blindly.

The crossover is a row count, the geometric midpoint of the two measured
points, kept as the JAX package has it: where the constant errs, it errs
toward the path that is never 2x wrong. ``device.dispatch: flat|ring``
overrides the policy for measurement runs.
"""

from __future__ import annotations

# the JAX package's constant (grid_tpu/parallel/policy.py): the geometric
# midpoint of its two bracketing measurements
RING_CROSSOVER_N = 16_384


def choose_cohort_execution(n: int, n_devices: int, dispatch: str = "auto") -> str:
    """Pick ``"flat"`` or ``"ring"`` for a cohort of ``n`` rows.

    Args:
        n: cohort row count.
        n_devices: devices in the configured mesh (1 forces flat).
        dispatch: ``auto`` applies the measured crossover; ``flat``/``ring``
            force a path.
    """
    if dispatch not in ("auto", "flat", "ring"):
        raise ValueError(f"device.dispatch must be auto|flat|ring, got {dispatch!r}")
    if n_devices <= 1:
        if dispatch == "ring":
            raise ValueError("device.dispatch: ring requires a multi-device mesh")
        return "flat"
    if dispatch != "auto":
        return dispatch
    return "ring" if n >= RING_CROSSOVER_N else "flat"
