"""Device selection and dtype policy (twin of ``grid_tpu/utils/device.py``).

A device is only ever the one asked for: ``get_device("cuda")`` raises when
no CUDA device is present instead of quietly running on the host, so a
measurement can never be taken on the wrong device.

The config-driven entry points (``run_wgs_pipeline``, ``run_fused_steps``)
run on the card unless ``device.platform: cpu`` asks for the host
(:func:`config_device`). The JAX package's ``AUTO_CPU_THRESHOLD`` policy,
which quietly moves small cohorts to the host under ``platform: auto``, is
not ported: here ``auto`` is the card, whatever the cohort's size.
"""

from __future__ import annotations

import torch

_DTYPES = {
    "float32": torch.float32,
    "f32": torch.float32,
    "float64": torch.float64,
    "f64": torch.float64,
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
}


def resolve_dtype(config: dict | None):
    """Map ``device.dtype`` to a torch dtype, or None for "auto" (keep the
    staged arrays' dtype)."""
    name = "auto"
    if config:
        name = str(config.get("device", {}).get("dtype", "auto")).lower()
    if name in ("auto", "none", ""):
        return None
    if name not in _DTYPES:
        raise ValueError(f"unknown device.dtype {name!r}")
    return _DTYPES[name]


def get_device(name: str = "cuda") -> torch.device:
    """Return the torch device called ``name`` ("cuda", "cuda:<i>" or "cpu").

    Raises RuntimeError when a CUDA device is asked for and none is
    present; the host is never substituted.
    """
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {name!r} requested but CUDA is not available")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {name!r} requested but only {torch.cuda.device_count()} present"
            )
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {name!r}")


def config_device(config: dict | None) -> torch.device:
    """The device ``device.platform`` names: absent, ``auto``, ``default`` or
    ``cuda`` (``cuda:<i>``) is the card, through :func:`get_device`, which
    raises without one; ``cpu`` is the host. Nothing else chooses the host."""
    name = "auto"
    if config:
        name = str(config.get("device", {}).get("platform") or "auto").lower()
    if name in ("auto", "default"):
        name = "cuda"
    if name != "cpu" and not name.startswith("cuda"):
        raise ValueError(f"unknown device.platform {name!r} (auto, default, cuda, cuda:<i>, cpu)")
    return get_device(name)


def compute_dtype(config: dict | None, device: torch.device) -> torch.dtype:
    """The dtype the fused steps compute in. ``device.dtype: auto`` is
    float32 on a CUDA device and float64, the staged arrays' dtype, on the
    CPU. The hand kernels are float32 only, so any other dtype named for a
    CUDA device raises rather than run their plain versions there."""
    dtype = resolve_dtype(config)
    if device.type != "cuda":
        return torch.float64 if dtype is None else dtype
    if dtype not in (None, torch.float32):
        raise ValueError(
            f"device.dtype {dtype} on {device}: the Hopper kernels of the cohort step are "
            "float32 only; use float32 or auto on the card, or device.platform: cpu"
        )
    return torch.float32
