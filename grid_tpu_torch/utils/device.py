"""Device selection and dtype policy (twin of ``grid_tpu/utils/device.py``).

A device is only ever the one asked for: ``get_device("cuda")`` raises when
no CUDA device is present instead of quietly running on the host, so a
measurement can never be taken on the wrong device.
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
