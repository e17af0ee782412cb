"""Device selection and dtype policy (twin of ``grid_tpu/utils/device.py``).

A device is only ever the one asked for: ``get_device("cuda")`` raises when
no CUDA device is present instead of quietly running on the host, so a
measurement can never be taken on the wrong device.

The config-driven entry points (``run_wgs_pipeline``, ``run_fused_steps``)
run on the card unless ``device.platform: cpu`` asks for the host
(:func:`config_device`). The JAX package's ``AUTO_CPU_THRESHOLD`` policy,
which quietly moves small cohorts to the host under ``platform: auto``, is
not ported: here ``auto`` is the card, whatever the cohort's size.

The build cache (:func:`enable_compilation_cache`, the JAX package's
persistent compilation cache): the directory that the nvcc kernel libraries
(``native.py``), the host library (``native_host``) and Triton's cache are
built into, ``build/grid_tpu_torch/`` (Triton: its own default) until a
directory is named.
"""

from __future__ import annotations

import os
from pathlib import Path

import torch

from grid_tpu_torch.native_host import CACHE_ENV
from grid_tpu_torch.utils.logging import log

TRITON_CACHE_ENV = "TRITON_CACHE_DIR"

# the first enable_compilation_cache call's directory, under "dir" (None:
# no directory named, the default stays)
_CACHE: dict = {}

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
    """The dtype the cohort steps compute in. ``device.dtype: auto`` is
    float32 on a CUDA device and float64, the staged arrays' dtype, on the
    CPU. The hand kernels take float32 and float64 on the card on every
    path ``grid_tpu`` takes float64 on its device: the cohort step on both
    branches, the file-mode steps, the multi-locus sweep (the multi-weight
    ``dipcn_select``) and ``device.mesh_shape`` (the ring's cross-mode Gram,
    the gather form and the sharded stager). bfloat16 runs on the card
    where ``grid_tpu`` applies it (:func:`step_dtype` says which steps):
    the flat cohort step, file-mode step 4 and, with ``device.mesh_shape``,
    the sharded step (the bf16 Gram's cross mode, the ring merge on bf16
    rows, the gather form, the sharded stager), through the bf16 forms of
    the kernels, on either device. float64 on the card with
    ``mosdepth.neighbors.num_neighbors`` past the float64 ``knn_select``'s
    8,192 raises. Callers resolve the dtype before any step runs."""
    dtype = resolve_dtype(config)
    if device.type != "cuda":
        return torch.float64 if dtype is None else dtype
    if dtype in (None, torch.float32, torch.bfloat16):
        return dtype or torch.float32
    advice = "use float32 or auto on the card, or device.platform: cpu"
    from grid_tpu_torch.ops.gpu_select import KNN_MAX_K

    k = ((config or {}).get("mosdepth") or {}).get("neighbors", {}).get("num_neighbors")
    if k is not None and int(k) > KNN_MAX_K[torch.float64]:
        raise ValueError(
            f"device.dtype float64 on {device} with mosdepth.neighbors.num_neighbors {k}: the "
            f"float64 knn_select kernel takes at most {KNN_MAX_K[torch.float64]} neighbors "
            f"(float32 {KNN_MAX_K[torch.float32]}); {advice}"
        )
    return torch.float64


def step_dtype(config: dict | None, device: torch.device) -> torch.dtype:
    """The dtype of the steps that ``grid_tpu`` runs without reading
    ``device.dtype``: file-mode steps 5 and 6 (which read the written
    normalized matrix), step 7 in both forms and the multi-locus sweep's
    batched dipCN, and the dtype of the read counts (the fused step's
    reads; in the sharded ring also its dipCN weights and dipCN). It is
    :func:`compute_dtype`'s, but for bfloat16, which ``grid_tpu`` applies to
    the fused steps 4-6 (the depths alone, with ``device.mesh_shape`` too)
    and file-mode step 4 only (``grid_tpu/steps/fused.py``,
    ``grid_tpu/steps/normalize.py``): there these compute as under
    ``auto``, in float32 on the card and in float64 on the CPU."""
    dtype = compute_dtype(config, device)
    if dtype == torch.bfloat16:
        return torch.float32 if device.type == "cuda" else torch.float64
    return dtype


def enable_compilation_cache(cache_dir=None, console=None) -> Path | None:
    """Name the build cache once per process; the first call wins, later
    calls return its directory.

    The directory is ``cache_dir`` (``device.compilation_cache``), else
    ``$GRID_TPU_COMPILE_CACHE``, else none, and then the libraries stay in
    ``build/grid_tpu_torch/``. A named directory is created, and written
    to ``$GRID_TPU_COMPILE_CACHE``, which ``native.build_dir`` and
    ``native_host.build_dir`` read at each build
    and the ranks of the sharded step inherit (so a rank loads the libraries
    the parent built there), and Triton's cache goes to ``<dir>/triton``
    unless ``$TRITON_CACHE_DIR`` is set already. A library this process has
    loaded already from another directory is logged, not loaded again.

    Raises OSError naming the directory when it cannot be created: no other
    place is the one the caller asked for.

    Returns the directory, or None.
    """
    if "dir" in _CACHE:
        return _CACHE["dir"]
    chosen = cache_dir or os.environ.get(CACHE_ENV)
    if not chosen:
        _CACHE["dir"] = None
        return None
    path = Path(chosen).expanduser().absolute()
    try:
        path.mkdir(parents=True, exist_ok=True)
    except OSError as e:
        raise OSError(f"the build cache {path} cannot be created: {e}") from e
    if not os.access(path, os.W_OK):
        raise OSError(f"the build cache {path} is not writable")
    os.environ[CACHE_ENV] = str(path)
    if not os.environ.get(TRITON_CACHE_ENV):
        os.environ[TRITON_CACHE_ENV] = str(path / "triton")
    from grid_tpu_torch import native, native_host

    for lib in (*native.loaded_paths(), *native_host.loaded_paths()):
        if lib.parent != path:
            log(console, f"{lib.name} stays loaded from {lib.parent}: it was built before the "
                f"build cache {path} was named", style="info")
    _CACHE["dir"] = path
    return path

