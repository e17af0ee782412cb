"""Build, load and launch the port's CUDA C++ kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface (``build/grid_tpu_torch/lib<name>-<key>.so``
at the repository root) and loaded with ``ctypes``. The key is a hash of the
source text and the nvcc flags, so a library is never reused for another
source or other flags, whatever the files' times. The build cache that
``utils.device.enable_compilation_cache`` names (``$GRID_TPU_COMPILE_CACHE``)
takes the place of ``build/grid_tpu_torch/`` (:func:`build_dir`, read at each
build, so the ranks of the sharded step, which inherit the variable, load the
libraries the parent built there). Nothing is built when a
module is imported: the first launch builds, and a failed build raises with
nvcc's own messages. nvcc's report (registers, spills) is kept beside the
library as ``lib<name>-<key>.log``.

Every exported launch function takes device pointers and the CUDA stream as
``void*``, launches without synchronising and returns the ``cudaError_t`` of
the launch; :func:`check_launch` turns a non-zero code into an exception.

A kernel that fails to build or launch raises :class:`KernelError`; the
pipeline never logs one away as a failed step (:func:`is_device_failure`).

Wrappers are called from several threads at once (the realignment's
per-sample workers): a kernel's library is built and loaded once under a
lock of its own, so two kernels still build in parallel, and launch counts
are added under a lock (:func:`count_launch`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from grid_tpu_torch.native_host import CACHE_ENV

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "grid_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # per-kernel registers / shared memory / spills, kept in the .log
)
KERNELS = ("zprep_gram", "zprep_gram64", "zprep_gram16", "dipcn_select", "sw_scores",
           "knn_select", "phase_sweeps")


class KernelError(RuntimeError):
    """A hand kernel failed to build, compile or launch."""


# what CUDA itself raises through PyTorch (a fault, an out-of-memory)
_DEVICE_ERRORS = tuple(
    cls for cls in (getattr(torch, "AcceleratorError", None),
                    getattr(torch.cuda, "CudaError", None), torch.cuda.OutOfMemoryError)
    if cls is not None)


def is_device_failure(exc: BaseException) -> bool:
    """Whether ``exc`` is a kernel's or the card's own failure, which the
    pipeline re-raises where it logs other step failures and goes on."""
    return isinstance(exc, (KernelError, *_DEVICE_ERRORS))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise KernelError("nvcc not found on PATH or under CUDA_HOME; cannot build the CUDA kernels")


def build_dir() -> Path:
    """Where the libraries are built: the build cache, else BUILD_DIR."""
    return Path(os.environ.get(CACHE_ENV) or BUILD_DIR)


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` at its current text and
    ``NVCC_FLAGS`` lives (built or not)."""
    return _library_of(CSRC / f"{name}.cu")


def _library_of(src: Path) -> Path:
    key = hashlib.sha256(src.read_bytes())
    key.update("\0".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{src.stem}-{key.hexdigest()[:16]}.so"


_LOCKS_GUARD = threading.Lock()
_LOCKS: dict[str, threading.RLock] = {}
_LOADED: dict[str, ctypes.CDLL] = {}
_COUNT_LOCK = threading.Lock()


def _lock(name: str) -> threading.RLock:
    """The lock of one kernel's load (by name) or one source's build (by
    path)."""
    with _LOCKS_GUARD:
        return _LOCKS.setdefault(name, threading.RLock())


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library exists; return the
    library's path. Raises KernelError with nvcc's stderr on failure."""
    return build_file(CSRC / f"{name}.cu")


def build_file(src: Path) -> Path:
    """:func:`build` for any CUDA source file with a plain C interface (a
    measurement script's, another version of a kernel): compiled with
    ``NVCC_FLAGS`` into :func:`build_dir`, keyed by its text and the
    flags."""
    src = Path(src)
    with _lock(str(src.resolve())):
        lib = _library_of(src)
        if lib.exists():
            return lib
        lib.parent.mkdir(parents=True, exist_ok=True)
        # neither two processes nor two threads ever share a temporary file
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise KernelError(f"nvcc failed building {src.name}:\n{' '.join(cmd)}\n{proc.stderr}")
        lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib)
        return lib


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load one kernel library, once per process
    whatever the number of threads asking; the error-string function
    ``<name>_error_string`` is declared here, the launch function by its
    wrapper."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    with _lock(name):
        lib = _LOADED.get(name)
        if lib is not None:
            return lib
        path = build(name)
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise KernelError(f"cannot load {path}: {e}") from e
        err_fn = getattr(lib, f"{name}_error_string")
        err_fn.argtypes = [ctypes.c_int]
        err_fn.restype = ctypes.c_char_p
        _LOADED[name] = lib
        return lib


def loaded_paths() -> list:
    """The paths of the kernel libraries this process has loaded."""
    return [Path(lib._name) for lib in list(_LOADED.values())]


def count_launch(wrapper, n: int = 1) -> None:
    """Add one (or the ``n`` launches that spawned ranks of the sharded
    step report) to ``wrapper.launches``, under a lock: workers launch from
    several threads."""
    with _COUNT_LOCK:
        wrapper.launches += n


def check_launch(name: str, err: int) -> None:
    """Raise KernelError if a launch returned a CUDA error code."""
    if err != 0:
        msg = getattr(load(name), f"{name}_error_string")(err).decode()
        raise KernelError(f"{name} kernel launch failed: cudaError {err} ({msg})")


def stream_ptr(device: torch.device) -> int:
    """PyTorch's current CUDA stream on ``device``, as an integer handle."""
    return torch.cuda.current_stream(device).cuda_stream


def on_cuda(*tensors: torch.Tensor) -> bool:
    """Route of a wrapper: False for CPU tensors (plain version), True for
    CUDA tensors (kernel). Mixed or other devices raise."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    device = devices.pop()
    if device.type == "cpu":
        return False
    if device.type == "cuda":
        return True
    raise ValueError(f"no kernel or plain version for device {device}")


def dtype_suffix(dtype: torch.dtype, bf16: bool = False) -> str:
    """The C entry points' suffix of a value type the cohort step's kernels
    take: "" for float32, "_f64" for float64 (their float64 forms) and,
    where the kernel has a bfloat16 form (``bf16``), "_bf16" for bfloat16;
    raises TypeError for any other."""
    if dtype == torch.float32:
        return ""
    if dtype == torch.float64:
        return "_f64"
    if bf16 and dtype == torch.bfloat16:
        return "_bf16"
    also = ", torch.bfloat16" if bf16 else ""
    raise TypeError(f"expected torch.float32, torch.float64{also}, got {dtype}")


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple) -> None:
    """Raise unless ``t`` has the dtype and shape a kernel takes and is
    contiguous."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
