"""Build and load the port's host C++ library: the regions.bed.gz reader and
the BGZF text writers of the JAX package's native layer.

``csrc/host/bedwrite.h``, ``bedgz.cpp`` and ``textgz.cpp`` are byte-for-byte
copies of ``grid_tpu/native/src/``'s files. ``g++`` compiles the two sources
with the flags of ``grid_tpu/native/Makefile`` (zlib and libdl only;
libdeflate is opened at run time where the system has it) into
``build/grid_tpu_torch/libgridhost-<key>.so`` at the repository root. The key
hashes the three files and the flags, so a library is never reused for other
text or other flags, whatever the files' times. Each build writes a file of
its own and renames it into place, so processes that build at once leave one
working library.

Nothing is built when the module is imported. The first call of :func:`lib`
builds (unless the library exists) and loads. If that fails, for example on
a machine without ``g++`` or zlib's headers, it warns once with the
compiler's error and returns None, and the callers take their Python
versions; :func:`route` says which route the process took: ``"native"``, or
the error.

Exported, with the ``argtypes`` declared here:

- ``grid_bed_read``, ``grid_bed_read_grouped`` and their ``grid_bed_free*``
  (:mod:`grid_tpu_torch.native_host.bedgz`);
- ``grid_write_normalized`` and ``grid_write_neighbors``
  (:mod:`grid_tpu_torch.io.formats`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import warnings
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc" / "host"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "grid_tpu_torch"
SOURCES = ("bedgz.cpp", "textgz.cpp")
FILES = ("bedwrite.h", *SOURCES)  # what the key hashes
CXX = "g++"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra")
LD_FLAGS = ("-shared", "-lz", "-ldl")

_LOCK = threading.Lock()
_LOADED: dict = {}  # filled once by the first lib(): "lib" and "route"


def library_path() -> Path:
    """Where the library of the current sources and flags lives (built or
    not)."""
    key = hashlib.sha256()
    for name in FILES:
        key.update(name.encode() + b"\0" + (CSRC / name).read_bytes() + b"\0")
    key.update("\0".join((CXX, *CXX_FLAGS, *LD_FLAGS)).encode())
    return BUILD_DIR / f"libgridhost-{key.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it exists; return its path. Raises
    RuntimeError with the compiler's messages on failure. The compiler's
    output (its warnings) is kept beside the library as ``.log``."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [CXX, *CXX_FLAGS, *(str(CSRC / name) for name in SOURCES), "-o", str(tmp), *LD_FLAGS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"{CXX} could not be run: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{CXX} failed building the host library:\n{' '.join(cmd)}\n"
                           f"{proc.stderr}")
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


def _declare(cdll: ctypes.CDLL) -> None:
    """The six functions' signatures (those of grid_tpu/native/__init__.py
    and grid_tpu/native/bedgz.py)."""
    c = ctypes
    i64, p64, pd = c.c_int64, c.POINTER(c.c_int64), c.POINTER(c.c_double)
    cdll.grid_bed_read.restype = c.c_int
    cdll.grid_bed_read.argtypes = [
        c.c_char_p, c.c_char_p, c.c_int, i64, i64,
        c.c_char_p, c.c_int32, p64, p64,
        c.POINTER(p64), c.POINTER(p64), c.POINTER(pd), c.POINTER(i64),
    ]
    cdll.grid_bed_free.restype = None
    cdll.grid_bed_free.argtypes = [p64, p64, pd]
    cdll.grid_bed_read_grouped.restype = c.c_int
    cdll.grid_bed_read_grouped.argtypes = [
        c.c_char_p, c.c_char_p, c.c_int32, p64, p64,
        c.POINTER(p64), c.POINTER(p64), c.POINTER(pd),
        c.POINTER(c.POINTER(c.c_char)), c.POINTER(i64),
        c.POINTER(p64), c.POINTER(i64), c.POINTER(i64),
    ]
    cdll.grid_bed_free_grouped.restype = None
    cdll.grid_bed_free_grouped.argtypes = [c.POINTER(c.c_char), p64]
    cdll.grid_write_neighbors.restype = c.c_int
    cdll.grid_write_neighbors.argtypes = [c.c_char_p, c.c_char_p, i64, i64, pd, p64, pd]
    cdll.grid_write_normalized.restype = c.c_int
    cdll.grid_write_normalized.argtypes = [
        c.c_char_p, c.c_char_p, i64, i64, pd, pd, c.POINTER(c.c_uint8), pd, pd,
    ]


def _load() -> dict:
    try:
        cdll = ctypes.CDLL(str(build()))
        _declare(cdll)
    except (RuntimeError, OSError, AttributeError) as e:
        warnings.warn(
            "grid_tpu_torch: the host library did not build or load, so the bed.gz reader and "
            f"the text writers take their Python versions: {e}", RuntimeWarning, stacklevel=4)
        return {"lib": None, "route": str(e)}
    return {"lib": cdll, "route": "native"}


def lib() -> ctypes.CDLL | None:
    """The loaded host library, built at the process's first call; None
    when it could not be built or loaded (warned once, :func:`route` says
    why)."""
    with _LOCK:
        if not _LOADED:
            _LOADED.update(_load())
        return _LOADED["lib"]


def route() -> str:
    """``"native"`` when the host library loaded, else the error that kept
    it from loading. Builds at the first call, like :func:`lib`."""
    lib()
    return _LOADED["route"]
