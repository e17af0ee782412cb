"""Build and load the port's host C++ library: the regions.bed.gz reader,
the BGZF text writers, the BAM and CRAM readers of the JAX package's native
layer (index, count, binned depth, the one-pass ingest and its batch
form, the BAM region subsetter), the CRAM writer and the PBWT IBS
neighbor engine: the whole of ``grid_tpu/native/src/``.

Every file under ``csrc/host/`` is a byte-for-byte copy of
``grid_tpu/native/src/``'s file of the same name. ``g++`` compiles the
sources with the flags of ``grid_tpu/native/Makefile`` (zlib and libdl
only; libdeflate, bzip2 and lzma are opened at run time where the system has
them) into ``build/grid_tpu_torch/libgridhost-<key>.so`` at the repository
root (or into the build cache that ``utils.device.enable_compilation_cache``
names, ``$GRID_TPU_COMPILE_CACHE``: :func:`build_dir`), one compiler per
source, all started together, then links them. The
key hashes the files and the flags, so a library is never reused for other
text or other flags, whatever the files' times. Each build writes a file of
its own and renames it into place, so processes that build at once leave one
working library.

Nothing is built when the module is imported. The first call of :func:`lib`
builds (unless the library exists) and loads. If that fails, for example on
a machine without ``g++`` or zlib's headers, it warns once with the
compiler's error and returns None, and the callers take their Python
versions; :func:`route` says which route the process took: ``"native"``, or
the error.

Exported, with the ``argtypes`` declared here (those of
``grid_tpu/native/__init__.py:_configure`` and of its wrappers):

- ``grid_bed_read``, ``grid_bed_read_grouped`` and their ``grid_bed_free*``
  (:mod:`grid_tpu_torch.native_host.bedgz`);
- ``grid_write_normalized`` and ``grid_write_neighbors``
  (:mod:`grid_tpu_torch.io.formats`);
- ``grid_bam_*`` and ``grid_cram_*`` (:mod:`.bam`, :mod:`.cram`, the
  writer ``grid_cram_write`` among them) and ``grid_ingest_batch``
  (:mod:`._ingest`);
- ``grid_ibs_neighbors`` (:mod:`.ibs`).

:data:`fallbacks` counts, per kind, the times a caller of the host library
took a slower route than the native one (the one-pass ingest's sequential
steps, a file's per-sample or Python reader, the numpy IBS engine, the
Python CRAM writer): the routes stay as the JAX package has them, and the
count says that one was taken.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import warnings
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc" / "host"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "grid_tpu_torch"
CACHE_ENV = "GRID_TPU_COMPILE_CACHE"  # the build cache (utils/device.py)
SOURCES = ("bedgz.cpp", "textgz.cpp", "bgzf.cpp", "bam.cpp", "cram.cpp", "batch.cpp",
           "ibs.cpp", "cram_write.cpp")
FILES = ("bedwrite.h", "bgzf.h", "windows.h", *SOURCES)  # what the key hashes
CXX = "g++"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra")
LD_FLAGS = ("-shared", "-lz", "-ldl")

_LOCK = threading.Lock()
_LOADED: dict = {}  # filled once by the first lib(): "lib" and "route"

# kind -> times a slower route than the native one was taken (see the
# module docstring); the callers add to it through count_fallback, a run
# reads it and may clear it
fallbacks: collections.Counter = collections.Counter()
_FALLBACK_LOCK = threading.Lock()


def count_fallback(kind: str) -> None:
    """Add one to ``fallbacks[kind]`` (thread-safe)."""
    with _FALLBACK_LOCK:
        fallbacks[kind] += 1


def build_dir() -> Path:
    """Where the library is built: the build cache, else BUILD_DIR."""
    return Path(os.environ.get(CACHE_ENV) or BUILD_DIR)


def library_path() -> Path:
    """Where the library of the current sources and flags lives (built or
    not)."""
    key = hashlib.sha256()
    for name in FILES:
        key.update(name.encode() + b"\0" + (CSRC / name).read_bytes() + b"\0")
    key.update("\0".join((CXX, *CXX_FLAGS, *LD_FLAGS)).encode())
    return build_dir() / f"libgridhost-{key.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it exists; return its path. Raises
    RuntimeError with the compiler's messages on failure. The compiler's
    output (its warnings) is kept beside the library as ``.log``."""
    lib = library_path()
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    with tempfile.TemporaryDirectory(prefix=f"{lib.stem}.", dir=lib.parent) as objdir:
        objects = [Path(objdir) / f"{Path(name).stem}.o" for name in SOURCES]
        compiles = [[CXX, *CXX_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
                    for name, obj in zip(SOURCES, objects)]
        link = [CXX, *CXX_FLAGS, *map(str, objects), "-o", str(tmp), *LD_FLAGS]
        try:
            procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True) for cmd in compiles]
        except OSError as e:
            raise RuntimeError(f"{CXX} could not be run: {e}") from e
        said = []
        for cmd, proc in zip(compiles, procs):
            out, err = proc.communicate()
            said.append(out + err)
            if proc.returncode != 0:
                for other in procs:
                    other.kill()
                    other.wait()
                raise RuntimeError(f"{CXX} failed building the host library:\n{' '.join(cmd)}\n"
                                   f"{err}")
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{CXX} failed linking the host library:\n{' '.join(link)}\n"
                               f"{proc.stderr}")
    lib.with_suffix(".log").write_text("".join(said) + proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


# grid_bam_ingest_multi and grid_cram_ingest_multi (grid_tpu/native/_ingest.py)
def _ingest_argtypes() -> list:
    c = ctypes
    i32, i64, s = c.c_int32, c.c_int64, c.c_char_p
    p32, p64, pd = c.POINTER(i32), c.POINTER(i64), c.POINTER(c.c_double)
    return [s, s, i32, i32, i32, i32, s, i64, i64, p32, i32, i32, s, p64, p64,
            p32, p64, p64, pd, i64, p64,
            s, p64, p64, i32, p64]  # the extra count-only windows


def _batch_argtypes() -> list:
    """grid_ingest_batch's (grid_tpu/native/_ingest.py:_BATCH_ARGTYPES)."""
    c = ctypes
    i32, i64, s = c.c_int32, c.c_int64, c.c_char_p
    p32, p64, pd = c.POINTER(i32), c.POINTER(i64), c.POINTER(c.c_double)
    return [s, s, p32, i32, i32, i32, i32, i32, i32, s, i64, i64, p32, i32, i32, s,
            s, p64, p64, i32,
            p64, p64, p64, p32, p32, p64, p64, pd, i64, p64, p64,
            pd, pd, p32]  # per-thread busy and CPU seconds, threads used


def _declare(cdll: ctypes.CDLL) -> None:
    """Every exported function's signature (those of
    grid_tpu/native/__init__.py, bedgz.py, bam.py and _ingest.py)."""
    c = ctypes
    i64, p64, pd = c.c_int64, c.POINTER(c.c_int64), c.POINTER(c.c_double)
    i32, p32, s = c.c_int32, c.POINTER(c.c_int32), c.c_char_p
    p8 = c.POINTER(c.c_uint8)
    cdll.grid_ibs_neighbors.restype = c.c_int
    cdll.grid_ibs_neighbors.argtypes = [p8, i32, i32, pd, i32, c.c_double, i32, i32, i32,
                                        p32, pd, pd, p32]
    cdll.grid_cram_write.restype = c.c_int
    cdll.grid_cram_write.argtypes = [s, p8, i64, i64, p32, p32, p64, p32, p32, p32, p64, p32,
                                     p8, p64, p8, p64, p8, p64, c.POINTER(c.c_uint32), p64,
                                     i32, s]
    cdll.grid_bam_subset.restype = i64
    cdll.grid_bam_subset.argtypes = [s, s, i64, i64, s]
    for name in ("grid_bam_count", "grid_cram_count"):
        getattr(cdll, name).restype = i64
        getattr(cdll, name).argtypes = [s, s, i64, i64, p32, i32, i32]
    for name in ("grid_bam_binned_depth", "grid_cram_binned_depth"):
        getattr(cdll, name).restype = c.c_int
        getattr(cdll, name).argtypes = [s, s, i32, i32, i32, i32]
    for name in ("grid_bam_ingest_multi", "grid_cram_ingest_multi"):
        getattr(cdll, name).restype = c.c_int
        getattr(cdll, name).argtypes = _ingest_argtypes()
    cdll.grid_ingest_batch.restype = c.c_int
    cdll.grid_ingest_batch.argtypes = _batch_argtypes()
    cdll.grid_bam_build_bai.restype = c.c_int
    cdll.grid_bam_build_bai.argtypes = [s, s]
    cdll.grid_bam_refs.restype = i32
    cdll.grid_bam_refs.argtypes = [s, s, i64, p32, i32]
    cdll.grid_cram_refs.restype = i32
    cdll.grid_cram_refs.argtypes = [s, s, i64, p64, i32]
    cdll.grid_cram_dump.restype = i64
    cdll.grid_cram_dump.argtypes = [s, p64, i64]
    cdll.grid_bam_fetch.restype = i64
    cdll.grid_bam_fetch.argtypes = [s, s, i64, i64, i32, i32, c.POINTER(p64), c.POINTER(p32),
                                    c.POINTER(p32), c.POINTER(s), c.POINTER(p64)]
    cdll.grid_bam_fetch_free.restype = None
    cdll.grid_bam_fetch_free.argtypes = [p64, p32, p32, s, p64]
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
            "grid_tpu_torch: the host library did not build or load, so the bed.gz reader, "
            "the text writers, the alignment readers and writers and the IBS engine take "
            f"their other routes: {e}",
            RuntimeWarning, stacklevel=4)
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


def loaded_paths() -> list:
    """The host library's path where this process has loaded it."""
    cdll = _LOADED.get("lib")
    return [] if cdll is None else [Path(cdll._name)]


def route() -> str:
    """``"native"`` when the host library loaded, else the error that kept
    it from loading. Builds at the first call, like :func:`lib`."""
    lib()
    return _LOADED["route"]


def require() -> ctypes.CDLL:
    """The loaded host library, or RuntimeError naming why it is not there
    (for the wrappers, whose callers take another route on the error)."""
    cdll = lib()
    if cdll is None:
        raise RuntimeError(f"the host library is not loaded: {route()}")
    return cdll
