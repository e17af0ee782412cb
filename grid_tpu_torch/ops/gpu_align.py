"""Smith-Waterman scores as one CUDA kernel (``csrc/sw_scores.cu``).

Replaces ``grid_tpu/ops/align.py:sw_scores`` (line 42), an XLA
``lax.scan`` over query positions with no Pallas kernel. Its plain version
is :func:`grid_tpu_torch.ops.align.sw_scores_plain`; the wrapper runs it for
CPU tensors only. The kernel carries one (read, reference) pair per warp and
the row in registers (references up to 512 codes) or in shared memory
(longer ones); see its source.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from grid_tpu_torch import native
from grid_tpu_torch.ops.align import sw_scores_plain

MODES = ("registers", "shared")  # the kernel's modes, by the number it takes
_INFO_KEYS = ("mode", "columns_per_lane", "warps_per_block", "smem_bytes", "registers",
              "spill_bytes")
_DTYPES = (torch.int8, torch.uint8)
_INT32 = 2**31
REGISTER_MAX_LR = 32 * 16  # the register mode's longest reference: 32 lanes x kMaxStrip


@functools.cache
def _lib():
    lib = native.load("sw_scores")
    lib.sw_scores_launch.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_longlong]
        + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2)
    lib.sw_scores_launch.restype = ctypes.c_int
    lib.sw_scores_max_lr.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.sw_scores_max_lr.restype = ctypes.c_int
    lib.sw_scores_info.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.sw_scores_info.restype = ctypes.c_int
    return lib


def sw_scores_max_lr(device: torch.device) -> int:
    """The longest reference the kernel takes on the CUDA ``device``."""
    out = ctypes.c_int()
    index = device.index if device.index is not None else torch.cuda.current_device()
    with torch.cuda.device(device):
        native.check_launch("sw_scores", _lib().sw_scores_max_lr(index, ctypes.byref(out)))
    return out.value


def sw_scores_info(lr: int, device: torch.device) -> dict:
    """The kernel's launch shape for references of ``lr`` codes: its mode,
    columns a lane, warps a block, dynamic shared memory a block, registers
    and local (spill) bytes a thread."""
    out = (ctypes.c_int * len(_INFO_KEYS))()
    with torch.cuda.device(device):
        native.check_launch("sw_scores", _lib().sw_scores_info(lr, out))
    info = dict(zip(_INFO_KEYS, out))
    info["mode"] = MODES[info["mode"]]
    return info


def overflow_free(lq: int, lr: int, match: int, mismatch: int, gap: int) -> bool:
    """Whether every intermediate of the recurrence fits int32: scores
    reach at most Lq*max(|match|, gap) + Lr*max(gap, 0) and the decayed
    row values Lr*|gap| beyond them (the kernel's last strip pads Lr to 32
    columns a lane)."""
    lr_pad = -(-lr // 32) * 32
    step = max(abs(match), abs(mismatch), abs(gap))
    return lq * step + lr_pad * abs(gap) < _INT32


def sw_scores_gpu(queries: torch.Tensor, refs: torch.Tensor, match: int = 2, mismatch: int = -1,
                  gap: int = -2) -> torch.Tensor:
    """Best local-alignment score of every query against every reference;
    same contract as :func:`grid_tpu_torch.ops.align.sw_scores_plain`.

    CPU tensors take the plain version. CUDA tensors launch the kernel:
    both 2-D, int8 or uint8, contiguous, on one device; the scores must
    stay in int32 (:func:`overflow_free`) and the references no longer than
    :func:`sw_scores_max_lr`. Anything else raises ``native.KernelError``
    (shapes and types) or the card's own error; nothing falls back.
    """
    if not native.on_cuda(queries, refs):
        return sw_scores_plain(queries, refs, match=match, mismatch=mismatch, gap=gap)
    for name, t in (("queries", queries), ("refs", refs)):
        if t.dim() != 2:
            raise native.KernelError(f"sw_scores: {name} must be 2-D, got {tuple(t.shape)}")
        if t.dtype not in _DTYPES:
            raise native.KernelError(f"sw_scores: {name} must be int8 or uint8, got {t.dtype}")
        if not t.is_contiguous():
            raise native.KernelError(f"sw_scores: {name} must be contiguous")
    n_q, lq = queries.shape
    n_t, lr = refs.shape
    out = torch.zeros((n_q, n_t), dtype=torch.int32, device=queries.device)
    if not (n_q and n_t and lq and lr):
        return out
    if not overflow_free(lq, lr, match, mismatch, gap):
        raise native.KernelError(
            f"sw_scores: Lq={lq}, Lr={lr} at scores ({match}, {mismatch}, {gap}) may leave int32")
    if n_t >= _INT32:
        raise native.KernelError(f"sw_scores: {n_t} references")
    if lr > REGISTER_MAX_LR:  # the shared mode: a warp's row in the block's shared memory
        max_lr = sw_scores_max_lr(queries.device)
        if lr > max_lr:
            raise native.KernelError(f"sw_scores: references of {lr} codes; the kernel takes "
                                     f"at most {max_lr} on {queries.device}")
    with torch.cuda.device(queries.device):
        err = _lib().sw_scores_launch(
            queries.data_ptr(), refs.data_ptr(), int(queries.dtype == torch.int8),
            int(refs.dtype == torch.int8), n_q, n_t, lq, lr, match, mismatch, gap,
            out.data_ptr(), native.stream_ptr(queries.device))
    native.check_launch("sw_scores", err)
    native.count_launch(sw_scores_gpu)
    return out


sw_scores_gpu.launches = 0
