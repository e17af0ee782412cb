"""Smith-Waterman scores as one CUDA kernel (``csrc/sw_scores.cu``).

Replaces ``grid_tpu/ops/align.py:sw_scores`` (line 42), an XLA
``lax.scan`` over query positions with no Pallas kernel. Its plain version
is :func:`grid_tpu_torch.ops.align.sw_scores_plain`; the wrapper runs it for
CPU tensors only. For references up to 512 codes the kernel works a
unit with a group of G lanes on a row wavefront, each lane holding a strip
of S columns in registers: in the packed form (:func:`packed_fits`) two
reads against one reference in the 16-bit halves of each register, else
one (read, reference) pair in int32. :func:`sw_shape` picks (G, S) from
the reference length and the unit count. Longer references take a warp a
pair with the row in shared memory. See its source.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from grid_tpu_torch import native
from grid_tpu_torch.ops.align import sw_scores_plain

MODES = ("registers", "shared")  # the kernel's modes, by the number it takes
FORMS = ("int32", "packed")  # the register mode's forms, by the number it takes
_INFO_KEYS = ("mode", "form", "group_lanes", "columns_per_lane", "pairs_per_block", "smem_bytes",
              "registers", "spill_bytes", "blocks_per_sm")
_DTYPES = (torch.int8, torch.uint8)
_INT32 = 2**31
GROUP_LANES = (8, 16, 32)  # lanes a unit in the register mode
# the kernel's template table: for each G, strips (columns a lane) of every
# multiple of STRIP_STEP up to MAX_STRIP[G]
MAX_STRIP = {8: 32, 16: 32, 32: 16}
STRIP_STEP = 2
REGISTER_MAX_LR = 512  # the register mode's longest reference: G x MAX_STRIP[G] at G >= 16
# warps below which a launch leaves the card short of work: 132 SMs x 8
# (two a scheduler keep one issuing while the other waits on its shuffle)
MIN_WARPS = 132 * 8
_INT16 = 2**15


@functools.cache
def _lib():
    lib = native.load("sw_scores")
    lib.sw_scores_launch.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_longlong]
        + [ctypes.c_int] * 9 + [ctypes.c_void_p] * 2)
    lib.sw_scores_launch.restype = ctypes.c_int
    lib.sw_scores_max_lr.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.sw_scores_max_lr.restype = ctypes.c_int
    lib.sw_scores_info.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    lib.sw_scores_info.restype = ctypes.c_int
    return lib


def sw_scores_max_lr(device: torch.device) -> int:
    """The longest reference the kernel takes on the CUDA ``device``."""
    out = ctypes.c_int()
    index = device.index if device.index is not None else torch.cuda.current_device()
    with torch.cuda.device(device):
        native.check_launch("sw_scores", _lib().sw_scores_max_lr(index, ctypes.byref(out)))
    return out.value


def packed_fits(lq: int, match: int, mismatch: int, gap: int) -> bool:
    """Whether the packed form holds these reads and scores: match and
    mismatch a byte each (the profile), no positive gap or mismatch (the
    padded columns never pass the best), and every value of the recurrence
    inside int16 (scores reach at most Lq*match, sums fall at most |gap| or
    |mismatch| below 0, and a row that stays adds -32768 to values from 0
    up)."""
    return (-128 <= match < 128 and -128 <= mismatch <= 0 and -_INT16 // 2 <= gap <= 0
            and (lq + 1) * max(match, 0) < _INT16)


def units(n_q: int, n_t: int, packed: bool) -> int:
    """What the register mode's groups work: (read, reference) pairs, or in
    the packed form two reads against a reference (an odd Q's last read
    twice)."""
    return -(-n_q // 2) * n_t if packed else n_q * n_t


def strip(lr: int, g: int) -> int:
    """Columns a lane at G = ``g`` lanes a unit: ceil(Lr/G) rounded up to
    the table's :data:`STRIP_STEP`."""
    return -(-lr // (g * STRIP_STEP)) * STRIP_STEP


def sw_shape(lr: int, n_units: int) -> tuple[int, int]:
    """The register mode's (G, S) for references of ``lr`` <= 512 codes and
    ``n_units`` units (:func:`units`): G lanes a unit, S = :func:`strip`
    columns a lane.

    The fewest lanes whose strip the template table holds: a lane's cells
    a row grow with S while the step's own cost (the shuffle, the read's
    code, the loop) does not, and a group idles G - 1 steps of Lq + G - 1.
    Then twice as many lanes while the launch has fewer than
    :data:`MIN_WARPS` warps, so that few units still spread over the card.
    """
    fits = [g for g in GROUP_LANES if strip(lr, g) <= MAX_STRIP[g]]
    g = fits[0]
    while g < fits[-1] and n_units * g < 32 * MIN_WARPS:
        g *= 2
    return g, strip(lr, g)


def sw_scores_info(n_q: int, lq: int, n_t: int, lr: int, device: torch.device, match: int = 2,
                   mismatch: int = -1, gap: int = -2) -> dict:
    """The kernel's launch shape for ``n_q`` reads of ``lq`` codes against
    ``n_t`` references of ``lr`` at these scores: its mode, form, lanes a
    unit, columns a lane, pairs a block, dynamic shared memory a block,
    registers and local (spill) bytes a thread, and the blocks an SM takes
    at once."""
    return _info(lr, *_choice(n_q, lq, n_t, lr, match, mismatch, gap), device)


def _choice(n_q: int, lq: int, n_t: int, lr: int, match: int, mismatch: int,
            gap: int) -> tuple[int, int, bool]:
    """The register mode's (G, S, packed) the wrapper launches; (0, 0,
    False) past 512 columns, where the shared mode reads none of them."""
    if lr > REGISTER_MAX_LR:
        return 0, 0, False
    packed = packed_fits(lq, match, mismatch, gap)
    return (*sw_shape(lr, units(n_q, n_t, packed)), packed)


def _info(lr: int, g: int, s: int, packed: bool, device: torch.device) -> dict:
    out = (ctypes.c_int * len(_INFO_KEYS))()
    with torch.cuda.device(device):
        native.check_launch("sw_scores", _lib().sw_scores_info(lr, g, s, int(packed), out))
    info = dict(zip(_INFO_KEYS, out))
    info["mode"] = MODES[info["mode"]]
    info["form"] = FORMS[info["form"]]
    return info


def overflow_free(lq: int, lr: int, match: int, mismatch: int, gap: int) -> bool:
    """Whether every intermediate of the recurrence fits int32: scores
    reach at most Lq*max(|match|, gap) + Lr*max(gap, 0), and the shared
    mode's decayed row values (Lr rounded up to 32), like the register
    mode's padded columns (G*S <= Lr rounded up to 32*STRIP_STEP), Lr*|gap|
    beyond them."""
    lr_pad = -(-lr // (32 * STRIP_STEP)) * 32 * STRIP_STEP
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
    if not (n_q and n_t and lq and lr):
        return torch.zeros((n_q, n_t), dtype=torch.int32, device=queries.device)
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
    return _launch(queries, refs, match, mismatch, gap,
                   *_choice(n_q, lq, n_t, lr, match, mismatch, gap))


def _launch(queries, refs, match: int, mismatch: int, gap: int, g: int, s: int, packed: bool):
    """Launch the kernel on checked, non-empty inputs with the register
    mode's (G, S) and form (unread past 512 columns); it writes every
    score. The wrapper picks them; ``chip_smoke.py`` also runs shapes and
    forms it did not pick (the packed form only where it fits)."""
    (n_q, lq), (n_t, lr) = queries.shape, refs.shape
    out = torch.empty((n_q, n_t), dtype=torch.int32, device=queries.device)
    with torch.cuda.device(queries.device):
        err = _lib().sw_scores_launch(
            queries.data_ptr(), refs.data_ptr(), int(queries.dtype != refs.dtype), n_q, n_t, lq,
            lr, match, mismatch, gap, g, s, int(packed), out.data_ptr(),
            native.stream_ptr(queries.device))
    native.check_launch("sw_scores", err)
    native.count_launch(sw_scores_gpu)
    return out


sw_scores_gpu.launches = 0
