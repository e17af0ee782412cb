"""Iterative haplotype copy-number inference (twin of
``grid_tpu/ops/phasing.py``; reference ``grid/utils/hi_inference.py:175-250``).

The ragged per-haplotype neighbor lists are padded ``[2N, K]``
index/weight/valid tensors. The n_iters Jacobi sweeps (the JAX package's
``lax.scan``) run on the card in one CUDA kernel, ``csrc/phase_sweeps.cu``
(:func:`phase_sweeps_gpu`: all sweeps in one launch, a thread a haplotype:
a cluster of 8 blocks a replicate, storing each sweep's values into each
other's shared memory, where a block's share of the values and lists fits
it, else one cooperative launch over the card with a grid barrier a
sweep); on the CPU they are
:func:`phase_sweeps`, a Python loop of vectorised gathers and row sums,
the kernel's plain version. The reference's 1e-9
weight-sum floor is kept, so padded and empty neighbor sets fall back
exactly as there.

The reference updates in place while it walks the samples (Gauss-Seidel);
the device sweeps are Jacobi. Both share their fixed points.
:func:`phase_gauss_seidel_host` and :func:`compute_imputed_host` repeat the
reference's order in Python floats, for ``device.exact_phasing``.

:func:`phase_bootstrap` resamples each haplotype's neighbor slots per
replicate and runs all replicates as one leading batch dimension through
the sweeps of :func:`phase_haplotypes`.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from grid_tpu_torch import native


class PhasingResult(NamedTuple):
    """Outputs of :func:`phase_haplotypes`.

    Attributes:
        hap_irrs: [2N] final haplotype values (NaN for unphased samples);
            sample i's haplotypes are rows 2i and 2i+1.
        mean_irrs: 0-d mean diploid IRR over phased samples (0 if none).
        phased: [N] bool — both haplotypes had >= min_nbr neighbors.
    """

    hap_irrs: torch.Tensor
    mean_irrs: torch.Tensor
    phased: torch.Tensor


def _neighbor_means(hap_irrs, nbr_idx, nbr_w, nbr_valid):
    """Weighted mean of non-NaN neighbor values per haplotype row, with the
    reference's floor: sum(w*val) / (1e-9 + sum(w)). Returns (means, wsum).

    ``hap_irrs`` is [..., 2N] and ``nbr_idx``/``nbr_w`` [..., 2N, K] with the
    same leading (replicate) dimensions; ``nbr_valid`` is [2N, K]."""
    lead = hap_irrs.shape[:-1]
    val = torch.gather(hap_irrs, -1, nbr_idx.reshape(*lead, -1)).reshape(nbr_idx.shape)
    ok = nbr_valid & ~torch.isnan(val)
    wsum = torch.where(ok, nbr_w, 0).sum(dim=-1)
    wval = torch.where(ok, nbr_w * val, 0).sum(dim=-1)
    return wval / (1e-9 + wsum.to(hap_irrs.dtype)), wsum


def phase_haplotypes(irrs, nbr_idx, nbr_w, nbr_valid, min_nbr: int, n_iters: int) -> PhasingResult:
    """Run the iterative phasing to n_iters (Jacobi ordering).

    Args:
        irrs: [N] diploid IRR (dipCN) per sample; non-finite entries are
            samples outside phasing.
        nbr_idx: [2N, K] neighbor haplotype-row indices (padding -> 0), or
            [B, 2N, K] for B replicates phased at once.
        nbr_w: [2N, K] neighbor weights (padding -> 0), shaped as nbr_idx.
        nbr_valid: [2N, K] bool padding mask, shared by all replicates.
        min_nbr: both haplotypes need >= min_nbr neighbors to participate.
        n_iters: number of sweeps.

    Returns hap_irrs [2N] ([B, 2N] for replicates); mean_irrs and phased
    depend on irrs and nbr_valid only.
    """
    n = irrs.shape[0]
    deg = nbr_valid.sum(dim=1).reshape(n, 2)  # per-sample [h0, h1]
    phased = (deg[:, 0] >= min_nbr) & (deg[:, 1] >= min_nbr) & torch.isfinite(irrs)

    hap0 = torch.where(phased, irrs / 2, math.nan)
    hap = phase_sweeps_gpu(torch.stack([hap0, hap0], dim=1).reshape(2 * n), irrs, nbr_idx,
                           nbr_w, nbr_valid, n_iters)

    n_phased = phased.sum()
    mean_irrs = torch.where(
        n_phased > 0, torch.where(phased, irrs, 0).sum() / n_phased.clamp_min(1), 0.0
    )
    return PhasingResult(hap_irrs=hap, mean_irrs=mean_irrs, phased=phased)


def phase_sweeps(hap, irrs, nbr_idx, nbr_w, nbr_valid, n_iters: int):
    """The n_iters Jacobi sweeps from the starting values ``hap`` [2N]: in
    each, every sample i (haplotype rows 2i, 2i+1) takes per haplotype the
    weighted mean m_h of its neighbors' values, then new_h = irr_i * m_h /
    (m_0 + m_1); the old value stays where that denominator is <= 0 or the
    old value is NaN. The plain version of the ``phase_sweeps`` kernel.

    Args:
        hap: [2N] starting values, shared by the replicates.
        irrs, nbr_idx, nbr_w, nbr_valid: as :func:`phase_haplotypes`.

    Returns hap [2N] ([B, 2N] for B replicates).
    """
    n = irrs.shape[0]
    nbr_idx = nbr_idx.long()
    lead = nbr_idx.shape[:-2]
    hap = hap.expand(*lead, 2 * n)
    irr_rep = irrs.repeat_interleave(2)
    for _ in range(n_iters):
        means, _ = _neighbor_means(hap, nbr_idx, nbr_w, nbr_valid)
        m = means.reshape(*lead, n, 2)
        denom = m[..., 0] + m[..., 1]
        new = (irr_rep * means) / denom.repeat_interleave(2, dim=-1)
        keep_old = (denom <= 0).repeat_interleave(2, dim=-1) | torch.isnan(hap)
        hap = torch.where(keep_old, hap, new)
    return hap


SWEEP_MODES = ("resident", "persistent")  # the kernel's modes, by the number it takes
_SWEEP_INFO_KEYS = ("threads", "smem_bytes", "blocks_per_sm", "registers", "spill_bytes",
                    "cluster_blocks", "clusters", "grid_blocks")
# the parts of a resident sweep that phase_sweeps_probe runs
SWEEP_PARTS = {"walk": 1, "exchange": 2, "whole": 3}


@functools.cache
def _sweeps_lib():
    lib = native.load("phase_sweeps")
    lib.phase_sweeps_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 3)
    lib.phase_sweeps_launch.restype = ctypes.c_int
    lib.phase_sweeps_probe.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2)
    lib.phase_sweeps_probe.restype = ctypes.c_int
    lib.phase_sweeps_mode.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    lib.phase_sweeps_mode.restype = ctypes.c_int
    lib.phase_sweeps_info.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    lib.phase_sweeps_info.restype = ctypes.c_int
    for name in ("launch", "mode", "info"):
        f64 = getattr(lib, f"phase_sweeps_{name}_f64")
        f64.argtypes = getattr(lib, f"phase_sweeps_{name}").argtypes
        f64.restype = ctypes.c_int
    return lib


def phase_sweeps_mode(n: int, k: int, device: torch.device,
                      dtype: torch.dtype = torch.float32) -> str:
    """The mode the ``phase_sweeps`` kernel takes N samples with lists of K
    slots of ``dtype`` values in on the CUDA ``device``: "resident" (all
    sweeps in one launch, a cluster of 8 blocks a replicate, each holding
    the values double-buffered and the lists of an eighth of the samples in
    shared memory: 16 C chunk + 18 chunk K bytes in float32, 32 C chunk +
    26 chunk K in float64, chunk = ceil(N / C), C = 8) where that fits and
    a cluster can be scheduled, else "persistent" (all sweeps in one
    cooperative launch, the values in device memory, a grid barrier a
    sweep); a card that takes no cooperative launch raises
    ``native.KernelError`` past the resident mode's edge. Cached by
    (device index, N, K, dtype)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return _sweeps_mode(index, n, k, native.dtype_suffix(dtype))


@functools.cache
def _sweeps_mode(index: int, n: int, k: int, suffix: str) -> str:
    mode = ctypes.c_int()
    fn = getattr(_sweeps_lib(), f"phase_sweeps_mode{suffix}")
    with torch.cuda.device(index):
        err = fn(index, n, k, ctypes.byref(mode))
    native.check_launch("phase_sweeps", err)
    return SWEEP_MODES[mode.value]


def phase_sweeps_info(n: int, k: int, device: torch.device, mode: str | None = None,
                      dtype: torch.dtype = torch.float32) -> dict:
    """The ``phase_sweeps`` kernel's launch shape at N samples and K slots a
    list on the CUDA ``device``, in ``mode`` (default: the one
    :func:`phase_sweeps_mode` picks): its mode, threads and dynamic
    shared memory per block, resident blocks per SM, registers and local
    (spill) bytes per thread, blocks per cluster, the clusters the card
    holds at once (0 in the persistent mode) and the blocks of one
    replicate's launch (the cluster, or the persistent grid); of the
    float64 form for ``dtype`` float64."""
    mode = mode or phase_sweeps_mode(n, k, device, dtype)
    out = (ctypes.c_int * len(_SWEEP_INFO_KEYS))()
    fn = getattr(_sweeps_lib(), f"phase_sweeps_info{native.dtype_suffix(dtype)}")
    with torch.cuda.device(device):
        native.check_launch("phase_sweeps", fn(SWEEP_MODES.index(mode), n, k, out))
    return {"mode": mode, **dict(zip(_SWEEP_INFO_KEYS, out))}


def phase_sweeps_gpu(hap, irrs, nbr_idx, nbr_w, nbr_valid, n_iters: int):
    """:func:`phase_sweeps` on the card, whose contract it keeps (CPU
    tensors take it): ``hap`` [2N], ``irrs`` [N] and ``nbr_w`` of one dtype,
    float32 or float64 (the kernel's float64 form; float32 weights beside
    float64 values are widened, exactly: the JAX package keeps the weights'
    own dtype), bool ``nbr_valid`` [2N, K], all contiguous; ``nbr_idx`` [2N, K] or
    [B, 2N, K] (``nbr_w`` likewise) of any integer type, converted to
    int32, every entry in [0, 2N) (the plain version's gather raises
    otherwise; checked here, one synchronisation). The kernel reads the
    lists as they are: no copy into another layout.

    One launch runs all n_iters sweeps of every replicate: in the resident
    mode, a cluster of 8 blocks per replicate, where a block's share of the
    values and lists fits its shared memory (N up to ~6,000 at K=10,
    ~11,000 at K=2 on an H100); beyond that in the persistent mode, one
    cooperative launch with a grid barrier a sweep
    (:func:`phase_sweeps_mode`). Each launch adds one to
    ``phase_sweeps_gpu.launches``. Zero sweeps launch nothing and return
    the start broadcast over the replicates, as the plain version does.
    The sums run in slot order without fused multiply-adds, so the result
    matches the plain version to the rounding of its sums (rtol 1e-5 on
    the card in float32, 1e-12 in float64), and the modes match each other
    bitwise.

    Returns hap [2N] ([B, 2N] for replicates).
    """
    if not native.on_cuda(hap, irrs, nbr_idx, nbr_w, nbr_valid):
        return phase_sweeps(hap, irrs, nbr_idx, nbr_w, nbr_valid, n_iters)
    n = irrs.shape[0]
    if n_iters < 0:
        raise ValueError(f"n_iters={n_iters} must be >= 0")
    dtype = hap.dtype
    native.dtype_suffix(dtype)
    if n_iters == 0:  # no sweep: every value stays where it starts
        native.check(hap, "hap", dtype, (2 * n,))
        return hap.expand(*nbr_idx.shape[:-2], 2 * n)
    if nbr_valid.dim() != 2 or nbr_valid.shape[0] != 2 * n:
        raise ValueError(f"nbr_valid: expected [2N={2 * n}, K], got {tuple(nbr_valid.shape)}")
    k = nbr_valid.shape[1]
    lead = tuple(nbr_idx.shape[:-2])
    if len(lead) > 1 or tuple(nbr_idx.shape[-2:]) != (2 * n, k):
        raise ValueError(f"nbr_idx: expected [2N, K] or [B, 2N, K] with 2N={2 * n}, K={k}, "
                         f"got {tuple(nbr_idx.shape)}")
    if nbr_idx.dtype.is_floating_point or nbr_idx.dtype == torch.bool:
        raise TypeError(f"nbr_idx: expected an integer dtype, got {nbr_idx.dtype}")
    native.check(hap, "hap", dtype, (2 * n,))
    native.check(irrs, "irrs", dtype, (n,))
    if nbr_w.dtype == torch.float32 and dtype == torch.float64:
        nbr_w = nbr_w.to(dtype)  # exact, as the plain version's promotion
    native.check(nbr_w, "nbr_w", dtype, tuple(nbr_idx.shape))
    native.check(nbr_valid, "nbr_valid", torch.bool, (2 * n, k))
    reps = lead[0] if lead else 1
    out = torch.empty((reps, 2 * n), dtype=dtype, device=hap.device)
    if n == 0 or reps == 0 or k == 0:
        # no neighbor anywhere: every value stays where it starts
        out.copy_(hap.expand(reps, 2 * n))
        return out.reshape(*lead, 2 * n)
    idx = nbr_idx.to(torch.int32).contiguous()
    lo, hi = torch.aminmax(idx)
    if int(lo) < 0 or int(hi) >= 2 * n:
        raise ValueError(f"nbr_idx: entries must lie in [0, {2 * n}), got [{int(lo)}, {int(hi)}]")
    mode = phase_sweeps_mode(n, k, hap.device, dtype)
    return _sweeps_launch(mode, hap, irrs, idx, nbr_w, nbr_valid, n_iters, out).reshape(
        *lead, 2 * n)


def _sweeps_launch(mode: str, hap, irrs, idx, nbr_w, nbr_valid, n_iters: int, out):
    """Launch ``phase_sweeps`` in ``mode`` on checked inputs into ``out``
    [B, 2N] (int32 ``idx``; the lists as the callers hold them, [.., 2N,
    K], read in place; the float64 form for float64 values). The wrapper
    picks the mode; the card tests also run the other mode where it takes
    the shape."""
    (reps, two_n), k = out.shape, nbr_valid.shape[1]
    scratch = out if mode == "resident" else torch.empty_like(out)  # the persistent ping-pong
    launch = getattr(_sweeps_lib(), f"phase_sweeps_launch{native.dtype_suffix(out.dtype)}")
    with torch.cuda.device(hap.device):
        err = launch(
            hap.data_ptr(), irrs.data_ptr(), idx.data_ptr(), nbr_w.data_ptr(),
            nbr_valid.data_ptr(), two_n // 2, k, reps, int(idx.dim() == 3), n_iters,
            SWEEP_MODES.index(mode), out.data_ptr(), scratch.data_ptr(),
            native.stream_ptr(hap.device))
    native.check_launch("phase_sweeps", err)
    native.count_launch(phase_sweeps_gpu)
    return out


def _sweeps_probe(part: str, hap, irrs, idx, nbr_w, nbr_valid, n_iters: int, out):
    """The resident kernel with only one part of each sweep ("walk": every
    block sweeps its own samples with no exchange; "exchange": the
    exchange with no list walk; "whole": both, the kernel the resident mode
    launches), to measure what a sweep is made of. Arguments as
    :func:`_sweeps_launch`'s; the values of the parts alone are not the
    sweeps'. Not counted in ``phase_sweeps_gpu.launches``: no caller of the
    port runs it."""
    (reps, two_n), k = out.shape, nbr_valid.shape[1]
    with torch.cuda.device(hap.device):
        err = _sweeps_lib().phase_sweeps_probe(
            SWEEP_PARTS[part], hap.data_ptr(), irrs.data_ptr(), idx.data_ptr(),
            nbr_w.data_ptr(), nbr_valid.data_ptr(), two_n // 2, k, reps, int(idx.dim() == 3),
            n_iters, out.data_ptr(), native.stream_ptr(hap.device))
    native.check_launch("phase_sweeps", err)
    return out


phase_sweeps_gpu.launches = 0


def compute_imputed(hap_irrs, nbr_idx, nbr_w, nbr_valid, mean_irrs):
    """Final-iteration imputation (ref: grid/utils/hi_inference.py:229-250):
    per haplotype the weighted neighbor mean, or ``mean_irrs / 2`` when no
    phased neighbor contributed. Returns imp [2N]."""
    means, wsum = _neighbor_means(hap_irrs, nbr_idx.long(), nbr_w, nbr_valid)
    return torch.where(wsum > 0, means, mean_irrs / 2)


# ----------------------------------------------------------------- host ---


def phase_gauss_seidel_host(irrs, hap_nbrs, min_nbr: int, n_iters: int):
    """Reference-ordered phasing on the host, bit for bit
    (grid/utils/hi_inference.py:175-226: in-place updates, Python float64,
    sequential sums).

    Args:
        irrs: sequence of N diploid IRRs.
        hap_nbrs: ragged list (length 2N) of (neighbor_hap_idx, weight).

    Returns (hap_irrs list[2N], mean_irrs float, phased list[N] bool).
    """
    n = len(irrs)
    hap_irrs = [float("nan")] * (2 * n)
    phased = [False] * n

    n_to_phase = 0
    mean_irrs = 0.0
    for i in range(n):
        if len(hap_nbrs[2 * i]) >= min_nbr and len(hap_nbrs[2 * i + 1]) >= min_nbr:
            hap_irrs[2 * i] = irrs[i] / 2
            hap_irrs[2 * i + 1] = irrs[i] / 2
            phased[i] = True
            n_to_phase += 1
            mean_irrs += irrs[i]
    if n_to_phase > 0:
        mean_irrs /= n_to_phase

    for _ in range(n_iters):
        for i in range(n):
            if math.isnan(hap_irrs[2 * i]):
                continue
            wsum = [1e-9, 1e-9]
            wval = [0.0, 0.0]
            for h in range(2):
                for nbr, w in hap_nbrs[2 * i + h]:
                    val = hap_irrs[nbr]
                    if not math.isnan(val):
                        wsum[h] += w
                        wval[h] += w * val
            m0 = wval[0] / wsum[0]
            m1 = wval[1] / wsum[1]
            denom = m0 + m1
            if denom > 0:
                hap_irrs[2 * i] = irrs[i] * m0 / denom
                hap_irrs[2 * i + 1] = irrs[i] * m1 / denom

    return hap_irrs, mean_irrs, phased


def compute_imputed_host(i, hap_irrs, hap_nbrs, mean_irrs):
    """Host imputation of sample i (grid/utils/hi_inference.py:229-250):
    (imp0, imp1), each the weighted mean of the haplotype's phased
    neighbors, or mean_irrs / 2 where none contributed."""
    wsum = [1e-9, 1e-9]
    wval = [0.0, 0.0]
    for h in range(2):
        for nbr, w in hap_nbrs[2 * i + h]:
            val = hap_irrs[nbr]
            if not math.isnan(val):
                wsum[h] += w
                wval[h] += w * val
    imp0 = wval[0] / wsum[0]
    imp1 = wval[1] / wsum[1]
    if wsum[0] <= 1e-9:
        imp0 = mean_irrs / 2
    if wsum[1] <= 1e-9:
        imp1 = mean_irrs / 2
    return imp0, imp1


# ------------------------------------------------------------- bootstrap ---


def bootstrap_slots(nbr_valid, n_boot: int, generator: torch.Generator):
    """The slots each bootstrap replicate draws: [n_boot, 2N, K] int64,
    uniform in [0, deg) for a haplotype of degree deg (valid neighbors are
    the prefix of its row), 0 where deg is 0. Drawn on ``generator``'s
    device, which must be nbr_valid's."""
    deg = nbr_valid.sum(dim=1).clamp_min(1)  # [2N]
    u = torch.rand((n_boot, *nbr_valid.shape), generator=generator, dtype=torch.float64,
                   device=nbr_valid.device)
    # floor(u * deg), kept below deg where u * deg rounds up to it
    return torch.minimum((u * deg[None, :, None]).long(), deg[None, :, None] - 1)


def phase_bootstrap_slots(irrs, nbr_idx, nbr_w, nbr_valid, slots, min_nbr: int, n_iters: int):
    """The bootstrap replicates of :func:`phase_haplotypes` for given slots:
    replicate b takes ``nbr_idx[h, slots[b, h]]`` and its weight in place of
    each neighbor of haplotype h (validity, and with it the min_nbr gate,
    is kept), and all replicates run through the sweeps at once.

    Returns (hap_mean [2N], hap_std [2N] (population), hap_boot [B, 2N]).
    """
    b = slots.shape[0]
    bi = torch.gather(nbr_idx.long().expand(b, *nbr_idx.shape), 2, slots)
    bw = torch.gather(nbr_w.expand(b, *nbr_w.shape), 2, slots)
    hap_boot = phase_haplotypes(irrs, bi, bw, nbr_valid, min_nbr, n_iters).hap_irrs
    return hap_boot.mean(dim=0), hap_boot.std(dim=0, correction=0), hap_boot


def phase_bootstrap(generator, irrs, nbr_idx, nbr_w, nbr_valid, min_nbr: int, n_iters: int,
                    n_boot: int = 100):
    """Bootstrap uncertainty of the haplotype estimates (the twin of
    ``grid_tpu.ops.phasing.phase_bootstrap``, with a ``torch.Generator`` in
    place of a JAX key): each of n_boot replicates resamples every
    haplotype's neighbor list with replacement (:func:`bootstrap_slots`)
    and reruns the n_iters sweeps (:func:`phase_bootstrap_slots`). The
    draws differ from JAX's; their distribution is the same.

    Returns (hap_mean [2N], hap_std [2N], hap_boot [n_boot, 2N]).
    """
    slots = bootstrap_slots(nbr_valid, n_boot, generator)
    return phase_bootstrap_slots(irrs, nbr_idx, nbr_w, nbr_valid, slots, min_nbr, n_iters)
