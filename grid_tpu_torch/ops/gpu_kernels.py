"""Hopper kernels for the cohort step's normalize statistics and Gram matrix.

- :func:`masked_column_stats` — Triton. Replaces
  ``grid_tpu/ops/pallas_kernels.py:masked_column_stats`` (``pallas_call`` at
  line 168). Per column: count, sum and centered sum of squares of
  x = values * inv_row_mean under the mask. It is bound by device memory: it
  reads the [N, R] values (4 B) and mask (1 B) once and does a few flops per
  element, 25.6 MB per call at N=2504, R=2048, 7.7 µs at 3.35 TB/s. The grid
  is (column tiles of 32, S row chunks), with S chosen from N, R and the
  SM count (:func:`colstats_plan`) so the grid holds at least 4 programs per
  SM: S=10 chunks of 272 rows at 2504×2048 (640 programs of two warps on
  132 SMs), S=1 at the genome-wide 100 × 3,000,000. Narrow tiles and long
  row loops keep each program's loads in flight. Each program sums its
  chunk and writes its partial count, sum and sqdev into a [S, 3, R]
  float32 scratch; a second small kernel adds the S partials in chunk
  order. No float atomics, so two calls on the same inputs give
  bitwise-equal outputs. With S=1 the scratch is the output and the
  second kernel is not launched. Its float64 form is the same two kernels
  with float64 inputs, accumulators and partials (8 B a value: 46 MB, 14 µs
  at 3.35 TB/s, at N=2504, R=2048).
- :func:`zprep_gram` — CUDA C++ in ``csrc/zprep_gram.cu``. Replaces
  ``pallas_kernels.py:zprep_gram`` (``pallas_call`` at line 93). See the
  source for its design. The row-panel branch runs the same kernel in two
  more modes: :func:`zprep_split` once per step (P's TF32 halves and the
  squared row norms), then :func:`zprep_gram_panel` once per row panel.
  The sharded ring's fourth mode, :func:`zprep_gram_cross`, multiplies a
  rank's split rows by the visiting block's. Float64 inputs take
  ``csrc/zprep_gram64.cu`` instead (the triangle, split, panel and cross
  modes: 128x128 tiles of FP64 tensor-core ``mma.sync`` m16n8k16 fed by a
  4-stage TMA ring, one tile an SM; no split: P itself stands in
  ``SplitZ.p``). bfloat16 inputs take ``csrc/zprep_gram16.cu`` (the
  triangle, split, panel and cross modes: 128x256 tiles of bf16 ``wgmma``
  m64n256k16 into one float32 accumulator over R, a persistent walk of one
  block an SM, G rounded to bf16 in registers and stored by TMA; the split
  pass gives the norms as ``grid_tpu`` sums them, ``sum(P * P)`` in
  float32 rounded once, not G's diagonal).

Each wrapper runs its kernel for CUDA tensors and its plain PyTorch version
for CPU tensors only; it counts its calls that reached the card in
``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from grid_tpu_torch import native

_COLSTATS_BLOCK_M = 16  # rows per step of a program's row loop
_COLSTATS_BLOCK_C = 32  # columns per program (one 128-byte line of f32 per row)
_COLSTATS_WARPS = 2
_COLSTATS_PROGRAMS_PER_SM = 4  # the least the main pass's grid holds
_COLSTATS_MERGE_BLOCK = 256  # partial entries per program of the merge kernel


# ---------------------------------------------------------------------------
# masked_column_stats (Triton)
# ---------------------------------------------------------------------------


def masked_column_stats_plain(values, mask, row_scale, col_means=None, round_squares=True,
                              wide=False):
    """Plain PyTorch version of :func:`masked_column_stats`, in the input's
    dtype (bfloat16: x = values / row_scale, and with ``round_squares``
    False its squares summed exactly, in float32; with ``wide`` the three
    float32 sums, not rounded).

    The sums run along contiguous rows of the transposed matrix: summed
    across the rows in place, a column's sum depended on its position (the
    CPU reduction takes the last columns of a row by another order), so two
    equal columns could differ in the last bit, and the high-variance
    selection's strict ``>`` then split columns that tie exactly. In
    bfloat16 every elementwise step rounds to bfloat16 and the sums
    accumulate in float32 and round once, as ``grid_tpu``'s do."""
    half = values.dtype == torch.bfloat16
    row = row_scale[:, None]
    x = torch.where(mask, values / row if half else values * row, 0)
    mu = 0 if col_means is None else col_means[None, :]
    centered = torch.where(mask, x - mu, 0)
    if half and wide:
        squares = centered.float() * centered.float()
        if round_squares:
            squares = squares.to(values.dtype).float()
        return (mask.sum(dim=0).float(), x.float().t().contiguous().sum(dim=1),
                squares.t().contiguous().sum(dim=1))
    exact = centered.float() if half and not round_squares else centered
    sqdev = (exact * exact).t().contiguous().sum(dim=1)
    return (mask.sum(dim=0).to(values.dtype), x.t().contiguous().sum(dim=1),
            sqdev.to(values.dtype))


def colstats_plan(n: int, r: int, n_sm: int) -> tuple[int, int, int]:
    """(column tiles, S row chunks, rows per chunk) of the column-statistics
    grid for an [n, r] matrix on a card with ``n_sm`` SMs: chunks of a
    whole number of row steps, as few as give at least 4 programs per SM
    (S=1 when the column tiles alone do), and one row step each when even
    that falls short."""
    col_tiles = -(-r // _COLSTATS_BLOCK_C)
    row_steps = max(1, -(-n // _COLSTATS_BLOCK_M))
    want = -(-(_COLSTATS_PROGRAMS_PER_SM * n_sm) // col_tiles)  # chunks wanted
    steps_per_chunk = max(1, row_steps // want)
    return col_tiles, -(-row_steps // steps_per_chunk), steps_per_chunk * _COLSTATS_BLOCK_M


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.cache
def _colstats_kernels():
    import triton
    import triton.language as tl

    # the sums, the partials and the output keep the values' type (float32
    # or float64); bfloat16 values are summed into float32 partials
    @triton.jit
    def colstats(v_ptr, m_ptr, irm_ptr, mu_ptr, part_ptr, n_rows, n_cols, rows_per_chunk,
                 HAS_MU: tl.constexpr, BLOCK_M: tl.constexpr, BLOCK_C: tl.constexpr,
                 HALF: tl.constexpr = False, ROUND_SQ: tl.constexpr = True):
        ACC = part_ptr.dtype.element_ty
        VT = v_ptr.dtype.element_ty
        cols = tl.program_id(0) * BLOCK_C + tl.arange(0, BLOCK_C)
        chunk = tl.program_id(1)
        col_in = cols < n_cols
        if HAS_MU:
            mu = tl.load(mu_ptr + cols, mask=col_in, other=0.0).to(ACC)
        else:
            mu = tl.zeros((BLOCK_C,), ACC)
        acc_cnt = tl.zeros((BLOCK_M, BLOCK_C), ACC)
        acc_sum = tl.zeros((BLOCK_M, BLOCK_C), ACC)
        acc_sq = tl.zeros((BLOCK_M, BLOCK_C), ACC)
        row0 = chunk * rows_per_chunk
        for r0 in range(0, rows_per_chunk, BLOCK_M):
            rows = row0 + r0 + tl.arange(0, BLOCK_M)
            row_in = rows < n_rows
            inb = row_in[:, None] & col_in[None, :]
            offs = rows[:, None].to(tl.int64) * n_cols + cols[None, :]
            v = tl.load(v_ptr + offs, mask=inb, other=0.0).to(ACC)
            m = tl.load(m_ptr + offs, mask=inb, other=0) != 0
            irm = tl.load(irm_ptr + rows, mask=row_in, other=0.0).to(ACC)
            if HALF:
                # bfloat16: x = values / row mean and x - mu each rounded to
                # bfloat16 (the division correctly rounded), and the square
                # too where ROUND_SQ, as grid_tpu rounds them; the sums stay
                # in float32
                x = tl.where(m, tl.math.div_rn(v, irm[:, None]).to(VT).to(ACC), 0.0)
                c = tl.where(m, (x - mu[None, :]).to(VT).to(ACC), 0.0)
                if ROUND_SQ:
                    acc_sq += (c * c).to(VT).to(ACC)
                else:
                    acc_sq += c * c
            else:
                x = tl.where(m, v * irm[:, None], 0.0)
                c = tl.where(m, x - mu[None, :], 0.0)
                acc_sq += c * c
            acc_cnt += m.to(ACC)
            acc_sum += x
        # partials [S, 3, R]: this chunk's count, sum and sqdev rows
        out = part_ptr + chunk.to(tl.int64) * 3 * n_cols + cols
        tl.store(out, tl.sum(acc_cnt, axis=0), mask=col_in)
        tl.store(out + n_cols, tl.sum(acc_sum, axis=0), mask=col_in)
        tl.store(out + 2 * n_cols, tl.sum(acc_sq, axis=0), mask=col_in)

    @triton.jit
    def colstats_merge(part_ptr, out_ptr, width, N_CHUNKS: tl.constexpr, BLOCK: tl.constexpr):
        # out[j] = sum over s of part[s, j], s in order: deterministic; the
        # loop is unrolled, so all S loads are in flight together. The store
        # rounds float32 partials once into a bfloat16 output
        ACC = part_ptr.dtype.element_ty
        offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        inb = offs < width
        acc = tl.zeros((BLOCK,), ACC)
        for s in tl.static_range(N_CHUNKS):
            acc += tl.load(part_ptr + s * width + offs, mask=inb, other=0.0)
        tl.store(out_ptr + offs, acc, mask=inb)

    return triton, colstats, colstats_merge


def masked_column_stats(values, mask, row_scale, col_means=None, round_squares=True,
                        wide=False):
    """Per-column (count, sum, sqdev_sum) of x = values * row_scale under
    ``mask`` (bfloat16: x = values / row_scale), in one pass over the
    matrix.

    Same contract as the Pallas kernel (whose tile sizes and ``interpret``
    flag are TPU knobs with no counterpart here). On the card a call
    launches the row-chunk kernel and, when the plan has more than one
    chunk, the merge kernel; ``masked_column_stats.launches`` counts calls
    that reached the card, not kernels.

    bfloat16: ``row_scale`` holds the row means and x = values / row mean,
    as ``grid_tpu`` divides (a product with the reciprocal would round
    twice); x and x - mu each round to
    bfloat16, and so does the square (``round_squares``, as ``grid_tpu``'s
    op-by-op file step 4 rounds it; its jitted fused step sums the exact
    squares), the sums accumulate in float32 partials, and the merge
    kernel, launched whatever the number of chunks, rounds each output
    once, or, with ``wide``, writes the float32 sums as they are (the
    sharded normalize's partials, which the ranks add before they round:
    ``parallel/pstats.py``). Its bound at N=2504, R=2048 is 15.4 MB, 4.6 us
    at 3.35 TB/s.

    Args:
        values: [N, R] raw depths.
        mask: [N, R] bool validity; counted as given, so pass it with bad
            rows already cleared.
        row_scale: [N] 1/row_mean (0 for invalid rows); in bfloat16 the
            row means (1 for invalid rows).
        col_means: optional [R]; sqdev is centered on it (zeros when None).
        round_squares: bfloat16 only: round each (x - mu)^2 to bfloat16
            before it is summed.
        wide: bfloat16 only: return the float32 sums, not rounded.

    Returns (cnt [R], sum [R], sqdev [R]) in the input dtype: float32,
    float64 or bfloat16 from the kernel (the sums kept in that type, in
    float32 for bfloat16; float32 with ``wide``), any float type from the
    plain version.
    """
    tensors = (values, mask, row_scale) + (() if col_means is None else (col_means,))
    if not native.on_cuda(*tensors):
        return masked_column_stats_plain(values, mask, row_scale, col_means, round_squares, wide)
    n, r = values.shape
    dtype = values.dtype
    native.dtype_suffix(dtype, bf16=True)  # float32, float64 or bfloat16
    half = dtype == torch.bfloat16
    native.check(values, "values", dtype, (n, r))
    native.check(mask, "mask", torch.bool, (n, r))
    native.check(row_scale, "row_scale", dtype, (n,))
    if col_means is not None:
        native.check(col_means, "col_means", dtype, (r,))
    col_tiles, chunks, rows_per_chunk = colstats_plan(n, r, _sm_count(values.device))
    part = torch.empty((chunks, 3, r), dtype=torch.float32 if half else dtype,
                       device=values.device)
    merged = chunks > 1 or half
    out_dtype = torch.float32 if half and wide else dtype
    out = torch.empty((3, r), dtype=out_dtype, device=values.device) if merged else part[0]
    try:
        triton, kernel, merge = _colstats_kernels()
        with torch.cuda.device(values.device):
            # Triton launches on PyTorch's current stream and raises itself
            # when it cannot compile a kernel or CUDA refuses a launch.
            kernel[(col_tiles, chunks)](
                values, mask.view(torch.uint8), row_scale,
                values if col_means is None else col_means,  # unread when HAS_MU is False
                part, n, r, rows_per_chunk,
                HAS_MU=col_means is not None,
                BLOCK_M=_COLSTATS_BLOCK_M, BLOCK_C=_COLSTATS_BLOCK_C, HALF=half,
                ROUND_SQ=round_squares, num_warps=_COLSTATS_WARPS,
            )
            if merged:
                merge[(triton.cdiv(3 * r, _COLSTATS_MERGE_BLOCK),)](
                    part, out, 3 * r, N_CHUNKS=chunks, BLOCK=_COLSTATS_MERGE_BLOCK, num_warps=4)
    except Exception as e:
        raise native.KernelError(f"masked_column_stats: the Triton kernels did not compile or "
                                 f"launch: {e}") from e
    native.count_launch(masked_column_stats)
    return out[0], out[1], out[2]


masked_column_stats.launches = 0


def compile_masked_column_stats(n: int, r: int, device: torch.device,
                                dtype: torch.dtype = torch.float32) -> None:
    """Compile the column-statistics kernels for [n, r] inputs of ``dtype``
    on the CUDA ``device`` (both centrings, and the merge where the plan has
    more than one chunk, or, for bfloat16, always: its float32 sums as the
    sharded step takes them) without launching them, by Triton's warm-up:
    the kernels land in Triton's cache, where the ranks of the sharded step,
    spawned later, find them. Triton specializes on the integer arguments'
    values, so the shape must be the one the calls will have."""
    col_tiles, chunks, rows_per_chunk = colstats_plan(n, r, _sm_count(device))
    half = dtype == torch.bfloat16
    vals = torch.empty(1, dtype=dtype, device=device)
    acc = torch.empty(1, dtype=torch.float32 if half else dtype, device=device)
    u8 = torch.empty(1, dtype=torch.uint8, device=device)
    # bfloat16: as the cohort step calls it, the squares summed exactly
    extra = {"HALF": True, "ROUND_SQ": False} if half else {}
    try:
        triton, kernel, merge = _colstats_kernels()
        with torch.cuda.device(device):
            for has_mu in (False, True):
                kernel.warmup(vals, u8, vals, vals, acc, n, r, rows_per_chunk, HAS_MU=has_mu,
                              BLOCK_M=_COLSTATS_BLOCK_M, BLOCK_C=_COLSTATS_BLOCK_C,
                              num_warps=_COLSTATS_WARPS, grid=(col_tiles, chunks), **extra)
            if chunks > 1 or half:
                merge.warmup(acc, acc, 3 * r, N_CHUNKS=chunks, BLOCK=_COLSTATS_MERGE_BLOCK,
                             num_warps=4, grid=(triton.cdiv(3 * r, _COLSTATS_MERGE_BLOCK),))
    except Exception as e:
        raise native.KernelError(f"masked_column_stats: the Triton kernels did not compile: "
                                 f"{e}") from e


# ---------------------------------------------------------------------------
# zprep_gram (CUDA C++, csrc/zprep_gram.cu)
# ---------------------------------------------------------------------------


def _prepare(z, mask, region_mask, zmax: float):
    """P = where(mask, clip(z, ±zmax), 0) * region; a None mask or region
    keeps every entry."""
    p = z.clamp(-zmax, zmax)
    if mask is not None:
        p = torch.where(mask, p, 0)
    if region_mask is not None:
        p = p * region_mask[None, :].to(z.dtype)
    return p


def _norms(p, g=None):
    """The squared norms of P's rows: G's diagonal in float32 and float64
    (``g``), else ``sum(P * P)``; in bfloat16 as ``grid_tpu``'s jitted step
    sums them, the squares exact and the sum kept in float32 and rounded
    once (XLA does not round the products it feeds a reduction)."""
    if p.dtype == torch.bfloat16:
        wide = p.float()
        return (wide * wide).sum(dim=1).to(p.dtype)
    return (p * p).sum(dim=1) if g is None else torch.diagonal(g)


def zprep_gram_plain(z, mask, region_mask, zmax: float, norms: bool = False):
    """Plain PyTorch version of :func:`zprep_gram`: prepare, then P @ P^T
    (and the norms)."""
    p = _prepare(z, mask, region_mask, zmax)
    g = p @ p.T
    return (g, _norms(p, g)) if norms else g


_GRAM_K_TILE = 32  # R columns per stage of csrc/zprep_gram.cu in float32; R is padded to it
_GRAM64_K_TILE = 16  # the same of csrc/zprep_gram64.cu
_GRAM16_K_STEP = 16  # the bf16 form's R_pad multiple (its stages are 64 columns)
_GRAM_INFO_KEYS = ("tile", "k_tile", "stages", "threads", "smem_bytes", "blocks",
                   "blocks_per_sm")
# float64: smem_bytes is the dynamic shared memory (the ring)
_GRAM64_INFO_KEYS = (*_GRAM_INFO_KEYS, "registers", "spill_bytes", "static_smem_bytes")
_GRAM64_MODES = {"triangle": 0, "panel": 1, "split": 2, "cross": 3}
# bfloat16: smem_bytes is the dynamic shared memory (the ring and the
# staged boxes of G); "grid" the blocks launched, one an SM, which walk
# the "tiles"
_GRAM16_INFO_KEYS = ("tile_rows", "tile_cols", "k_tile", "stages", "threads", "smem_bytes",
                     "epilogue_boxes", "tiles", "blocks_per_sm", "grid", "registers",
                     "spill_bytes", "static_smem_bytes")
_GRAM16_MODES = {"triangle": 0, "panel": 1, "cross": 3}


@functools.cache
def _zprep_lib():
    lib = native.load("zprep_gram")
    lib.zprep_gram_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.zprep_gram_launch.restype = ctypes.c_int
    lib.zprep_split_launch.argtypes = lib.zprep_gram_launch.argtypes
    lib.zprep_split_launch.restype = ctypes.c_int
    lib.zprep_gram_panel_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p]
    lib.zprep_gram_panel_launch.restype = ctypes.c_int
    lib.zprep_gram_cross_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.zprep_gram_cross_launch.restype = ctypes.c_int
    lib.zprep_gram_info.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.zprep_gram_info.restype = ctypes.c_int
    return lib


@functools.cache
def _zprep16_lib():
    lib = native.load("zprep_gram16")
    # the triangle also writes the norms
    lib.zprep_gram16_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p]
    lib.zprep_split16_launch.argtypes = [*lib.zprep_gram16_launch.argtypes[:9],
                                         ctypes.c_void_p]
    lib.zprep_gram16_panel_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p]
    lib.zprep_gram16_cross_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.zprep_gram16_info.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                      ctypes.POINTER(ctypes.c_int)]
    for fn in (lib.zprep_gram16_launch, lib.zprep_split16_launch, lib.zprep_gram16_panel_launch,
               lib.zprep_gram16_cross_launch, lib.zprep_gram16_info):
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def _zprep64_lib():
    lib = native.load("zprep_gram64")
    lib.zprep_gram64_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_double, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.zprep_gram64_launch.restype = ctypes.c_int
    lib.zprep_split64_launch.argtypes = lib.zprep_gram64_launch.argtypes
    lib.zprep_split64_launch.restype = ctypes.c_int
    lib.zprep_gram64_panel_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p]
    lib.zprep_gram64_panel_launch.restype = ctypes.c_int
    lib.zprep_gram64_cross_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.zprep_gram64_cross_launch.restype = ctypes.c_int
    lib.zprep_gram64_info.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                      ctypes.POINTER(ctypes.c_int)]
    lib.zprep_gram64_info.restype = ctypes.c_int
    return lib


def _gram_lib(dtype: torch.dtype) -> tuple:
    """(library name, library, entry-point suffix) of the Gram kernel for
    ``dtype``: csrc/zprep_gram.cu for float32, zprep_gram64.cu for float64,
    zprep_gram16.cu for bfloat16."""
    if dtype == torch.float64:
        return "zprep_gram64", _zprep64_lib(), "64"
    if dtype == torch.bfloat16:
        return "zprep_gram16", _zprep16_lib(), "16"
    return "zprep_gram", _zprep_lib(), ""


def _r_pad(r: int, dtype: torch.dtype) -> int:
    """R rounded up to the K-stage of the dtype's Gram kernel (at least one;
    bfloat16: one k16 step, the TMA box's columns past it read as zeros)."""
    k_tile = {torch.float64: _GRAM64_K_TILE, torch.bfloat16: _GRAM16_K_STEP}.get(dtype,
                                                                              _GRAM_K_TILE)
    return max(1, -(-r // k_tile)) * k_tile


def _require_hopper(device: torch.device) -> None:
    cap = torch.cuda.get_device_capability(device)
    if cap != (9, 0):
        raise native.KernelError(f"zprep_gram is built for sm_90a (Hopper); {device} has compute "
                           f"capability {cap[0]}.{cap[1]}")


def zprep_gram_info(n: int, device: torch.device, dtype: torch.dtype = torch.float32,
                    mode: str = "triangle", rows: int | None = None) -> dict:
    """The Gram kernel's launch shape for ``n`` rows: tile, k_tile, stages,
    threads and dynamic shared memory per block, blocks (upper-triangle
    tiles) and resident blocks per SM on the CUDA ``device``; for float64,
    the FP64 kernel's in ``mode`` ("triangle", "split": the diagonal tiles,
    "panel" of ``rows`` rows: its row tiles times the column tiles, or
    "cross" of a block of ``rows`` rows by one of ``n``: the same tiles),
    with its registers and spill bytes a thread and its static shared
    memory; for bfloat16, the bf16 kernel's in ``mode`` ("triangle",
    "panel" of ``rows`` rows, or "cross" of a block of ``rows`` rows by one
    of ``n``): its tile's rows and columns, k-stage,
    stages, threads, dynamic shared memory and staged boxes of G a block,
    tiles, resident blocks an SM, the blocks of its persistent walk
    ("grid", one an SM), registers, spill bytes and static shared
    memory."""
    _require_hopper(device)
    if dtype == torch.bfloat16:
        out = (ctypes.c_int * len(_GRAM16_INFO_KEYS))()
        with torch.cuda.device(device):
            native.check_launch("zprep_gram16", _zprep16_lib().zprep_gram16_info(
                n, n if rows is None else rows, _GRAM16_MODES[mode], out))
        return dict(zip(_GRAM16_INFO_KEYS, out))
    if dtype == torch.float64:
        out = (ctypes.c_int * len(_GRAM64_INFO_KEYS))()
        with torch.cuda.device(device):
            native.check_launch("zprep_gram64", _zprep64_lib().zprep_gram64_info(
                n, n if rows is None else rows, _GRAM64_MODES[mode], out))
        return dict(zip(_GRAM64_INFO_KEYS, out))
    out = (ctypes.c_int * len(_GRAM_INFO_KEYS))()
    with torch.cuda.device(device):
        native.check_launch("zprep_gram", _zprep_lib().zprep_gram_info(n, out))
    return dict(zip(_GRAM_INFO_KEYS, out))


def zprep_gram(z, mask, region_mask, zmax: float, norms: bool = False):
    """G = P P^T with P = where(mask, clip(z, ±zmax), 0) * region_mask.

    On the card, float32: a split pass writes P's TF32 halves (scratch of
    2·N·R_pad float32, R_pad = R rounded up to 32), then the upper-triangle
    tiles of G run as three TF32 tensor-core products (big·small +
    small·big + big·big) at float32 accuracy. Float64: a prep pass writes P
    (N·R_pad float64, R_pad a multiple of 16), then the upper-triangle
    128x128 tiles run on the FP64 tensor cores (``mma.sync`` m16n8k16, IEEE
    float64). bfloat16: the split pass writes P (N·R_pad bf16, R_pad a
    multiple of 16) and the norms, then one block an SM walks the
    triangle's 128x256 tiles of bf16 wgmma products, each entry summed in
    float32 over R and rounded to bf16 once (``csrc/zprep_gram16.cu``). G comes out exactly
    symmetric either way. Needs compute capability 9.0.

    Args:
        z: [N, R] float32, float64 or bfloat16 z matrix.
        mask: [N, R] bool validity.
        region_mask: [R] bool selected regions.
        zmax: clip bound.
        norms: also return the squared norms of P's rows (G's diagonal in
            float32 and float64; in bfloat16 ``sum(P * P)`` as ``grid_tpu``
            sums it, from the split pass: :func:`_norms`).

    Returns [N, N] Gram matrix in z's dtype, or (G, norms [N]).
    """
    if not native.on_cuda(z, mask, region_mask):
        return zprep_gram_plain(z, mask, region_mask, zmax, norms)
    n, r = z.shape
    dtype = z.dtype
    # float32: csrc/zprep_gram.cu; float64: csrc/zprep_gram64.cu; bfloat16:
    # csrc/zprep_gram16.cu
    native.dtype_suffix(dtype, bf16=True)
    native.check(z, "z", dtype, (n, r))
    native.check(mask, "mask", torch.bool, (n, r))
    native.check(region_mask, "region_mask", torch.bool, (r,))
    _require_hopper(z.device)
    r_pad = _r_pad(r, dtype)
    g = torch.empty((n, n), dtype=dtype, device=z.device)
    if dtype == torch.bfloat16:
        sq = torch.empty(n, dtype=dtype, device=z.device)
        scratch = torch.empty((n, r_pad), dtype=dtype, device=z.device)
        with torch.cuda.device(z.device):
            err = _zprep16_lib().zprep_gram16_launch(
                z.data_ptr(), mask.data_ptr(), region_mask.data_ptr(), float(zmax), n, r, r_pad,
                scratch.data_ptr(), sq.data_ptr(), g.data_ptr(), native.stream_ptr(z.device))
        native.check_launch("zprep_gram16", err)
        native.count_launch(zprep_gram)
        return (g, sq) if norms else g
    if dtype == torch.float64:
        name, launch = "zprep_gram64", _zprep64_lib().zprep_gram64_launch
        scratch = torch.empty((n, r_pad), dtype=dtype, device=z.device)
    else:
        name, launch = "zprep_gram", _zprep_lib().zprep_gram_launch
        scratch = torch.empty((2, n, r_pad), dtype=dtype, device=z.device)
    with torch.cuda.device(z.device):
        err = launch(z.data_ptr(), mask.data_ptr(), region_mask.data_ptr(), float(zmax), n, r,
                     r_pad, scratch.data_ptr(), g.data_ptr(), native.stream_ptr(z.device))
    native.check_launch(name, err)
    native.count_launch(zprep_gram)
    return (g, torch.diagonal(g)) if norms else g


zprep_gram.launches = 0


class SplitZ(NamedTuple):
    """P = where(mask, clip(z, ±zmax), 0) * region, prepared once per step
    for the Gram row panels (:func:`zprep_split`)."""

    # on the card [2, N, R_pad] TF32 halves of P (float32) or [1, N, R_pad]
    # P itself (float64, bfloat16); P [N, R] itself on the CPU
    p: torch.Tensor
    norms: torch.Tensor  # [N] squared norms of P's rows (bfloat16: grid_tpu's sum(P * P))


def zprep_split_plain(z, mask, region_mask, zmax: float) -> SplitZ:
    """Plain PyTorch version of :func:`zprep_split`: P itself and
    sum(P * P) per row (:func:`_norms`)."""
    p = _prepare(z, mask, region_mask, zmax)
    return SplitZ(p, _norms(p))


def zprep_split(z, mask, region_mask, zmax: float) -> SplitZ:
    """The once-per-step pass of the row-panel branch.

    On the card: the split pass writes P's TF32 halves (2·N·R_pad float32,
    512 MB at N=65,536, R=1024) and the Gram kernel's diagonal tiles give
    the squared row norms as the diagonal of the same 3×TF32 product that
    :func:`zprep_gram` and :func:`zprep_gram_panel` compute, bitwise equal
    to the diagonal of :func:`zprep_gram`'s G. Float64: the prep pass writes
    P as [1, N, R_pad] float64 (512 MB at N=65,536, R=1024) and the FP64
    kernel's diagonal tiles give the norms, computed as each panel computes
    G[i, i]. bfloat16: the split pass alone writes P as [1, N, R_pad] bf16
    and the norms as ``grid_tpu`` sums them (:func:`_norms`). Needs compute
    capability 9.0.

    Args:
        z: [N, R] float32, float64 or bfloat16 z matrix.
        mask: [N, R] bool validity, or None for z prepared already.
        region_mask: [R] bool selected regions, or None for all.
        zmax: clip bound (``math.inf`` for z prepared already).
    """
    tensors = [t for t in (z, mask, region_mask) if t is not None]
    if not native.on_cuda(*tensors):
        return zprep_split_plain(z, mask, region_mask, zmax)
    n, r = z.shape
    dtype = z.dtype
    # float32: csrc/zprep_gram.cu; float64: csrc/zprep_gram64.cu; bfloat16:
    # csrc/zprep_gram16.cu
    native.dtype_suffix(dtype, bf16=True)
    native.check(z, "z", dtype, (n, r))
    if mask is not None:
        native.check(mask, "mask", torch.bool, (n, r))
    if region_mask is not None:
        native.check(region_mask, "region_mask", torch.bool, (r,))
    _require_hopper(z.device)
    r_pad = _r_pad(r, dtype)
    split = torch.empty((2 if dtype == torch.float32 else 1, n, r_pad), dtype=dtype,
                        device=z.device)
    norms = torch.empty(n, dtype=dtype, device=z.device)
    name, lib, suffix = _gram_lib(dtype)
    launch = getattr(lib, f"zprep_split{suffix}_launch")
    with torch.cuda.device(z.device):
        err = launch(
            z.data_ptr(), 0 if mask is None else mask.data_ptr(),
            0 if region_mask is None else region_mask.data_ptr(), float(zmax), n, r, r_pad,
            split.data_ptr(), norms.data_ptr(), native.stream_ptr(z.device))
    native.check_launch(name, err)
    native.count_launch(zprep_split)
    return SplitZ(split, norms)


zprep_split.launches = 0


def zprep_gram_panel_plain(split: SplitZ, i0: int, rows: int):
    """Plain PyTorch version of :func:`zprep_gram_panel`:
    ``P[i0:i0+rows] @ P.T``."""
    p = split.p
    return p[i0:i0 + rows] @ p.T


def zprep_gram_panel(split: SplitZ, i0: int, rows: int):
    """G[i0:i0+rows, :] = P[i0:i0+rows] P^T, one row panel [rows, N].

    On the card the Gram kernel runs over (the panel's row tiles) × (all
    column tiles) of the halves in ``split``, with the 3×TF32 arithmetic of
    :func:`zprep_gram`, and stores the panel once (no triangle, no mirror);
    a float64 split takes the FP64 kernel over its P, a bfloat16 one the
    bf16 kernel (its 128x256 tiles over the panel's row tiles and 256-column
    tiles, the panel rounded to bf16 once; each entry bitwise the bf16
    triangle's).
    """
    if not native.on_cuda(split.p, split.norms):
        return zprep_gram_panel_plain(split, i0, rows)
    _, n, r_pad = split.p.shape
    dtype = split.p.dtype
    native.dtype_suffix(dtype, bf16=True)
    native.check(split.p, "split", dtype, (2 if dtype == torch.float32 else 1, n, r_pad))
    if not (0 <= i0 and 0 < rows <= n - i0):
        raise ValueError(f"panel rows [{i0}, {i0 + rows}) outside [0, {n})")
    g = torch.empty((rows, n), dtype=dtype, device=split.p.device)
    name, lib, suffix = _gram_lib(dtype)
    launch = getattr(lib, f"zprep_gram{suffix}_panel_launch")
    with torch.cuda.device(g.device):
        err = launch(split.p.data_ptr(), n, r_pad, i0, rows, g.data_ptr(),
                     native.stream_ptr(g.device))
    native.check_launch(name, err)
    native.count_launch(zprep_gram_panel)
    return g


zprep_gram_panel.launches = 0


def zprep_gram_cross_plain(a: SplitZ, b: SplitZ, a_row0: int = 0, b_row0: int = 0):
    """Plain PyTorch version of :func:`zprep_gram_cross`, in any of the
    three dtypes: ``P_a @ P_b.T`` of the plain splits' P (bfloat16 in
    bfloat16; the offsets only place the kernel's entries)."""
    return a.p @ b.p.T


def zprep_gram_cross(a: SplitZ, b: SplitZ, a_row0: int = 0, b_row0: int = 0):
    """G = P_a P_b^T [Ba, Bb] for two row blocks split by :func:`zprep_split`:
    the sharded ring's product of a rank's rows with the visiting block.

    On the card the Gram kernel runs over (a's row tiles) x (b's row tiles)
    with one pair of tensor maps per block and the arithmetic of
    :func:`zprep_gram_panel`; ``a_row0`` and ``b_row0``, the blocks' first
    rows in the cohort, make every entry bitwise the one
    ``zprep_gram_panel`` gives those two rows of one split of the whole
    cohort. Float32 (3xTF32): the panel mode mirrors the lower half of its
    diagonal tiles, and a second small launch does the same here. Float64
    splits ([1, B, R_pad], P itself) take the FP64 kernel's cross mode in
    one launch: its products are symmetric bit for bit, so the mirror
    changes nothing there (``csrc/zprep_gram64.cu``). bfloat16 splits
    ([1, B, R_pad], P itself) take the bf16 kernel's cross mode, one launch
    of the panel mode's 128x256 tiles over (a's row tiles) x (b's 256-column
    tiles), G rounded to bf16 once (``csrc/zprep_gram16.cu``); its entries
    are summed in one order wherever they sit in a tile, so the offsets
    place none of them. Needs compute capability 9.0.
    """
    if not native.on_cuda(a.p, a.norms, b.p, b.norms):
        return zprep_gram_cross_plain(a, b, a_row0, b_row0)
    _, na, r_pad = a.p.shape
    nb = b.p.shape[1]
    dtype = a.p.dtype
    native.dtype_suffix(dtype, bf16=True)
    halves = 2 if dtype == torch.float32 else 1
    native.check(a.p, "a", dtype, (halves, na, r_pad))
    native.check(b.p, "b", dtype, (halves, nb, r_pad))
    if a_row0 < 0 or b_row0 < 0:
        raise ValueError(f"block offsets must be >= 0, got {a_row0}, {b_row0}")
    _require_hopper(a.p.device)
    g = torch.empty((na, nb), dtype=dtype, device=a.p.device)
    name, lib, suffix = _gram_lib(dtype)
    launch = getattr(lib, f"zprep_gram{suffix}_cross_launch")
    with torch.cuda.device(g.device):
        err = launch(a.p.data_ptr(), na, b.p.data_ptr(), nb, r_pad, a_row0, b_row0, g.data_ptr(),
                     native.stream_ptr(g.device))
    native.check_launch(name, err)
    native.count_launch(zprep_gram_cross)
    return g


zprep_gram_cross.launches = 0
