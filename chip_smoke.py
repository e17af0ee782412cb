#!/usr/bin/env python3
"""Smoke test of grid_tpu_torch, the PyTorch/CUDA port, on one CUDA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises and exits non-zero
before the last line):

1. device  — requires CUDA; prints the card's name and power limit.
2. build   — compiles the CUDA kernels (nvcc, sm_90a, one process per
             source, all started together) into build/grid_tpu_torch/,
             prints ptxas' registers and spills and the launch shapes of
             the Gram and dipCN kernels and the column-statistics grid, and
             JIT-compiles the Triton kernels.
3. kernels — each kernel against its plain PyTorch version on the card, at
             the shapes the cohort step gives it at 1000G scale (N=2504,
             R=2048) and at a ragged shape; dipCN also on forced ties, on
             all-equal distances and on a wide [64, 23170] row block; the
             column statistics must be bitwise equal on two calls; the Gram
             matrix must be exactly symmetric and within 2x the plain
             version's error against a float64 Gram.
4. slice   — cohort_step at N=2504, R=2048, k=500, n_nbr=300, 100 phasing
             sweeps on the card; checks every kernel launched during it and
             that its outputs match the same call on CPU tensors (the plain
             route).
5. times   — CUDA-event medians of 20 runs: the slice, and each kernel
             beside its plain version (the Gram product also in TFLOP/s and
             beside torch.mm as its library call); each kernel also as 20
             back-to-back launches between two events, so the host's launch
             cost stops hiding a short kernel, with its bound (the larger of
             bytes over 3.35 TB/s and operations over the peak) and its
             share of that bound; the column statistics also at the
             genome-wide 100 x 3,000,000.
6. profile — the slice's device time per step under torch.profiler, by
             kernel, and its share of the step time of phase 5.

The last three lines are the kernels' JSON object, the card's name and
power limit, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

N, R, K, N_NBR, N_ITERS = 2504, 2048, 500, 300, 100
RAGGED = (97, 70)
REPS = 20
PROFILE_STEPS = 5
ZMAX = 2.0
WIDE = (64, 23170)  # the widest rows the default 2 GB d2 budget admits
GENOME = (100, 3_000_000)  # the genome-wide normalize shape
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
TF32_FLOP_PER_S = 495e12  # dense TF32 tensor-core peak, the same sheet
# two float32 Gram routes may swap neighbors this close (of the row's k-th
# distance): see the slice phase
TIE_RTOL = 1e-5


def check(ok, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip()


def median_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    """Median over ``reps`` runs of fn's device time, by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def back_to_back_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    """Device time per call of ``reps`` calls issued back to back between
    two CUDA events: the host's launch cost overlaps the device's work."""
    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def bound_ms(n_bytes: float, flop: float = 0.0, flop_per_s: float = TF32_FLOP_PER_S):
    """(least time in ms, "bytes" or "operations"): the larger of the bytes
    over the HBM rate and the operations over the peak."""
    by_bytes, by_ops = n_bytes / HBM_BYTES_PER_S * 1e3, flop / flop_per_s * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def max_abs(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def device_us(evt) -> float:
    """A profiler entry's own device time in µs (``self_cuda_time_total``
    in older PyTorch)."""
    us = getattr(evt, "self_device_time_total", None)
    return evt.self_cuda_time_total if us is None else us


def main() -> int:
    # ---- 1. device -------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing was run", file=sys.stderr)
        return 1
    # the plain versions' matmuls must run in full float32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    repo = Path(__file__).resolve().parent
    sys.path[:0] = [str(repo), str(repo / "tests")]
    card = card_line()
    print(f"[device] {card}  (torch {torch.__version__}, CUDA {torch.version.cuda})", flush=True)

    from bench import make_matrix  # numpy only at import
    from grid_tpu_torch import native
    from grid_tpu_torch.convert import inputs_to_torch, outputs_to_numpy
    from grid_tpu_torch.io.hap_neighbors import pad_hap_neighbors
    from grid_tpu_torch.models.cohort import CohortParams, cohort_step
    from grid_tpu_torch.ops.gpu_kernels import (
        colstats_plan, masked_column_stats, masked_column_stats_plain, zprep_gram, zprep_gram_info,
        zprep_gram_plain,
    )
    from grid_tpu_torch.ops.gpu_select import dipcn_from_distances_gpu, dipcn_select_info
    from grid_tpu_torch.ops.knn import d2_matrix, prepare_z, region_filter_mask
    from grid_tpu_torch.ops.masked import masked_mean
    from grid_tpu_torch.ops.normalize import normalize_cohort, select_high_variance_mask
    from grid_tpu_torch.ops.select import dipcn_from_distances
    from grid_tpu_torch.utils.device import get_device
    from torch_parity import assert_close_to_max, dipcn_sets_differ, neighbor_rows_differing

    dev = get_device("cuda")
    wrappers = {
        "masked_column_stats": masked_column_stats,
        "zprep_gram": zprep_gram,
        "dipcn_from_distances_gpu": dipcn_from_distances_gpu,
    }

    # ---- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(native.KERNELS)) as pool:  # one nvcc per source, together
        list(pool.map(native.build, native.KERNELS))
    print(f"[build] nvcc of {', '.join(native.KERNELS)} in parallel: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name in native.KERNELS:
        native.load(name)
        for line in native.build(name).with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build]   ptxas: {line.strip()}")
    info = zprep_gram_info(N, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"[build] zprep_gram at N={N}: {info['blocks']} blocks (upper-triangle tiles of "
          f"{info['tile']}x{info['tile']}) on {sms} SMs at {info['blocks_per_sm']} block(s) "
          f"per SM; {info['threads']} threads and "
          f"{info['smem_bytes']} B of dynamic shared memory per block, a {info['stages']}-stage "
          f"ring of {info['k_tile']}-column stages", flush=True)
    dinfo = dipcn_select_info(N, K, dev)
    print(f"[build] dipcn_select at W={N}, k={K}: one block of {dinfo['threads']} threads per "
          f"row, {dinfo['smem_bytes']} B dynamic + {dinfo['static_smem_bytes']} B static shared "
          f"memory per block, {dinfo['blocks_per_sm']} blocks per SM "
          f"({min(N, dinfo['blocks_per_sm'] * sms)} of {N} rows in flight); "
          f"{dinfo['registers']} registers and {dinfo['spill_bytes']} B of local memory a thread",
          flush=True)
    check(dinfo["spill_bytes"] == 0, "dipcn_select spills to local memory")
    col_tiles, chunks, rows_per_chunk = colstats_plan(N, R, sms)
    col_programs = col_tiles * chunks
    print(f"[build] masked_column_stats at {N}x{R}: {chunks} row chunks of {rows_per_chunk} "
          f"rows, {col_programs} programs in the main pass ({col_programs / sms:.2f} per SM), "
          f"then one merge in chunk order", flush=True)
    check(col_programs >= 4 * sms, "masked_column_stats: fewer than 4 programs per SM")
    t0 = time.perf_counter()
    tiny = torch.ones((4, 3), device=dev)
    masked_column_stats(tiny, tiny > 0, torch.ones(4, device=dev))
    torch.cuda.synchronize()
    print(f"[build] masked_column_stats: Triton JIT {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 3. kernels against their plain versions -------------------------
    rng = np.random.default_rng(0)
    values_np, mask_np, reads_np = make_matrix(N, R)
    values = torch.tensor(values_np, dtype=torch.float32, device=dev)
    mask = torch.tensor(mask_np, device=dev)
    # the cohort step's own inputs to each kernel (its d2-resident prefix)
    norm = normalize_cohort(values, mask)
    selected = select_high_variance_mask(norm.var_ratio)
    ratios_seen = torch.where(selected, norm.var_ratio, torch.nan)
    region = selected & region_filter_mask(ratios_seen, n_written=selected.sum())
    sample_ok = norm.mask.any(dim=1)
    d2 = d2_matrix(norm.z, norm.mask, region, ZMAX, row_valid=sample_ok)
    w_main = torch.tensor(reads_np, dtype=torch.float32, device=dev) / norm.row_means_raw

    def colstats_case(vals, msk):
        rm = masked_mean(vals, msk, axis=1)
        ok = torch.isfinite(rm) & (rm != 0)
        inv = torch.where(ok, 1 / torch.where(ok, rm, 1), 0)
        return vals, msk & ok[:, None], inv

    ragged_vals = torch.tensor(rng.uniform(10, 60, RAGGED), dtype=torch.float32, device=dev)
    ragged_mask = torch.tensor(rng.random(RAGGED) > 0.15, device=dev)
    errs = {}

    for label, (vals, msk, inv) in [("main", colstats_case(values, mask)),
                                    ("ragged", colstats_case(ragged_vals, ragged_mask))]:
        cnt, s, _ = masked_column_stats(vals, msk, inv)
        pcnt, ps, _ = masked_column_stats_plain(vals, msk, inv)
        mu = ps / pcnt.clamp_min(1)
        _, _, sq = masked_column_stats(vals, msk, inv, mu)
        _, _, psq = masked_column_stats_plain(vals, msk, inv, mu)
        torch.cuda.synchronize()
        check(torch.equal(cnt, pcnt), f"masked_column_stats {label}: counts differ")
        check(torch.allclose(s, ps, rtol=1e-5, atol=0), f"masked_column_stats {label}: sums")
        check(torch.allclose(sq, psq, rtol=1e-5, atol=0), f"masked_column_stats {label}: sqdev")
        once, twice = (masked_column_stats(vals, msk, inv, mu) for _ in range(2))
        check(all(torch.equal(a, b) for a, b in zip(once, twice)),
              f"masked_column_stats {label}: two calls differ")
        err = max(max_abs(s, ps), max_abs(sq, psq))
        errs.setdefault("masked_column_stats", err)
        print(f"[kernels] masked_column_stats {label} {tuple(vals.shape)}: counts exact, "
              f"sum/sqdev within rtol 1e-5, max abs err {err:.3e}; two calls bitwise equal",
              flush=True)

    rz = torch.tensor(rng.normal(size=RAGGED) * 3, dtype=torch.float32, device=dev)
    rmask = torch.tensor(rng.random(RAGGED) > 0.1, device=dev)
    rregion = torch.tensor(rng.random(RAGGED[1]) > 0.2, device=dev)
    for label, args in [("main", (norm.z, norm.mask, region, ZMAX)),
                        ("ragged", (rz, rmask, rregion, ZMAX))]:
        g, pg = zprep_gram(*args), zprep_gram_plain(*args)
        err = assert_close_to_max(g.cpu(), pg.cpu(), 1e-5)
        errs.setdefault("zprep_gram", err)
        check(torch.equal(g, g.T), f"zprep_gram {label}: G is not exactly symmetric")
        # both routes against a float64 Gram of the same P, on the card
        z, msk, reg, zmax = args
        p64 = torch.where(msk, z.double().clamp(-zmax, zmax), 0) * reg[None, :].double()
        g64 = p64 @ p64.T
        err64, plain_err64 = max_abs(g, g64), max_abs(pg, g64)
        check(err64 <= 2 * plain_err64, f"zprep_gram {label}: error vs float64 {err64:.3e} > 2x "
                                        f"the plain version's {plain_err64:.3e}")
        ratio = err64 / plain_err64 if plain_err64 else float("inf")
        print(f"[kernels] zprep_gram {label} {tuple(z.shape)}: within 1e-5 of max|G|, max abs "
              f"err {err:.3e}; exactly symmetric; vs a float64 Gram: kernel {err64:.3e}, plain "
              f"{plain_err64:.3e} ({ratio:.3f}x, gate 2x)", flush=True)

    def dipcn_case(zp, k, n_nbr):
        n = zp.shape[0]
        ones = torch.ones_like(zp, dtype=torch.bool)
        valid = torch.tensor(rng.random(n) > 0.1, device=dev)
        dd = d2_matrix(zp, ones, ones[0], 1e30, row_valid=valid)
        rnorm = torch.tensor(rng.uniform(0.5, 2.0, n), dtype=torch.float32, device=dev)
        usable = torch.tensor(rng.random(n) > 0.2, device=dev)
        return (dd, rnorm, rnorm, usable, usable), k, n_nbr

    ties = torch.tensor(np.round(rng.normal(size=(97, 16)) * 4) / 4, dtype=torch.float32,
                        device=dev)
    # quantized random distances, with the finfo.max of self / invalid columns
    wide_d2 = torch.tensor(rng.integers(0, 400, WIDE) * 0.25, dtype=torch.float32, device=dev)
    wide_d2[:, rng.random(WIDE[1]) < 0.05] = torch.finfo(torch.float32).max
    wide_w = torch.tensor(rng.uniform(0.5, 2.0, WIDE[1]), dtype=torch.float32, device=dev)
    wide_rnorm = torch.tensor(rng.uniform(0.5, 2.0, WIDE[0]), dtype=torch.float32, device=dev)
    wide_usable = torch.tensor(rng.random(WIDE[1]) > 0.2, device=dev)
    cases = [
        ("main", (d2, w_main, w_main, sample_ok, sample_ok), K, N_NBR),
        ("ragged", *dipcn_case(rz, 20, 7)),
        ("forced-tie", *dipcn_case(ties, 20, 7)),
        ("all-equal", *dipcn_case(torch.zeros((N, 16), device=dev), K, N_NBR)),
        ("wide", (wide_d2, wide_rnorm, wide_w, wide_usable, wide_rnorm > 0.6), K, N_NBR),
    ]
    for label, args, k, n_nbr in cases:
        dip, ok = dipcn_from_distances_gpu(*args, k=k, n_nbr=n_nbr)
        pdip, pok = dipcn_from_distances(*args, k=k, n_nbr=n_nbr)
        torch.cuda.synchronize()
        check(torch.equal(ok, pok), f"dipcn {label}: ok differs")
        check(torch.allclose(dip[ok], pdip[ok], rtol=1e-6, atol=0), f"dipcn {label}: values")
        err = max_abs(dip[ok], pdip[ok])
        errs.setdefault("dipcn_from_distances_gpu", err)
        print(f"[kernels] dipcn {label} {tuple(args[0].shape)} k={k} n_nbr={n_nbr}: ok exact "
              f"({int(ok.sum())} rows), dipcn within rtol 1e-6, max abs err {err:.3e}", flush=True)

    # ---- 4. the slice ----------------------------------------------------
    reads_valid_np = np.ones(N, bool)
    ring = [[((h + 2) % (2 * N), 1.0), ((h - 2) % (2 * N), 0.5)] for h in range(2 * N)]
    hi, hw, hv = pad_hap_neighbors(ring, 2)
    # bench.py's setting: unquantized z, so the two routes' z differ by
    # rounding only, never by a %.2f flip
    params = CohortParams(num_neighbors=K, n_nbr=N_NBR, n_iters=N_ITERS, quantize=False)
    inputs = inputs_to_torch(values_np, mask_np, reads_np, reads_valid_np, hi, hw, hv, dev,
                             torch.float32)
    for fn in wrappers.values():
        fn.launches = 0
    out = cohort_step(*inputs, params)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in wrappers.items()}
    print(f"[slice] cohort_step on {torch.cuda.get_device_name(0)}: kernel launches {launches}",
          flush=True)
    for name, count in launches.items():
        check(count > 0, f"{name} was not launched by the main path")

    got = outputs_to_numpy(out)
    t0 = time.perf_counter()
    want = outputs_to_numpy(cohort_step(*inputs_to_torch(
        values_np, mask_np, reads_np, reads_valid_np, hi, hw, hv, "cpu", torch.float32), params))
    print(f"[slice] plain route on CPU tensors: {time.perf_counter() - t0:.1f} s (host clock)")
    check(got.nbr_idx.shape == (N, K) and got.dipcn.shape == (N,), "output shapes")
    check(np.isfinite(got.dipcn[got.dipcn_valid]).all(), "non-finite dipCN on a valid row")
    check(np.isfinite(got.hap_irrs[np.repeat(got.phased, 2)]).all(), "non-finite phased hap")
    z_err = assert_close_to_max(got.z, want.z, 1e-5)
    # the Gram product sums R=2048 float32 products in another order on each
    # route, and d2 = |a|^2 + |b|^2 - 2G cancels most of their magnitude, so
    # near-equal distances may swap: each row's list must agree up to ties
    # within TIE_RTOL of that row's k-th distance
    tol = TIE_RTOL * want.nbr_sq_dists[:, -1].astype(np.float64)
    row_err = np.max(np.abs(got.nbr_sq_dists.astype(np.float64) - want.nbr_sq_dists), axis=1)
    ratio = float(np.max(row_err / tol))
    check(ratio <= 1, f"neighbor distances: worst row at {ratio:.3f} of its tolerance")
    differ = neighbor_rows_differing(got.nbr_idx, got.nbr_sq_dists, want.nbr_idx,
                                     want.nbr_sq_dists, tol=tol)
    usable = reads_valid_np & want.z_mask.any(axis=1)
    sets_differ = dipcn_sets_differ(got.nbr_idx, want.nbr_idx, usable, N_NBR)
    k_set_differ = (np.sort(got.nbr_idx, axis=1) != np.sort(want.nbr_idx, axis=1)).any(axis=1)
    print(f"[slice] neighbor distances: max |diff| {float(row_err.max()):.3e}, worst row at "
          f"{ratio:.3f} of its tolerance ({TIE_RTOL:g} of the row's k-th distance, "
          f"{float(tol.min()):.3e} to {float(tol.max()):.3e}); nbr_idx identical on "
          f"{N - differ.size} rows, the other {differ.size} differ only by ties within tol "
          f"({int(k_set_differ.sum())} of them at the k-th neighbor); "
          f"{int(sets_differ.sum())} rows change a dipCN input set", flush=True)
    check(np.array_equal(got.dipcn_valid, want.dipcn_valid), "dipcn_valid differs")
    same = got.dipcn_valid & ~sets_differ
    dip_ok = np.allclose(got.dipcn[same], want.dipcn[same], rtol=1e-5, atol=0)
    check(dip_ok, "dipCN differs beyond rtol 1e-5")
    print(f"[slice] z within 1e-5 of max|z| (max abs err {z_err:.3e}); dipCN within rtol 1e-5 on "
          f"{int(same.sum())} rows with the same input sets; dipcn_valid exact; "
          f"r_use {int(got.r_use)}; {int(got.phased.sum())} phased", flush=True)

    # ---- 5. times --------------------------------------------------------
    slice_ms = median_ms(lambda: cohort_step(*inputs, params))
    print(f"[times] cohort_step N={N} R={R} k={K} n_iters={N_ITERS}: {slice_ms:.3f} ms "
          f"(median of {REPS}; {card})", flush=True)
    cs = colstats_case(values, mask)
    mu = norm.col_means.nan_to_num()
    gram_args = (norm.z, norm.mask, region, ZMAX)
    dip_args = (d2, w_main, w_main, sample_ok, sample_ok)
    timed = {
        "masked_column_stats": (lambda: masked_column_stats(*cs, mu),
                                lambda: masked_column_stats_plain(*cs, mu)),
        "zprep_gram": (lambda: zprep_gram(*gram_args), lambda: zprep_gram_plain(*gram_args)),
        "dipcn_from_distances_gpu": (
            lambda: dipcn_from_distances_gpu(*dip_args, k=K, n_nbr=N_NBR),
            lambda: dipcn_from_distances(*dip_args, k=K, n_nbr=N_NBR)),
    }
    meta = {
        "masked_column_stats": ("triton", "grid_tpu_torch/ops/gpu_kernels.py",
                                "grid_tpu/ops/pallas_kernels.py:168"),
        "zprep_gram": ("cuda", "grid_tpu_torch/csrc/zprep_gram.cu",
                       "grid_tpu/ops/pallas_kernels.py:93"),
        "dipcn_from_distances_gpu": ("cuda", "grid_tpu_torch/csrc/dipcn_select.cu",
                                     "grid_tpu/ops/pallas_select.py:130"),
    }
    p_main = prepare_z(norm.z, norm.mask, ZMAX, region)
    library = {"zprep_gram": lambda: torch.mm(p_main, p_main.T)}  # a yardstick the port never calls
    four = N * R * 4
    bounds = {
        # values, mask, 1/row mean, column means in; three [R] sums out
        "masked_column_stats": bound_ms(four + N * R + 4 * N + 4 * R + 12 * R),
        # z, mask, region in, G out; 2·N²·R operations at the TF32 peak
        "zprep_gram": bound_ms(four + N * R + R + 4 * N * N, 2 * N * N * R),
        # d2, rnorm, nbr_w, usable, valid in; dipcn, ok out
        "dipcn_from_distances_gpu": bound_ms(4 * N * N + 4 * N + 4 * N + N + N + 4 * N + N),
    }
    kernels = []
    for name, (kernel_fn, plain_fn) in timed.items():
        # plain, kernel, kernel, plain: neither side gets the warmer card
        p1, k1, k2, p2 = (median_ms(f) for f in (plain_fn, kernel_fn, kernel_fn, plain_fn))
        kernel_ms, plain_ms = min(k1, k2), min(p1, p2)
        b2b_ms = min(back_to_back_ms(kernel_fn), back_to_back_ms(kernel_fn))
        lib_ms = None
        if name in library:
            lib_ms = min(median_ms(library[name]), median_ms(library[name]))
        least, bound_by = bounds[name]
        rate = ""
        if name == "zprep_gram":
            flop = 2 * N * N * R
            rate = (f"; {flop / kernel_ms / 1e9:.1f} vs {flop / plain_ms / 1e9:.1f} TFLOP/s "
                    f"as 2*N^2*R; torch.mm of the prepared P {lib_ms:.4f} ms")
        print(f"[times] {name}: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms "
              f"(medians of {REPS}, better of two rounds{rate}); {REPS} back to back "
              f"{b2b_ms:.4f} ms per call; bound {least:.4f} ms by {bound_by}, "
              f"{100 * least / b2b_ms:.1f}% of it back to back; {card}", flush=True)
        route, source, replaces = meta[name]
        kernels.append({"name": name, "route": route, "source": source, "replaces": replaces,
                        "launches": launches[name], "max_abs_err": errs[name],
                        "ms": kernel_ms, "ms_back_to_back": b2b_ms, "plain_ms": plain_ms,
                        "bound_ms": least, "bound_by": bound_by,
                        "bound_share": least / b2b_ms, "library_ms": lib_ms})

    # the genome-wide normalize's column statistics, made on the card
    gen = torch.Generator(device=dev).manual_seed(0)
    g_vals = torch.rand(GENOME, device=dev, generator=gen) * 50 + 10
    g_mask = torch.rand(GENOME, device=dev, generator=gen) > 0.15
    g_inv = 1 / g_vals.mean(dim=1)
    g_mu = torch.rand(GENOME[1], device=dev, generator=gen) + 0.5
    g_cnt, g_sum, g_sq = masked_column_stats(g_vals, g_mask, g_inv, g_mu)
    g_want = masked_column_stats_plain(g_vals, g_mask, g_inv, g_mu)
    check(torch.equal(g_cnt, g_want[0]), "masked_column_stats genome-wide: counts differ")
    check(torch.allclose(g_sum, g_want[1], rtol=1e-5, atol=0)
          and torch.allclose(g_sq, g_want[2], rtol=1e-5, atol=0),
          "masked_column_stats genome-wide: sums")
    del g_want
    g_kernel = lambda: masked_column_stats(g_vals, g_mask, g_inv, g_mu)  # noqa: E731
    g_plain = lambda: masked_column_stats_plain(g_vals, g_mask, g_inv, g_mu)  # noqa: E731
    gp1, gk1, gk2, gp2 = (back_to_back_ms(f, reps=5)
                          for f in (g_plain, g_kernel, g_kernel, g_plain))
    g_n, g_r = GENOME
    g_least, g_by = bound_ms(g_n * g_r * 5 + 4 * g_n + 4 * g_r + 12 * g_r)
    _, g_chunks, _ = colstats_plan(g_n, g_r, sms)
    print(f"[times] masked_column_stats genome-wide {g_n}x{g_r} ({g_chunks} row chunk(s)): "
          f"kernel {min(gk1, gk2):.4f} ms, plain {min(gp1, gp2):.4f} ms (5 back to back, better "
          f"of two rounds); bound {g_least:.4f} ms by {g_by}, "
          f"{100 * g_least / min(gk1, gk2):.1f}% of it; counts exact, sums within rtol 1e-5; "
          f"{card}", flush=True)
    del g_vals, g_mask
    torch.cuda.empty_cache()

    # ---- 6. profile ------------------------------------------------------
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_STEPS):
            cohort_step(*inputs, params)
        torch.cuda.synchronize()
    ops = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if ops:
        # one stream, so device ops do not overlap and their times add up;
        # the share is taken against the step timed without the profiler
        dev_ms = sum(device_us(e) for e in ops) / 1e3 / PROFILE_STEPS
        n_ops = sum(e.count for e in ops) / PROFILE_STEPS
        print(f"[profile] cohort_step: device time {dev_ms:.3f} ms per step in {n_ops:.0f} device "
              f"ops (torch.profiler, {PROFILE_STEPS} steps), {100 * dev_ms / slice_ms:.1f}% of the "
              f"{slice_ms:.3f} ms step of phase 5; {card}", flush=True)
        for e in sorted(ops, key=device_us, reverse=True)[:12]:
            print(f"[profile]   {device_us(e) / 1e3 / PROFILE_STEPS:8.4f} ms/step "
                  f"{e.count / PROFILE_STEPS:6.1f} calls/step  {e.key[:80]}")
        # the hand kernels' own device time (the Gram product is two kernels,
        # the split pass and the Gram kernel; the column statistics are the
        # row-chunk kernel and its merge)
        own = ("split_kernel", "gram_kernel", "dipcn_select_kernel", "colstats")
        for e in ops:
            if any(name in e.key for name in own):
                print(f"[profile]   hand kernel {device_us(e) / 1e3 / PROFILE_STEPS:.4f} ms/step "
                      f"{e.count / PROFILE_STEPS:.1f} calls/step  {e.key[:80]}")
    else:
        print("[profile] torch.profiler saw no device activity: device time not measured")

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
