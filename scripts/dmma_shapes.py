"""The FP64 tensor-core mma shapes on one CUDA card, and the FP64 Gram
kernel beside other versions of it, to pick the shape of
``csrc/zprep_gram64.cu``.

    python3 scripts/dmma_shapes.py [--gram [--baseline OTHER.cu]] [--out FILE.json]

Builds ``scripts/dmma_shapes.cu`` with ``grid_tpu_torch.native.build_file``
(as the port's kernels are built), loads it with ctypes, then:

1. holds each shape's fragment layouts (m8n8k4, m16n8k4, m16n8k8,
   m16n8k16) to a product computed on the host from small integers, so
   exactly;
2. times each shape's register-only loop (8 independent accumulators a
   warp, no memory traffic) at 4, 8 and 16 warps an SM, ~20 ms a launch,
   the best of 3 launches by CUDA events, and prints FP64 TFLOP/s;
3. with ``--gram``: builds ``csrc/zprep_gram64.cu`` and each source that
   ``--baseline`` names (another version of the file, with the same launch
   entry points: a parent commit's, or a copy with another mma shape or
   ring depth), holds each to the float64 product of ``torch.mm`` (1e-12
   of max|G|, exactly symmetric), prints the checkout's registers and
   spills (``zprep_gram64_info``) and times, back to back, the triangle
   with its prep at N=2504, R=2048 (20 calls) and one 512-row panel at
   N=65,536, R=1024 (5 calls), each version twice in turns, beside
   ``torch.mm`` (cuBLAS DGEMM) of the same operands.

Prints one JSON line prefixed ``[dmma]`` and writes it to ``--out``
(``build/dmma_shapes.json`` by default).
Needs a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from grid_tpu_torch import native  # noqa: E402
from grid_tpu_torch.ops.gpu_kernels import zprep_gram_info  # noqa: E402

SHAPES = {0: "m8n8k4", 4: "m16n8k4", 8: "m16n8k8", 16: "m16n8k16"}
WARPS_PER_SM = (4, 8, 16)
FLOP_PER_LAUNCH = 1.34e12  # ~20 ms at the data sheet's 67 TFLOP/s
GRAM_N, GRAM_R, PANEL_N, PANEL_R, PANEL_B = 2504, 2048, 65536, 1024, 512


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def events_ms(fn, reps: int) -> float:
    """Milliseconds a call of ``fn``, ``reps`` calls back to back, after one."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check(err: int, lib, what: str) -> None:
    if err != 0:
        msg = lib.dmma_shapes_error_string(err).decode()
        raise RuntimeError(f"{what}: cudaError {err} ({msg})")


def shapes(dev, sms: int) -> dict:
    lib = ctypes.CDLL(str(native.build_file(REPO / "scripts" / "dmma_shapes.cu")))
    lib.dmma_shapes_error_string.argtypes = [ctypes.c_int]
    lib.dmma_shapes_error_string.restype = ctypes.c_char_p
    lib.dmma_flops_per_warp.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.dmma_flops_per_warp.restype = ctypes.c_double
    lib.dmma_throughput.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    lib.dmma_layout.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4
    lib.dmma_throughput.restype = lib.dmma_layout.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    rng = np.random.default_rng(0)
    out = {}
    for shape, name in SHAPES.items():
        m, k = (8, 4) if shape == 0 else (16, shape)
        a = rng.integers(-4, 5, (m, k)).astype(np.float64)
        b = rng.integers(-4, 5, (8, k)).astype(np.float64)
        ta, tb = torch.tensor(a, device=dev), torch.tensor(b, device=dev)
        td = torch.full((m, 8), np.nan, dtype=torch.float64, device=dev)
        check(lib.dmma_layout(shape, ta.data_ptr(), tb.data_ptr(), td.data_ptr(), stream), lib,
              f"{name} layout")
        exact = bool(np.array_equal(td.cpu().numpy(), a @ b.T))
        rates = {}
        for warps in WARPS_PER_SM:
            blocks, threads = sms * max(1, warps // 8), 32 * min(warps, 8)
            n_warps = blocks * threads // 32
            iters = max(1, int(FLOP_PER_LAUNCH / (n_warps * lib.dmma_flops_per_warp(shape, 1))))
            sink = torch.empty(blocks * threads, dtype=torch.float64, device=dev)

            def launch():
                check(lib.dmma_throughput(shape, blocks, threads, iters, sink.data_ptr(), stream),
                      lib, f"{name} throughput")

            ms = min(events_ms(launch, 1) for _ in range(3))
            rates[warps] = n_warps * lib.dmma_flops_per_warp(shape, iters) / ms / 1e9
        out[name] = {"layout_exact": exact, "tflops": rates}
        print(f"[dmma] {name}: fragments {'exact' if exact else 'WRONG'} against the host "
              f"product; FP64 TFLOP/s at " + ", ".join(
                  f"{w} warps an SM {rates[w]:.2f}" for w in WARPS_PER_SM), flush=True)
    return out


def gram_versions(dev, baselines: list) -> dict:
    jobs = {"checkout": native.CSRC / "zprep_gram64.cu"}
    for path in baselines:  # another version of the file: its directory names it
        jobs[path.parent.name] = path
    with ThreadPoolExecutor(len(jobs)) as pool:
        paths = dict(zip(jobs, pool.map(native.build_file, jobs.values())))
    libs = {}
    for v, path in paths.items():
        lib = ctypes.CDLL(str(path))
        lib.zprep_gram64_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_double, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.zprep_gram64_panel_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p]
        for fn in (lib.zprep_gram64_launch, lib.zprep_gram64_panel_launch):
            fn.restype = ctypes.c_int
        lib.zprep_gram64_error_string.argtypes = [ctypes.c_int]
        lib.zprep_gram64_error_string.restype = ctypes.c_char_p
        libs[v] = lib
    stream = torch.cuda.current_stream(dev).cuda_stream
    gen = torch.Generator(device=dev).manual_seed(19)
    n, r = GRAM_N, GRAM_R
    z = torch.randn((n, r), dtype=torch.float64, device=dev, generator=gen) * 3
    mask = torch.rand((n, r), device=dev, generator=gen) > 0.1
    region = torch.rand(r, device=dev, generator=gen) > 0.2
    p = torch.where(mask, z.clamp(-2.0, 2.0), 0) * region[None, :].double()
    scratch = torch.empty((n, r), dtype=torch.float64, device=dev)
    g = torch.empty((n, n), dtype=torch.float64, device=dev)
    pp = torch.randn((PANEL_N, PANEL_R), dtype=torch.float64, device=dev, generator=gen)
    gp = torch.empty((PANEL_B, PANEL_N), dtype=torch.float64, device=dev)
    want = p @ p.T
    want_panel = pp[:PANEL_B] @ pp.T

    def triangle(lib):
        err = lib.zprep_gram64_launch(z.data_ptr(), mask.data_ptr(), region.data_ptr(), 2.0, n,
                                      r, r, scratch.data_ptr(), g.data_ptr(), stream)
        if err:
            raise RuntimeError(lib.zprep_gram64_error_string(err).decode())

    def panel(lib):
        err = lib.zprep_gram64_panel_launch(pp.data_ptr(), PANEL_N, PANEL_R, 0, PANEL_B,
                                            gp.data_ptr(), stream)
        if err:
            raise RuntimeError(lib.zprep_gram64_error_string(err).decode())

    out = {}
    for v, lib in libs.items():
        triangle(lib)
        panel(lib)
        torch.cuda.synchronize()
        scale = float(want.abs().max())
        err_t = float((g - want).abs().max()) / scale
        err_p = float((gp - want_panel).abs().max()) / float(want_panel.abs().max())
        ok = err_t <= 1e-12 and err_p <= 1e-12 and bool(torch.equal(g, g.T))
        out[v] = {"rel_err_triangle": err_t, "rel_err_panel": err_p, "right": ok,
                  "triangle_ms": [], "panel_ms": []}
        print(f"[dmma] gram {v}: error {err_t:.2e} / {err_p:.2e} of max|G| (triangle / panel), "
              f"symmetric {bool(torch.equal(g, g.T))}: {'right' if ok else 'WRONG'}", flush=True)
    # the checkout's launch as the port reads it (other versions may have
    # another info entry point)
    info = zprep_gram_info(n, dev, torch.float64)
    out["checkout"]["info"] = info
    print(f"[dmma] gram checkout: {info['registers']} registers, {info['spill_bytes']} B "
          f"spilled, {info['smem_bytes']} B of dynamic shared memory, {info['blocks_per_sm']} "
          f"block(s) an SM", flush=True)
    dgemm = {"triangle_ms": [], "panel_ms": []}
    for order in (list(libs), list(libs)[::-1]):
        dgemm["triangle_ms"].append(events_ms(lambda: torch.mm(p, p.T), 20))
        dgemm["panel_ms"].append(events_ms(lambda: torch.mm(pp[:PANEL_B], pp.T), 5))
        for v in order:
            row = out[v]
            row["triangle_ms"].append(events_ms(lambda: triangle(libs[v]), 20))
            row["panel_ms"].append(events_ms(lambda: panel(libs[v]), 5))
    for name, row in out.items():
        print(f"[dmma] gram {name}: triangle N={n} R={r} with its prep "
              f"{min(row['triangle_ms']):.4f} ms b2b, panel [{PANEL_B}, {PANEL_N}] x {PANEL_R} "
              f"{min(row['panel_ms']):.4f} ms "
              f"(better of two rounds; DGEMM {min(dgemm['triangle_ms']):.4f} / "
              f"{min(dgemm['panel_ms']):.4f} ms)", flush=True)
    out["dgemm"] = dgemm
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gram", action="store_true",
                    help="also time the Gram kernel beside the --baseline versions")
    ap.add_argument("--baseline", type=Path, action="append", default=[],
                    help="another zprep_gram64.cu to time beside, named by its directory")
    ap.add_argument("--out", default=str(REPO / "build" / "dmma_shapes.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("dmma_shapes.py needs a CUDA card")
    dev = torch.device("cuda")
    card = card_line()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"[dmma] {card}; {sms} SMs; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    result = {"card": card, "sms": sms, "shapes": shapes(dev, sms)}
    if args.gram:
        result["gram"] = gram_versions(dev, args.baseline)
    line = json.dumps(result)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(line + "\n")
    print(f"[dmma] {line}", flush=True)


if __name__ == "__main__":
    main()
