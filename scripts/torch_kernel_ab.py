"""Time the cohort step and its five hand kernels of two or more checkouts
of the port on one CUDA card, in the order given, in float32 or (with
``--float64``) in float64.

    python3 scripts/torch_kernel_ab.py [--float64] PARENT_TREE THIS_TREE THIS_TREE PARENT_TREE

Each tree runs in a process of its own with that tree's ``grid_tpu_torch``
on ``sys.path`` first: it builds the kernels from that tree's sources
(into its own ``build/``), reads each kernel function's registers and
shared memory from the ``ptxas -v`` logs (``chip_smoke.ptxas_functions``),
then at N=2504, R=2048, k=500
(``chip_smoke.py``'s slice) times the cohort step (median of 20 by CUDA
events, better of two rounds), its device time (``torch.profiler``, mean of
5 steps), each kernel 20 times back to back (better of two rounds) and
the host's side of a step (cProfile over 20 steps: the wrappers'
cumulative time and the functions with the most own time, per step).
With ``--float64`` each tree also runs ``run_wgs_pipeline`` in file mode
with ``device.dtype: float64`` twice on a synthetic cohort of 2,504 samples
(``chip_smoke.py`` phase 9's: 1,003 flank bins, seed 2504), timed by the
host's clock.
One JSON line a tree, prefixed ``[ab]``; give the trees as parent, change,
change, parent so that neither side gets the warmer card. Needs a card.
"""

import copy
import json
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
N, R, K, N_NBR, N_ITERS, ZMAX, REPS = 2504, 2048, 500, 300, 100, 2.0, 20
KERNELS = ("dipcn_select", "knn_select", "phase_sweeps")


def one(tree: Path, f64: bool) -> dict:
    sys.path[:0] = [str(tree), str(REPO)]
    import numpy as np
    import torch

    import grid_tpu_torch
    from grid_tpu_torch import native
    from grid_tpu_torch.convert import inputs_to_torch
    from grid_tpu_torch.io.hap_neighbors import pad_hap_neighbors
    from grid_tpu_torch.models.cohort import CohortParams, cohort_step
    from grid_tpu_torch.ops.gpu_kernels import masked_column_stats, zprep_gram
    from grid_tpu_torch.ops.gpu_select import dipcn_from_distances_gpu, sorted_smallest_k_gpu
    from grid_tpu_torch.ops.knn import d2_matrix, region_filter_mask
    from grid_tpu_torch.ops.masked import masked_mean
    from grid_tpu_torch.ops.normalize import normalize_cohort, select_high_variance_mask
    from grid_tpu_torch.ops.phasing import phase_sweeps_gpu
    from grid_tpu_torch.pipeline import run_wgs_pipeline
    from grid_tpu_torch.synth import make_matrix, make_synthetic_cohort
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import ptxas_functions

    assert Path(grid_tpu_torch.__file__).resolve().is_relative_to(tree.resolve())
    torch.backends.cuda.matmul.allow_tf32 = False
    dtype = torch.float64 if f64 else torch.float32
    built = ("zprep_gram64" if f64 else "zprep_gram", *KERNELS)
    with ThreadPoolExecutor(len(built)) as pool:
        libs = dict(zip(built, pool.map(native.build, built)))
    regs = {name: ptxas_functions(lib.with_suffix(".log").read_text())
            for name, lib in libs.items()}

    def median_ms(fn):
        for _ in range(3):
            fn()
        times = []
        for _ in range(REPS):
            start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            fn()
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop))
        return statistics.median(times)

    def b2b_ms(fn):
        for _ in range(3):
            fn()
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(REPS):
            fn()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / REPS

    dev = torch.device("cuda")
    values_np, mask_np, reads_np = make_matrix(N, R)
    ring = [[((h + 2) % (2 * N), 1.0), ((h - 2) % (2 * N), 0.5)] for h in range(2 * N)]
    hap = pad_hap_neighbors(ring, 2)
    params = CohortParams(num_neighbors=K, n_nbr=N_NBR, n_iters=N_ITERS, quantize=False)
    inputs = inputs_to_torch(values_np, mask_np, reads_np, np.ones(N, bool), *hap, dev, dtype)
    out = cohort_step(*inputs, params)
    values, mask = inputs[0], inputs[1]
    norm = normalize_cohort(values, mask)
    selected = select_high_variance_mask(norm.var_ratio)
    region = selected & region_filter_mask(torch.where(selected, norm.var_ratio, torch.nan),
                                           n_written=selected.sum())
    sample_ok = norm.mask.any(dim=1)
    d2 = d2_matrix(norm.z, norm.mask, region, ZMAX, row_valid=sample_ok)
    w = inputs[2] / norm.row_means_raw
    rm = masked_mean(values, mask, axis=1)
    good = torch.isfinite(rm) & (rm != 0)
    cs = (values, mask & good[:, None], torch.where(good, 1 / torch.where(good, rm, 1), 0))
    mu = norm.col_means.nan_to_num()
    irrs = torch.where(out.dipcn_valid, out.dipcn, torch.nan)
    lists = inputs[4:7]
    deg = lists[2].sum(dim=1).reshape(-1, 2)
    hap0 = torch.where((deg[:, 0] >= 1) & (deg[:, 1] >= 1) & torch.isfinite(irrs), irrs / 2,
                       torch.nan).repeat_interleave(2)
    timed = {
        "masked_column_stats": lambda: masked_column_stats(*cs, mu),
        "zprep_gram": lambda: zprep_gram(norm.z, norm.mask, region, ZMAX),
        "dipcn_select": lambda: dipcn_from_distances_gpu(d2, w, w, sample_ok, sample_ok, k=K,
                                                         n_nbr=N_NBR),
        "knn_select": lambda: sorted_smallest_k_gpu(d2, K),
        "phase_sweeps": lambda: phase_sweeps_gpu(hap0, irrs, *lists, N_ITERS),
    }
    kernels = {name: min(b2b_ms(fn) for _ in range(2)) for name, fn in timed.items()}
    step = [median_ms(lambda: cohort_step(*inputs, params)) for _ in range(2)]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            cohort_step(*inputs, params)
        torch.cuda.synchronize()
    ops = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    # the host's side of a step: cProfile over 20 steps, per step, the
    # wrappers' cumulative time and the functions with the most own time
    import cProfile
    import pstats

    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(20):
        cohort_step(*inputs, params)
    torch.cuda.synchronize()
    prof.disable()
    stats = pstats.Stats(prof).stats
    wanted = ("cohort_step", "masked_column_stats", "zprep_gram", "dipcn_from_distances_gpu",
              "sorted_smallest_k_gpu", "phase_sweeps_gpu")
    host = {f"{fn}:{line}": round(v[3] / 20 * 1e3, 4) for (path, line, fn), v in stats.items()
            if fn in wanted and "grid_tpu_torch" in path}
    top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:12]
    own = [f"{Path(path).name}:{line} {fn} {v[2] / 20 * 1e3:.4f} ms, {v[1] / 20:.1f} calls"
           for (path, line, fn), v in top]

    def device_us(e):
        us = getattr(e, "self_device_time_total", None)
        return e.self_cuda_time_total if us is None else us

    device_ms = sum(map(device_us, ops)) / 1e3 / 5 if ops else None
    files_s = []
    if f64:  # the pipeline in file mode, float64 on the card
        with tempfile.TemporaryDirectory(prefix="grid_tpu_torch_ab_") as tmp:
            cohort = make_synthetic_cohort(Path(tmp) / "cohort", n_samples=N, flank_bins=1003,
                                           missing_frac=0.02, seed=2504)
            base = cohort["config"]
            base["mosdepth"]["neighbors"]["num_neighbors"] = K
            base["compute_diploid_genotypes"]["n_nbr"] = N_NBR
            base["compute_haploid_genotypes"].update(max_neighbors=10, n_iters=N_ITERS)
            for i in range(2):
                cfg = copy.deepcopy(base)
                out = Path(tmp) / f"files_{i}"
                out.mkdir()
                cfg["output_dir"] = str(out)
                cfg["device"] = {"dtype": "float64"}
                (out / "read_counts.tsv").write_bytes(cohort["counts_file"].read_bytes())
                t0 = time.perf_counter()
                run_wgs_pipeline(config=cfg)
                files_s.append(time.perf_counter() - t0)
    return {"tree": str(tree), "dtype": str(dtype), "step_ms": min(step), "step_rounds_ms": step,
            "step_device_ms": device_ms, "kernels_ms_back_to_back": kernels,
            "file_mode_s": files_s, "host_cumulative_ms_per_step": host, "host_own_ms_per_step_top": own,
            "ptxas": {name: [f"{f['function']}: {f['registers']} registers, {f['usage']}, "
                             f"{f['spill_bytes']} bytes spilled" for f in found]
                      for name, found in regs.items()}}


def main() -> int:
    args = sys.argv[1:]
    if args[:1] == ["--one"]:
        print("[ab] " + json.dumps(one(Path(args[1]), args[2] == "float64")), flush=True)
        return 0
    f64 = args[:1] == ["--float64"]
    for tree in args[f64:]:
        subprocess.run([sys.executable, __file__, "--one", tree,
                        "float64" if f64 else "float32"], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
