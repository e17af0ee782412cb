"""Step 4's normalized file from four CPU routes on one synthetic cohort:
the port's fused and file-mode pipelines and grid_tpu's, under x64.

Each route's ``mosdepth_results_normalized.tsv.gz`` is compared line by
line with every other's, and the differing cells are printed. The default
cohort is ``chip_smoke.py`` phase 9's (2504 samples, 1003 flank bins,
seed 2504, 2% missing), where the two routes of each package write one
sample's scale a %.2f quantum apart.

Imports both packages, like the parity tests: run it on the CPU only,

    python scripts/parity_normalize_routes.py --out <scratch dir>

(~2.5 min on 4 threads: the cohort ~80 s, the four runs ~70 s.)
"""

from __future__ import annotations

import argparse
import copy
import gzip
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

NAME = "mosdepth_results_normalized.tsv.gz"


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path, required=True, help="a directory for the cohort and runs")
    parser.add_argument("-n", type=int, default=2504)
    parser.add_argument("--flank", type=int, default=1003)
    parser.add_argument("--seed", type=int, default=2504)
    args = parser.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import grid_tpu.pipeline as jax_pipeline
    import grid_tpu_torch.pipeline as port_pipeline
    from grid_tpu_torch.synth import make_synthetic_cohort

    cohort = make_synthetic_cohort(args.out / "cohort", n_samples=args.n, flank_bins=args.flank,
                                   missing_frac=0.02, seed=args.seed)
    base = cohort["config"]
    base["mosdepth"]["neighbors"]["num_neighbors"] = min(500, args.n - 1)
    base["compute_diploid_genotypes"]["n_nbr"] = min(300, args.n - 1)
    runs = {"port_fused": (port_pipeline, {"fused": True, "platform": "cpu"}),
            "port_files": (port_pipeline, {"platform": "cpu"}),
            "grid_tpu_fused": (jax_pipeline, {"fused": True, "platform": "cpu",
                                              "dtype": "float64"}),
            "grid_tpu_files": (jax_pipeline, {"platform": "cpu", "dtype": "float64"})}
    lines = {}
    for label, (module, device) in runs.items():
        cfg = copy.deepcopy(base)
        out = args.out / label
        out.mkdir(parents=True, exist_ok=True)
        cfg["output_dir"] = str(out)
        cfg["device"] = device
        (out / "read_counts.tsv").write_bytes(cohort["counts_file"].read_bytes())
        module.run_wgs_pipeline(config=cfg)
        lines[label] = gzip.open(out / NAME, "rt").read().splitlines()

    labels = list(lines)
    for i, a in enumerate(labels):
        for b in labels[i + 1:]:
            differ = [k for k, (x, y) in enumerate(zip(lines[a], lines[b])) if x != y]
            print(f"{a} vs {b}: {len(differ)} of {len(lines[a])} lines differ")
            for k in differ:
                xa, xb = lines[a][k].split("\t"), lines[b][k].split("\t")
                cells = [f"column {c}: {u} vs {v}" for c, (u, v) in enumerate(zip(xa, xb))
                         if u != v]
                print(f"  sample {xa[0]} (line {k}): {'; '.join(cells)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
