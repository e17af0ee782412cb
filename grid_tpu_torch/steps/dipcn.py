"""Step 6: neighbor-normalized diploid copy number (twin of
``grid_tpu/steps/dipcn.py``; reference ``grid/utils/compute_dipcn.py:10``).

Reads the counts TSV and the neighbors file, builds the [N, K] neighbor
contributions on the host (rows follow the neighbors file), runs
:func:`grid_tpu_torch.ops.dipcn.compute_dipcn` on the device and writes
``Sample\\tNorm_Reads``. The host part is the reference's Python, timed as
the spans ``dipcn.read`` (the two files) and ``dipcn.stage`` (the N·K
lookups); ``dipcn.device`` runs until the values are back on the host.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from grid_tpu_torch.io.formats import neighbors_filename, read_counts_tsv, read_neighbors, write_dipcn
from grid_tpu_torch.ops.dipcn import compute_dipcn
from grid_tpu_torch.utils.device import config_device, step_dtype
from grid_tpu_torch.utils.logging import log
from grid_tpu_torch.utils.timing import step_timer


def _stage_lists(neighbors: dict, sample_scales: dict, reads: dict):
    """The dense inputs of :func:`compute_dipcn`, rows in the neighbors
    file's order: (sample_ids, rnorm [N], sample_valid [N], nbr_contrib
    [N, K], nbr_usable [N, K], the neighbor IDs without a read count)."""
    sample_ids = list(neighbors.keys())
    n = len(sample_ids)
    k = max((len(v) for v in neighbors.values()), default=1)

    rnorm = np.array([
        reads[sid] / sample_scales[sid]
        if sid in reads and sample_scales.get(sid) is not None else np.nan
        for sid in sample_ids
    ])
    sample_valid = np.array([sid in reads and sample_scales.get(sid) is not None
                             for sid in sample_ids])

    nbr_contrib = np.zeros((n, k))
    nbr_usable = np.zeros((n, k), dtype=bool)
    missing_ids: set[str] = set()
    for i, sid in enumerate(sample_ids):
        for j, (nid, nscale, _dist) in enumerate(neighbors[sid]):
            if nid in reads:
                nbr_contrib[i, j] = reads[nid] / nscale
                nbr_usable[i, j] = True
            else:
                missing_ids.add(nid)
    return sample_ids, rnorm, sample_valid, nbr_contrib, nbr_usable, missing_ids


def compute_diploid_genotypes(config, console=None, timer=None):
    """Write the dipCN table of every sample with a read count, a scale and
    at least one usable neighbor; returns its path."""
    dcfg = config.get("compute_diploid_genotypes", {})
    output_file_type = config.get("output_file_type", "tsv")
    output_dir = config.get("output_dir", ".")
    output_file = Path(f"{output_dir}/{dcfg.get('output_file_prefix')}.{output_file_type}")
    read_counts_file = Path(f"{output_dir}/{config['count_reads'].get('output_file_prefix')}."
                            f"{output_file_type}")
    ncfg = config["mosdepth"]["neighbors"]
    neighbors_file = neighbors_filename(output_dir, ncfg.get("output_file_prefix"),
                                        ncfg.get("zmax", 2.0), output_file_type)
    device = config_device(config)

    with step_timer("dipcn.read", timer, None):
        reads = read_counts_tsv(read_counts_file)
        neighbors, sample_scales = read_neighbors(neighbors_file)
    with step_timer("dipcn.stage", timer, None):
        sample_ids, rnorm, sample_valid, nbr_contrib, nbr_usable, missing_ids = _stage_lists(
            neighbors, sample_scales, reads)

    n = len(sample_ids)
    if n == 0:
        write_dipcn(output_file, [], [])
        log(console, f"Saved 0 samples → {output_file}", style="success")
        return output_file

    with step_timer("dipcn.device", timer, None):
        dtype = step_dtype(config, device)
        dip, valid = compute_dipcn(
            torch.as_tensor(rnorm, dtype=dtype, device=device),
            torch.as_tensor(sample_valid, device=device),
            torch.as_tensor(nbr_contrib, dtype=dtype, device=device),
            torch.as_tensor(nbr_usable, device=device),
            n_nbr=dcfg.get("n_nbr", 300),
        )
        dip, valid = dip.cpu().numpy(), valid.cpu().numpy()

    if missing_ids:
        log(
            console,
            f"Warning: {len(missing_ids)} neighbor IDs not found in read counts "
            f"(showing up to 5: {list(missing_ids)[:5]})",
            style="warning",
        )

    out_ids = [sid for i, sid in enumerate(sample_ids) if valid[i]]
    out_vals = [float(dip[i]) for i in range(n) if valid[i]]
    write_dipcn(output_file, out_ids, out_vals)
    log(console, f"Saved {len(out_ids)} samples → {output_file}", style="success")
    return output_file
