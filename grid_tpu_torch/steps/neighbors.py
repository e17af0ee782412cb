"""Step 5: depth-matched nearest neighbors (twin of
``grid_tpu/steps/neighbors.py``; reference ``grid/utils/find_neighbors.py:11``).

Reads the WRITTEN normalized matrix, clips and zero-fills z on the device,
keeps the regions the variance filter passes, and takes each sample's k
nearest by row panels of the Gram product (``ops/knn.py:knn_squared``: one
``zprep_split`` and one ``zprep_gram_panel`` per 512 rows on the card, then
one ``knn_select`` per panel; stable sorts on the CPU). Writes the
neighbors format with squared distances / (2 * R_use) (quirk Q5) through
``write_neighbors_dense``, whose bytes after decompression are those of
grid_tpu's list writer. Spans
``neighbors.read`` (the reference's Python parser of the normalized file)
and ``neighbors.device``.
"""

from __future__ import annotations

import numpy as np
import torch

from grid_tpu_torch.io.formats import neighbors_filename, read_normalized_data, write_neighbors_dense
from grid_tpu_torch.ops.knn import filter_regions_by_variance, knn_squared, prepare_z
from grid_tpu_torch.utils.device import config_device, step_dtype
from grid_tpu_torch.utils.logging import log
from grid_tpu_torch.utils.timing import step_timer


def load_neighbor_geometry(config, console=None, timer=None):
    """The distance geometry of the neighbors step, straight from the
    written normalized matrix: (sample_ids, zp, scales, r_use, k).

    ``zp`` is the [N, R_use] prepared z (clip, zero fill, variance filter)
    on ``config_device(config)`` in ``step_dtype`` (bfloat16 runs this step
    as ``auto`` does, as ``grid_tpu``'s step reads no dtype); ``scales`` is
    {sample_id: scale} as written."""
    ncfg = config["mosdepth"]["neighbors"]
    zmax = ncfg.get("zmax", 2.0)
    sigma2_max = ncfg.get("sigma2_max", 1000.0)
    input_file = (f"{config.get('output_dir', '.')}/"
                  f"{config['mosdepth']['normalize'].get('output_file_prefix')}."
                  f"{config.get('output_file_type', 'tsv')}.gz")
    device = config_device(config)

    with step_timer("neighbors.read", timer, None):
        sample_ids, sigma2ratios, data_matrix, scales = read_normalized_data(input_file)
    n = len(sample_ids)

    valid_indices, r_use = filter_regions_by_variance(sigma2ratios, ncfg.get("frac_r", 1.0),
                                                      sigma2_max)
    extreme = int(np.sum(sigma2ratios > sigma2_max))
    if extreme:
        log(console, f"Removed {extreme} / {len(sigma2ratios)} regions with sigma2ratio > "
                     f"{sigma2_max}", style="warning")

    dtype = step_dtype(config, device)
    z = torch.as_tensor(np.nan_to_num(data_matrix), dtype=dtype, device=device)
    mask = torch.as_tensor(~np.isnan(data_matrix), device=device)
    zp = prepare_z(z, mask, zmax)[:, torch.as_tensor(valid_indices, device=device)]
    k = min(ncfg.get("num_neighbors", 500), n - 1)
    return sample_ids, zp, scales, r_use, k


def find_neighbors(config, console=None, timer=None):
    """Write each sample's k nearest neighbors; returns the file's path."""
    ncfg = config["mosdepth"]["neighbors"]
    output_file = neighbors_filename(config.get("output_dir", "."),
                                     ncfg.get("output_file_prefix", "neighbor_coverage"),
                                     ncfg.get("zmax", 2.0), config.get("output_file_type", "tsv"))

    sample_ids, zp, scales, r_use, k = load_neighbor_geometry(config, console, timer)

    with step_timer("neighbors.device", timer, None):
        sq_dists, idx = knn_squared(zp.contiguous(), k)
        sq_dists, idx = sq_dists.cpu().numpy(), idx.cpu().numpy()  # waits for the device

    r_use_div = max(r_use, 1)  # guard (ref: find_neighbors.py:258-259)
    write_neighbors_dense(output_file, sample_ids, np.array([scales[s] for s in sample_ids]), idx,
                          sq_dists / (2 * r_use_div))
    log(console, f"Saved neighbors to {output_file}", style="success")
    return output_file
