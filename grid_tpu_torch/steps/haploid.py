"""Step 7: haplotype copy-number inference (twin of
``grid_tpu/steps/haploid.py``; reference ``grid/utils/hi_inference.py:253``).

Reads the dipCN file, loads IBS (computeIBSpbwt) or IBD (iLASH) haplotype
neighbors, phases, and writes ``ID IRRs hap1phased hap2phased hap1imp
hap2imp``. Two modes:

- device (default): padded tensors and Jacobi sweeps
  (:func:`grid_tpu_torch.ops.phasing.phase_haplotypes`) on
  ``config_device(config)`` in ``step_dtype``;
- exact (``device.exact_phasing: true``): the host Gauss-Seidel in the
  reference's in-place order, bit for bit.

With ``bootstrap_replicates > 0`` the replicates run as one batch on the
device (draws from a ``torch.Generator`` seeded by ``bootstrap_seed``) and
``<prefix>_bootstrap.<type>`` holds each haplotype's mean and standard
deviation. Spans ``haploid.phase`` and ``haploid.bootstrap``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from grid_tpu_torch.io.formats import read_dipcn, write_haploid_output
from grid_tpu_torch.io.hap_neighbors import (
    load_ibd_neighbors,
    load_ibs_neighbors,
    pad_hap_neighbors,
)
from grid_tpu_torch.ops.phasing import (
    compute_imputed,
    compute_imputed_host,
    phase_bootstrap,
    phase_gauss_seidel_host,
    phase_haplotypes,
)
from grid_tpu_torch.utils.device import config_device, step_dtype
from grid_tpu_torch.utils.logging import log
from grid_tpu_torch.utils.timing import step_timer


def _padded(hap_nbrs, max_nbr: int, device, dtype):
    """The ragged haplotype neighbors as (idx, w, valid) tensors."""
    idx, w, valid = pad_hap_neighbors(hap_nbrs, max_nbr, dtype=np.float64)
    return (torch.as_tensor(idx, device=device), torch.as_tensor(w, dtype=dtype, device=device),
            torch.as_tensor(valid, device=device))


def hi_inference(config, console=None, timer=None):
    """Phase the dipCN-file samples and write the haploid table (and the
    bootstrap table when asked); returns the haploid table's path."""
    hi_cfg = config.get("compute_haploid_genotypes", {})
    output_file_prefix = hi_cfg.get("output_file_prefix", "haploid_genotypes")
    output_file_type = config.get("output_file_type", "tsv")
    output_dir = config.get("output_dir", ".")
    output_file = Path(f"{output_dir}/{output_file_prefix}.{output_file_type}")
    dip_cn_file = Path(f"{output_dir}/"
                       f"{config['compute_diploid_genotypes'].get('output_file_prefix')}."
                       f"{output_file_type}")

    method = str(hi_cfg.get("method", "ibs")).lower()
    min_nbr = hi_cfg.get("min_neighbors", 1)
    max_nbr = hi_cfg.get("max_neighbors", 10)
    n_iters = hi_cfg.get("n_iters", 100)
    exact = bool(config.get("device", {}).get("exact_phasing", False))
    device = config_device(config)
    dtype = step_dtype(config, device)

    ids, irrs, id_to_ind = read_dipcn(dip_cn_file)
    n = len(irrs)
    log(console, f"Read diploid IRR data for {n} samples", style="success")

    if method == "ibs":
        ibs_output = hi_cfg.get("ibs_output")
        if not ibs_output:
            raise ValueError("ibs_output required for method='ibs'")
        log(console, f"Loading IBS neighbors from {ibs_output}")
        hap_nbrs = load_ibs_neighbors(ibs_output, id_to_ind, max_nbr)
    elif method == "ibd":
        ibd_output = hi_cfg.get("ibd_output")
        if not ibd_output:
            raise ValueError("ibd_output required for method='ibd'")
        log(console, f"Loading IBD neighbors from {ibd_output}")
        hap_nbrs = load_ibd_neighbors(
            ibd_output,
            id_to_ind,
            max_nbr,
            config.get("start_bp"),
            config.get("end_bp"),
            min_length=hi_cfg.get("min_length", 0.5),
            min_match=hi_cfg.get("min_match", 0.70),
            weighted=hi_cfg.get("weighted", False),
            weight_scale=hi_cfg.get("weight_scale", 1_000_000),
        )
    else:
        raise ValueError(f"unknown method '{method}', must be 'ibs' or 'ibd'")

    with step_timer("haploid.phase", timer, None):
        if exact:
            hap_irrs, mean_irrs, _ = phase_gauss_seidel_host(irrs, hap_nbrs, min_nbr, n_iters)
            imp = np.empty(2 * n)
            for i in range(n):
                imp[2 * i], imp[2 * i + 1] = compute_imputed_host(i, hap_irrs, hap_nbrs, mean_irrs)
            hap_irrs = np.asarray(hap_irrs)
        else:
            nbr = _padded(hap_nbrs, max_nbr, device, dtype)
            res = phase_haplotypes(torch.as_tensor(irrs, dtype=dtype, device=device), *nbr,
                                   min_nbr=min_nbr, n_iters=n_iters)
            imp = compute_imputed(res.hap_irrs, *nbr, res.mean_irrs).cpu().numpy()
            hap_irrs = res.hap_irrs.cpu().numpy()

    write_haploid_output(output_file, ids, irrs, hap_irrs[0::2], hap_irrs[1::2], imp[0::2],
                         imp[1::2])
    log(console, f"Haploid genotypes written to {output_file}", style="success")

    n_boot = int(hi_cfg.get("bootstrap_replicates", 0))
    if n_boot > 0:
        with step_timer("haploid.bootstrap", timer, None):
            nbr = _padded(hap_nbrs, max_nbr, device, dtype)
            generator = torch.Generator(device=device).manual_seed(
                int(hi_cfg.get("bootstrap_seed", 0)))
            mean_b, sd_b, _ = phase_bootstrap(
                generator, torch.as_tensor(irrs, dtype=dtype, device=device), *nbr, min_nbr,
                n_iters, n_boot=n_boot,
            )
            mean_b, sd_b = mean_b.cpu().numpy(), sd_b.cpu().numpy()
        boot_file = Path(f"{output_dir}/{output_file_prefix}_bootstrap.{output_file_type}")
        with open(boot_file, "w") as f:
            f.write("ID\thap1_mean\thap1_sd\thap2_mean\thap2_sd\n")
            for i, sid in enumerate(ids):
                f.write(
                    f"{sid}\t{mean_b[2*i]:.3f}\t{sd_b[2*i]:.3f}\t"
                    f"{mean_b[2*i+1]:.3f}\t{sd_b[2*i+1]:.3f}\n"
                )
        log(console, f"Bootstrap uncertainty ({n_boot} replicates) → {boot_file}",
            style="success")
    return output_file
