"""Fused execution of pipeline steps 4-7 (twin of ``grid_tpu/steps/fused.py``).

With ``device: {fused: true}`` the orchestrator runs ONE staged ingest and
ONE fused device step (:func:`grid_tpu_torch.models.cohort.cohort_step`),
then writes all four artifacts from its outputs: the normalized matrix, the
neighbors file, the dipCN table and the haploid table, in the formats of the
file-by-file steps, with no intermediate file round-trips.

Phasing runs AFTER the fused compute, over exactly the dipCN-valid samples
(the haplotype-neighbor files are indexed against the sample universe the
dipCN artifact contains), so the cohort step itself runs with empty
neighbor placeholders and zero sweeps.

Where it runs: on the card, unless ``device.platform: cpu``
(``utils/device.py:config_device``). The staged numpy arrays become tensors
on that device once, the step and the phasing run there, and one transfer
brings the outputs back for the writers. ``device.dtype: auto`` is float32 on
the card and the staged float64 on the CPU; ``float64`` runs on the card too
(the hand kernels' float64 forms), with ``device.mesh_shape`` as well;
reads, haplotype weights and the dipCN values fed to phasing follow it.
``bfloat16`` runs steps 4-6 in bfloat16, with ``device.mesh_shape`` too, as
``grid_tpu`` casts the staged depths alone; the reads and step 7 take
``utils.device.step_dtype``, float32 on the card and float64 on the CPU
(in the sharded ring the dipCN weights and dipCN as well, as in
``grid_tpu``'s ring: ``parallel/pcohort.py``).

``device.mesh_shape`` asks the dispatch policy
(:func:`grid_tpu_torch.parallel.policy.choose_cohort_execution`) as the JAX
package does: where it chooses the single-device step (a one-device mesh, or
N below the ring crossover under ``dispatch: auto``) this step runs on one
card and logs so; where it chooses the ring, the step runs as
:func:`grid_tpu_torch.parallel.sharded_cohort_step` over prod(mesh_shape)
ranks (``parallel/mesh.py`` says where they run and which transport joins
them; gloo ranks on the CPU under ``device.platform: cpu``), and the rows'
padding is cut off its outputs before step 7 and the writers.
``device.use_pallas`` is accepted and has no effect. ``device.exact_phasing``
or a run of fewer than all four steps takes the file-mode steps instead
(:func:`fused_steps_enabled`), and so does a failure to read this step's
inputs (:class:`FusedInputError`, ``pipeline.py``).
"""

from __future__ import annotations

from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

from grid_tpu_torch.convert import fused_host_inputs, fused_inputs, outputs_to_numpy
from grid_tpu_torch.io.bed import load_repeat_mask
from grid_tpu_torch.io.formats import (
    neighbors_filename,
    read_counts_tsv,
    read_samples,
    write_dipcn,
    write_haploid_output,
    write_neighbors_dense,
    write_normalized_output,
)
from grid_tpu_torch.io.hap_neighbors import (
    load_ibd_neighbors,
    load_ibs_neighbors,
    pad_hap_neighbors,
)
from grid_tpu_torch.models.cohort import CohortParams, cohort_step
from grid_tpu_torch.ops.phasing import compute_imputed, phase_haplotypes
from grid_tpu_torch.parallel.pcohort import ROW_FIELDS, sharded_cohort_step
from grid_tpu_torch.parallel.policy import choose_cohort_execution
from grid_tpu_torch.steps.normalize import _stage
from grid_tpu_torch.utils.device import compute_dtype, config_device, step_dtype
from grid_tpu_torch.utils.logging import log
from grid_tpu_torch.utils.timing import step_timer


class FusedInputError(Exception):
    """A host input of the fused step could not be read (samples, coverage,
    read counts, haplotype neighbors). The pipeline answers it by running the
    file-mode steps; on the card it lets any other failure propagate."""


@contextmanager
def _host_inputs():
    """Raise a failure inside as a :class:`FusedInputError`."""
    try:
        yield
    except Exception as e:
        raise FusedInputError(str(e)) from e


def fused_steps_enabled(config: dict) -> bool:
    """True when the fused path can replace steps 4-7."""
    if not config.get("device", {}).get("fused", False):
        return False
    if config.get("device", {}).get("exact_phasing", False):
        return False  # byte-parity mode needs the sequential step pipeline
    m = config.get("mosdepth", {})
    return all(
        section.get("run") is True
        for section in (
            m.get("normalize", {}),
            m.get("neighbors", {}),
            config.get("compute_diploid_genotypes", {}),
            config.get("compute_haploid_genotypes", {}),
        )
    )


def _finish(device: torch.device) -> None:
    """Wait for the device, so a timed span holds its work and not only
    its launches."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_fused_steps(config, console=None, timer=None):
    """Stage once, run the fused cohort step, write all four artifacts.
    Returns their paths: normalized, neighbors, dipCN, haploid."""
    device = config_device(config)

    chrom = config.get("chrom")
    start = config.get("start_bp")
    end = config.get("end_bp")
    threads = config.get("threads", 1)
    output_dir = config.get("output_dir", ".")
    out_type = config.get("output_file_type", "tsv")

    m = config["mosdepth"]
    ncfg = m["normalize"]
    kcfg = m["neighbors"]
    dcfg = config["compute_diploid_genotypes"]
    hcfg = config["compute_haploid_genotypes"]

    with _host_inputs(), step_timer("fused.stage", timer, None):
        samples = read_samples(config["samples_file"])
        excluded = load_repeat_mask(ncfg.get("repeat_mask_file")) if ncfg.get("repeat_mask_file") else {}
        stage = _stage(
            config, samples, chrom, start, end, excluded,
            ncfg.get("min_depth", 20), ncfg.get("max_depth", 100), threads, console,
        )
        counts_file = Path(output_dir) / f"{config['count_reads'].get('output_file_prefix')}.{out_type}"
        reads_map = read_counts_tsv(counts_file)
        n = len(stage.sample_ids)

        max_nbr = hcfg.get("max_neighbors", 10)
        method = str(hcfg.get("method", "ibs")).lower()
        if method not in ("ibs", "ibd"):
            raise ValueError(f"unknown method '{method}'")

    params = CohortParams(
        top_frac=ncfg.get("top_frac", 0.1),
        zmax=kcfg.get("zmax", 2.0),
        sigma2_max=kcfg.get("sigma2_max", 1000.0),
        frac_r=kcfg.get("frac_r", 1.0),
        num_neighbors=min(kcfg.get("num_neighbors", 500), n - 1),
        n_nbr=dcfg.get("n_nbr", 300),
        min_nbr=hcfg.get("min_neighbors", 1),
        n_iters=0,  # step 7 runs separately over the dipCN-valid universe
        quantize=True,
    )
    dtype = compute_dtype(config, device)
    wide = step_dtype(config, device)  # reads and step 7: bfloat16 computes them as auto

    mesh_shape = config.get("device", {}).get("mesh_shape")
    world = 1
    if mesh_shape:
        # the ring loses 2x to the flat op below the measured crossover
        # (parallel/policy.py): a configured mesh is a capability, not a
        # commitment
        dispatch = str(config.get("device", {}).get("dispatch", "auto"))
        if choose_cohort_execution(n, int(np.prod(mesh_shape)), dispatch) == "ring":
            world = int(np.prod(mesh_shape))
        else:
            log(console,
                f"dispatch policy: N={n} below ring crossover — running the"
                f" single-device step despite mesh_shape={mesh_shape}",
                style="info")

    with step_timer("fused.device", timer, None):
        # phasing neighbors are loaded AFTER dipCN validity is known (below);
        # the step runs with empty placeholders
        if world > 1:
            out = outputs_to_numpy(sharded_cohort_step(
                world, stage.values, stage.mask, *fused_host_inputs(stage, reads_map, max_nbr),
                params, platform=device.type, dtype=dtype, console=console))
            # un-pad the row outputs back to the real cohort size
            out = out._replace(**{name: getattr(out, name)[:n] for name in ROW_FIELDS})
        else:
            inputs = fused_inputs(stage, reads_map, max_nbr, device, dtype, wide)
            out = outputs_to_numpy(cohort_step(*inputs, params))
            del inputs
            _finish(device)

    # ---- step 7 over the dipCN-valid sample universe --------------------
    valid = out.dipcn_valid.astype(bool)
    vidx = np.where(valid)[0]
    valid_ids = [stage.sample_ids[i] for i in vidx]
    irrs_v = np.asarray([float(out.dipcn[i]) for i in vidx])
    id_to_ind = {sid: i for i, sid in enumerate(valid_ids)}
    with _host_inputs():
        if method == "ibs":
            hap_nbrs = load_ibs_neighbors(hcfg["ibs_output"], id_to_ind, max_nbr)
        else:
            hap_nbrs = load_ibd_neighbors(
                hcfg["ibd_output"], id_to_ind, max_nbr, start, end,
                min_length=hcfg.get("min_length", 0.5),
                min_match=hcfg.get("min_match", 0.70),
                weighted=hcfg.get("weighted", False),
                weight_scale=hcfg.get("weight_scale", 1_000_000),
            )
        hvi, hvw, hvv = pad_hap_neighbors(hap_nbrs, max_nbr, dtype=np.float64)

    with step_timer("fused.phase", timer, None):
        irrs_t = torch.as_tensor(irrs_v, dtype=wide, device=device)
        nbr_t = (
            torch.as_tensor(hvi, device=device),
            torch.as_tensor(hvw, dtype=wide, device=device),
            torch.as_tensor(hvv, device=device),
        )
        res7 = phase_haplotypes(
            irrs_t, *nbr_t, hcfg.get("min_neighbors", 1), hcfg.get("n_iters", 100)
        )
        imp7 = compute_imputed(res7.hap_irrs, *nbr_t, res7.mean_irrs).cpu().numpy()
        hap7 = res7.hap_irrs.cpu().numpy()
        _finish(device)

    with step_timer("fused.write", timer, None):
        # step 4 artifact
        selected_idx = np.where(out.region_selected)[0]
        norm_path = Path(output_dir) / f"{ncfg.get('output_file_prefix')}.{out_type}.gz"
        write_normalized_output(
            norm_path, stage.sample_ids, out.scales, out.z, out.z_mask,
            out.col_means, out.col_vars, selected_idx,
        )

        # step 5 artifact
        nbr_path = neighbors_filename(output_dir, kcfg.get("output_file_prefix"), params.zmax, out_type)
        r_use = max(int(out.r_use), 1)
        write_neighbors_dense(
            nbr_path, stage.sample_ids, out.scales, out.nbr_idx,
            out.nbr_sq_dists / (2 * r_use),
        )

        # step 6 artifact
        dip_path = Path(output_dir) / f"{dcfg.get('output_file_prefix')}.{out_type}"
        write_dipcn(dip_path, valid_ids, list(irrs_v))

        # step 7 artifact (rows = dipCN-valid samples, like the file path)
        hap_path = Path(output_dir) / f"{hcfg.get('output_file_prefix')}.{out_type}"
        write_haploid_output(
            hap_path, valid_ids, irrs_v,
            hap7[0::2], hap7[1::2], imp7[0::2], imp7[1::2],
        )

    log(console, f"Fused steps 4-7 complete → {output_dir}", style="success")
    return [norm_path, nbr_path, dip_path, hap_path]
