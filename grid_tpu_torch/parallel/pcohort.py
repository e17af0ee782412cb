"""The fused cohort step over W ranks (twin of ``grid_tpu/parallel/pcohort.py``).

:func:`sharded_cohort_step` is the explicit-collective form of
:func:`grid_tpu_torch.models.cohort.cohort_step`: column statistics summed
over the ranks, the ring kNN, dipCN on each rank's rows, phasing replicated.
The N x N distance matrix and the gathered z never exist, which is what a
biobank-sized cohort needs. Phasing works on [2N] haplotype vectors, a few
thousand floats, so it runs on every rank after an all-gather of dipCN.

Not ported: the JAX package's ``auto_sharded_cohort_step``, which leaves the
collectives to XLA's partitioner and has no counterpart in PyTorch
(ROADMAP.md queue 1 item 2).
"""

from __future__ import annotations

from contextlib import contextmanager

import torch

from grid_tpu_torch.models.cohort import CohortOutputs, CohortParams, _check_branch, _q2
from grid_tpu_torch.ops.dipcn import compute_dipcn
from grid_tpu_torch.ops.knn import prepare_z, region_filter_mask
from grid_tpu_torch.ops.normalize import select_high_variance_mask
from grid_tpu_torch.ops.phasing import compute_imputed, phase_haplotypes
from grid_tpu_torch.parallel.mesh import (
    CohortGroup,
    RankWorkspace,
    block_rows,
    run_ranks,
    shard_cohort_inputs,
)
from grid_tpu_torch.parallel.pknn import ring_knn
from grid_tpu_torch.parallel.pstats import normalize_cohort_sharded
from grid_tpu_torch.utils.timing import StepTimer, step_timer

# the outputs indexed by row: each rank writes its block of them
ROW_FIELDS = ("z", "z_mask", "scales", "nbr_idx", "nbr_sq_dists", "dipcn", "dipcn_valid")


@contextmanager
def _span(name: str, timer: StepTimer | None, device: torch.device):
    """Time a part of the rank's step into ``timer``, the device's work
    included: the span ends in a device sync."""
    with step_timer(name, timer):
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)


def rank_cohort_step(group: CohortGroup, values, mask, reads, reads_valid, hap_nbr_idx,
                     hap_nbr_w, hap_nbr_valid, params: CohortParams, row_valid, n_rows: int,
                     payload_ring: bool = True, timer: StepTimer | None = None) -> CohortOutputs:
    """One rank's part of the sharded step, on its device.

    Args:
        values, mask, reads, reads_valid, row_valid: this rank's block
            (:func:`grid_tpu_torch.parallel.mesh.shard_cohort_inputs`).
        hap_nbr_*: [2N, K] padded haplotype neighbors, whole on every rank.
        n_rows: the cohort's real row count N.
        payload_ring: False takes the JAX package's gather form: the plain
            ring, then each row's neighbors' dipCN inputs gathered by index
            from all-gathered [N] vectors (a measurement knob there).
        timer: where the spans ``sharded.normalize``, ``sharded.ring``
            (the ring kNN and, in the gather form, the gathers),
            ``sharded.dipcn`` and ``sharded.phase`` are recorded (each ends
            in a device sync), or None.

    Returns CohortOutputs whose row fields are the block's rows and whose
    other fields are the cohort's.
    """
    _check_branch(params, n_rows)
    mask = mask.bool() & row_valid[:, None]
    reads_valid = reads_valid.bool()

    # ---- step 4: sharded normalize ---------------------------------------
    with _span("sharded.normalize", timer, values.device):
        norm = normalize_cohort_sharded(values, mask, group, n_rows=n_rows)
        selected = select_high_variance_mask(norm.var_ratio, params.top_frac)
        scales = norm.row_means_raw
        z = norm.z
        if params.quantize:
            scales = _q2(scales)
            z = torch.where(norm.mask, _q2(z), z)

    # ---- step 5: region filter, then the ring kNN, each row's dipCN input
    # riding the ring with the row ------------------------------------------
    with _span("sharded.ring", timer, values.device):
        ratios_seen = torch.where(selected, norm.var_ratio, torch.nan)
        vfilter = region_filter_mask(ratios_seen, params.frac_r, params.sigma2_max,
                                     n_written=selected.sum())
        region_used = selected & vfilter
        zp = prepare_z(z, norm.mask, params.zmax, region_mask=region_used)
        sample_ok = norm.mask.any(dim=1) & row_valid
        usable_row = reads_valid & sample_ok
        w_row = torch.where(usable_row, reads, 0) / torch.where(scales == 0, 1, scales)
        k = params.num_neighbors
        if payload_ring:
            sq_dists, nbr_idx, nbr_contrib, nbr_usable = ring_knn(
                zp, k, group, row_valid=sample_ok, payloads=(w_row, usable_row))
        else:
            sq_dists, nbr_idx = ring_knn(zp, k, group, row_valid=sample_ok)
            at = nbr_idx.long()
            nbr_contrib = group.all_gather_rows(w_row)[at]
            nbr_usable = group.all_gather_rows(usable_row)[at]
    with _span("sharded.dipcn", timer, values.device):
        dipcn, dipcn_valid = compute_dipcn(reads / scales, usable_row, nbr_contrib, nbr_usable,
                                           n_nbr=params.n_nbr)

    # ---- step 7: replicated phasing --------------------------------------
    with _span("sharded.phase", timer, values.device):
        irrs = torch.where(dipcn_valid, dipcn, torch.nan)
        irrs_all = group.all_gather_rows(irrs)[:hap_nbr_idx.shape[0] // 2]
        phasing = phase_haplotypes(irrs_all, hap_nbr_idx, hap_nbr_w, hap_nbr_valid,
                                   params.min_nbr, params.n_iters)
        imp = compute_imputed(phasing.hap_irrs, hap_nbr_idx, hap_nbr_w, hap_nbr_valid,
                              phasing.mean_irrs)
    return CohortOutputs(
        z=z, z_mask=norm.mask, col_means=norm.col_means, col_vars=norm.col_vars,
        var_ratio=norm.var_ratio, region_selected=selected, region_used=region_used,
        r_use=region_used.sum(), scales=scales, nbr_idx=nbr_idx, nbr_sq_dists=sq_dists,
        dipcn=dipcn, dipcn_valid=dipcn_valid, hap_irrs=phasing.hap_irrs, hap_imp=imp,
        phased=phasing.phased, mean_irrs=phasing.mean_irrs,
    )


def _rank_step(group: CohortGroup, inputs, outputs, params, payload_ring, dtype):
    """A spawned rank: shard the shared inputs, run the step on the block,
    write its rows (and, on rank 0, the cohort-wide fields) in place.
    Returns the step's spans, for the rank's report."""
    values, mask, reads, reads_valid, *hap = (h.open() for h in inputs)
    n = values.shape[0]
    *block, row_valid, row0 = shard_cohort_inputs(group, values, mask, reads, reads_valid,
                                                  dtype)
    hap = [t.to(group.device) for t in hap]
    timer = StepTimer()
    out = rank_cohort_step(group, *block, *hap, params, row_valid, n, payload_ring, timer)
    b = row_valid.shape[0]
    for name, handle in zip(CohortOutputs._fields, outputs):
        if name in ROW_FIELDS:
            handle.open()[row0:row0 + b] = getattr(out, name).cpu()
        elif group.rank == 0:
            handle.open().copy_(getattr(out, name).cpu())
    return timer.report()


def sharded_cohort_step(world: int, values, mask, reads, reads_valid, hap_nbr_idx, hap_nbr_w,
                        hap_nbr_valid, params: CohortParams = CohortParams(),
                        payload_ring: bool = True, platform: str = "cuda", dtype=None,
                        console=None, reports=None) -> CohortOutputs:
    """Run the cohort step over ``world`` ranks; the host-side entry.

    Args:
        world: ranks, W (each a spawned process; see ``parallel/mesh.py``
            for where they run and which transport they use).
        values, mask: [N, R] host arrays or CPU tensors (any N: the last
            blocks are padded).
        reads, reads_valid: [N].
        hap_nbr_*: [2N, K] padded haplotype neighbors (the weights keep
            their own float type, as in the single-device step).
        params: hyperparameters.
        payload_ring: as in :func:`rank_cohort_step`.
        platform: ``"cuda"`` (the card, with the hand kernels) or ``"cpu"``
            (gloo ranks on the host, with the plain versions).
        dtype: float type of the depths and reads on the ranks (default
            float32 on the card, float64 on the CPU).
        console: where the transport is logged.
        reports: a list that receives one dict per rank: its kernel
            launches, peak device memory and seconds (``run_ranks``), and
            the seconds of its spans (:func:`rank_cohort_step`).

    Returns CohortOutputs of CPU tensors; the row fields have W * B rows,
    the padding last, as the JAX package returns them.
    """
    if dtype is None:
        dtype = torch.float64 if platform == "cpu" else torch.float32
    n, r = values.shape
    n_pad = block_rows(n, world) * world
    k = params.num_neighbors
    n_samples = hap_nbr_idx.shape[0] // 2
    shapes = {
        "z": ((n_pad, r), dtype), "z_mask": ((n_pad, r), torch.bool), "col_means": ((r,), dtype),
        "col_vars": ((r,), dtype), "var_ratio": ((r,), dtype),
        "region_selected": ((r,), torch.bool), "region_used": ((r,), torch.bool),
        "r_use": ((), torch.int64), "scales": ((n_pad,), dtype),
        "nbr_idx": ((n_pad, k), torch.int32), "nbr_sq_dists": ((n_pad, k), dtype),
        "dipcn": ((n_pad,), dtype), "dipcn_valid": ((n_pad,), torch.bool),
        "hap_irrs": ((2 * n_samples,), dtype), "hap_imp": ((2 * n_samples,), dtype),
        "phased": ((n_samples,), torch.bool), "mean_irrs": ((), dtype),
    }
    with RankWorkspace() as ws:
        inputs = (ws.put(values, dtype), ws.put(mask, torch.bool), ws.put(reads, dtype),
                  ws.put(reads_valid, torch.bool), ws.put(hap_nbr_idx, torch.int32),
                  ws.put(hap_nbr_w), ws.put(hap_nbr_valid, torch.bool))
        outputs = tuple(ws.empty(*shapes[name]) for name in CohortOutputs._fields)
        got = run_ranks(_rank_step, world, (inputs, outputs, params, payload_ring, dtype),
                        platform, ws, console, shapes=[(n_pad // world, r)])
        result = CohortOutputs._make(h.open() for h in outputs)
    if reports is not None:
        reports.extend(got)
    return result
