"""The fused cohort step over W ranks (twin of ``grid_tpu/parallel/pcohort.py``).

Three host-side entries, each running its part on W spawned ranks
(``parallel/mesh.py``) and returning CohortOutputs of CPU tensors:

- :func:`sharded_cohort_step`, the explicit-collective form of
  :func:`grid_tpu_torch.models.cohort.cohort_step`: column statistics summed
  over the ranks, the ring kNN, dipCN on each rank's rows, phasing
  replicated. The N x N distance matrix and the gathered z never exist,
  which is what a biobank-sized cohort needs.
- :func:`staged_sharded_cohort_step`, the same step on a cohort that each
  rank stages itself from a mosdepth directory
  (:func:`grid_tpu_torch.io.staging.stage_cohort_sharded`): no process ever
  holds the [N, R] depths.
- :func:`auto_sharded_cohort_step`, the gather form, the port's counterpart
  of the JAX package's GSPMD step (``cohort_step`` jitted with cohort
  shardings, XLA inserting the collectives): each rank normalizes its
  block, splits it (``zprep_split``), all-gathers the split's rows, and
  takes its own rows through the flat panel loop against the whole
  (:func:`grid_tpu_torch.models.cohort.panel_knn_dipcn`). A rank holds the
  gathered split, 2 * N * R_pad float32 or N * R_pad float64 (512 MiB
  either way at N=65,536, R=1024), and one [row_block, N] panel at a time,
  never an [N, N] tensor and no ring: the form for cohorts whose gathered
  split fits a card.

All three take ``dtype`` float32, float64 or bfloat16 on the card (the
float64 and bf16 forms of the kernels, ``device.dtype``), float64 by
default on the CPU. In bfloat16 the depths are rounded once, and each form
rounds where ``grid_tpu``'s own form rounds (``parallel/pstats.py``): the
reads stay in the step dtype (``utils.device.step_dtype``: float32 on the
card, float64 on the CPU) and are never rounded. The ring computes the
dipCN weights and dipCN in the reads' dtype, as ``grid_tpu``'s ring does;
the gather form rounds the weights to bfloat16 as the flat step does, and
its dipCN is bfloat16. z, the column statistics, the scales and the
distances are bfloat16 in both, and step 7 runs in the reads' dtype.

Phasing works on [2N] haplotype vectors, a few thousand floats, so it runs
on every rank after an all-gather of dipCN.
"""

from __future__ import annotations

import json
import os
import resource
from contextlib import contextmanager

import numpy as np
import torch

from grid_tpu_torch.io.bed import map_bed_gz_to_samples
from grid_tpu_torch.models.cohort import (
    CohortOutputs,
    CohortParams,
    _check_branch,
    _q2,
    panel_knn_dipcn,
)
from grid_tpu_torch.ops.dipcn import compute_dipcn
from grid_tpu_torch.ops.gpu_kernels import SplitZ, zprep_split
from grid_tpu_torch.ops.knn import prepare_z, region_filter_mask
from grid_tpu_torch.ops.normalize import select_high_variance_mask
from grid_tpu_torch.ops.phasing import compute_imputed, phase_haplotypes
from grid_tpu_torch.parallel.mesh import (
    CohortGroup,
    RankWorkspace,
    SharedTensor,
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


def _normalize_block(group: CohortGroup, values, mask, params: CohortParams, n_rows: int,
                     ring: bool):
    """Step 4 on this rank's block and the region filter of step 5: the
    sharded normalize (reduced as the ring or the gather form reduces), the
    quantize and the cohort's region mask.

    Returns (norm, selected, scales, z, region_used)."""
    norm = normalize_cohort_sharded(values, mask, group, n_rows=n_rows, ring=ring)
    selected = select_high_variance_mask(norm.var_ratio, params.top_frac)
    scales = norm.row_means_raw
    z = norm.z
    if params.quantize:
        scales = _q2(scales)
        z = torch.where(norm.mask, _q2(z), z)
    ratios_seen = torch.where(selected, norm.var_ratio, torch.nan)
    vfilter = region_filter_mask(ratios_seen, params.frac_r, params.sigma2_max,
                                 n_written=selected.sum())
    return norm, selected, scales, z, selected & vfilter


def _phase(group: CohortGroup, dipcn, dipcn_valid, hap_nbr_idx, hap_nbr_w, hap_nbr_valid,
           params: CohortParams, wide=None):
    """Step 7, replicated: dipCN all-gathered, then every rank phases the
    cohort; a bfloat16 step phases in ``wide``, the reads' dtype, as the
    flat step does. Returns (phasing, imputed)."""
    irrs = torch.where(dipcn_valid, dipcn, torch.nan)
    if wide is not None:
        irrs, hap_nbr_w = irrs.to(wide), hap_nbr_w.to(wide)
    irrs_all = group.all_gather_rows(irrs)[:hap_nbr_idx.shape[0] // 2]
    phasing = phase_haplotypes(irrs_all, hap_nbr_idx, hap_nbr_w, hap_nbr_valid,
                               params.min_nbr, params.n_iters)
    imp = compute_imputed(phasing.hap_irrs, hap_nbr_idx, hap_nbr_w, hap_nbr_valid,
                          phasing.mean_irrs)
    return phasing, imp


def _wide(values, reads):
    """Step 7's dtype where the step runs in bfloat16 (the reads'), else
    None: float32 and float64 steps phase as they always have."""
    return reads.dtype if values.dtype == torch.bfloat16 else None


def _outputs(norm, selected, region_used, scales, z, found, phased) -> CohortOutputs:
    sq_dists, nbr_idx, dipcn, dipcn_valid = found
    phasing, imp = phased
    return CohortOutputs(
        z=z, z_mask=norm.mask, col_means=norm.col_means, col_vars=norm.col_vars,
        var_ratio=norm.var_ratio, region_selected=selected, region_used=region_used,
        r_use=region_used.sum(), scales=scales, nbr_idx=nbr_idx, nbr_sq_dists=sq_dists,
        dipcn=dipcn, dipcn_valid=dipcn_valid, hap_irrs=phasing.hap_irrs, hap_imp=imp,
        phased=phasing.phased, mean_irrs=phasing.mean_irrs,
    )


def rank_cohort_step(group: CohortGroup, values, mask, reads, reads_valid, hap_nbr_idx,
                     hap_nbr_w, hap_nbr_valid, params: CohortParams, row_valid, n_rows: int,
                     payload_ring: bool = True, timer: StepTimer | None = None) -> CohortOutputs:
    """One rank's part of the sharded step, on its device.

    Args:
        values, mask, reads, reads_valid, row_valid: this rank's block
            (:func:`grid_tpu_torch.parallel.mesh.shard_cohort_inputs`);
            bfloat16 values take reads in the step dtype.
        hap_nbr_*: [2N, K] padded haplotype neighbors, whole on every rank.
        n_rows: the cohort's valid row count N.
        payload_ring: False takes the JAX package's gather form: the plain
            ring, then each row's neighbors' dipCN inputs gathered by index
            from all-gathered [N] vectors (a measurement knob there).
        timer: where the spans ``sharded.normalize`` (with the region
            filter), ``sharded.ring`` (the ring kNN and, in the gather form,
            the gathers), ``sharded.dipcn`` and ``sharded.phase`` are
            recorded (each ends in a device sync), or None.

    Returns CohortOutputs whose row fields are the block's rows and whose
    other fields are the cohort's.
    """
    _check_branch(params, n_rows)
    mask = mask.bool() & row_valid[:, None]
    reads_valid = reads_valid.bool()

    # ---- step 4: sharded normalize, and the region filter ---------------
    with _span("sharded.normalize", timer, values.device):
        norm, selected, scales, z, region_used = _normalize_block(group, values, mask, params,
                                                                  n_rows, ring=True)

    # ---- step 5: the ring kNN, each row's dipCN input riding the ring with
    # the row --------------------------------------------------------------
    with _span("sharded.ring", timer, values.device):
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
        phased = _phase(group, dipcn, dipcn_valid, hap_nbr_idx, hap_nbr_w, hap_nbr_valid, params,
                        _wide(values, reads))
    return _outputs(norm, selected, region_used, scales, z,
                    (sq_dists, nbr_idx, dipcn, dipcn_valid), phased)


def gather_split(group: CohortGroup, split: SplitZ) -> SplitZ:
    """The split of the whole cohort from each rank's split of its block:
    the rows of P's two TF32 halves (float64 and bfloat16: of P itself,
    [1, B, R_pad]; on the CPU, of the 2-D P) and the squared norms,
    all-gathered in rank order. ``zprep_split`` works row by row, so this is
    bitwise the split of the whole z."""
    if split.p.dim() == 3:  # the card's [2 or 1, B, R_pad], gathered one half at a time
        halves, b, r_pad = split.p.shape
        p = split.p.new_empty((halves, group.world * b, r_pad))
        for out, half in zip(p, split.p):
            out.copy_(group.all_gather_rows(half))
    else:
        p = group.all_gather_rows(split.p)
    return SplitZ(p, group.all_gather_rows(split.norms))


def rank_auto_cohort_step(group: CohortGroup, values, mask, reads, reads_valid, hap_nbr_idx,
                          hap_nbr_w, hap_nbr_valid, params: CohortParams, row_valid, n_rows: int,
                          row0: int, timer: StepTimer | None = None) -> CohortOutputs:
    """One rank's part of the gather form, on its device.

    Args:
        values, mask, reads, reads_valid, row_valid: this rank's block of B
            rows, the cohort's rows row0 .. row0+B-1.
        hap_nbr_*: [2N, K] padded haplotype neighbors, whole on every rank.
        n_rows: the cohort's valid row count.
        timer: where the spans ``sharded.normalize`` (with the region
            filter), ``auto.gather`` (the block's split and the all-gathers
            of the split, the norms, ``sample_ok``, the dipCN weights and
            their usability), ``auto.knn`` (the rank's row panels against
            the gathered split: lists and dipCN) and ``sharded.phase`` are
            recorded (each ends in a device sync), or None.

    Returns CohortOutputs whose row fields are the block's rows and whose
    other fields are the cohort's; equal to ``cohort_step(...,
    row_valid=...)``'s on the panel branch (in bfloat16 but for a column
    statistic that the ranks' float32 partials, added in another order
    than the flat kernel's, may round one bfloat16 ulp apart).
    """
    _check_branch(params, n_rows)
    mask = mask.bool() & row_valid[:, None]
    reads_valid = reads_valid.bool()
    dev = values.device
    with _span("sharded.normalize", timer, dev):
        norm, selected, scales, z, region_used = _normalize_block(group, values, mask, params,
                                                                  n_rows, ring=False)
    with _span("auto.gather", timer, dev):
        whole = gather_split(group, zprep_split(z, norm.mask, region_used, params.zmax))
        # the flat step's geometry and dipCN inputs (models/cohort.py), row
        # by row, then gathered
        sample_ok = norm.mask.any(dim=1) & row_valid
        usable = reads_valid & sample_ok
        ok_all, w_all, usable_all = (group.all_gather_rows(t) for t in (
            sample_ok, (reads / scales).to(values.dtype), usable))
    with _span("auto.knn", timer, dev):
        found = panel_knn_dipcn(whole, ok_all, w_all, usable_all, params,
                                rows=(row0, row0 + values.shape[0]))
        del whole
    with _span("sharded.phase", timer, dev):
        phased = _phase(group, found[2], found[3], hap_nbr_idx, hap_nbr_w, hap_nbr_valid, params,
                        _wide(values, reads))
    return _outputs(norm, selected, region_used, scales, z, found, phased)


def _output_handles(where, n_pad: int, r: int, k: int, n_samples: int, dtype, wide,
                    ring: bool) -> tuple:
    """The shared output tensors of a step, in CohortOutputs' order:
    created in the workspace ``where`` (a RankWorkspace), or named by path
    in the directory ``where`` (a str; see :func:`_rank_staged_step`).
    The values' fields take ``dtype``; dipCN takes the reads' dtype
    ``wide`` in the ring and ``dtype`` in the gather form, and step 7's
    fields ``wide`` (the two differ in bfloat16 only)."""
    dip = wide if ring else dtype
    shapes = {
        "z": ((n_pad, r), dtype), "z_mask": ((n_pad, r), torch.bool), "col_means": ((r,), dtype),
        "col_vars": ((r,), dtype), "var_ratio": ((r,), dtype),
        "region_selected": ((r,), torch.bool), "region_used": ((r,), torch.bool),
        "r_use": ((), torch.int64), "scales": ((n_pad,), dtype),
        "nbr_idx": ((n_pad, k), torch.int32), "nbr_sq_dists": ((n_pad, k), dtype),
        "dipcn": ((n_pad,), dip), "dipcn_valid": ((n_pad,), torch.bool),
        "hap_irrs": ((2 * n_samples,), wide), "hap_imp": ((2 * n_samples,), wide),
        "phased": ((n_samples,), torch.bool), "mean_irrs": ((), wide),
    }
    if isinstance(where, RankWorkspace):
        return tuple(where.empty(*shapes[name]) for name in CohortOutputs._fields)
    return tuple(SharedTensor(os.path.join(where, f"out_{name}"), *shapes[name])
                 for name in CohortOutputs._fields)


def _write_outputs(group: CohortGroup, out: CohortOutputs, outputs, row0: int) -> None:
    """Write this rank's rows of ``out`` (and, on rank 0, the cohort-wide
    fields) into the shared output tensors, in place."""
    b = out.z.shape[0]
    for name, handle in zip(CohortOutputs._fields, outputs):
        if name in ROW_FIELDS:
            handle.open()[row0:row0 + b] = getattr(out, name).cpu()
        elif group.rank == 0:
            handle.open().copy_(getattr(out, name).cpu())


def _rank_step(group: CohortGroup, inputs, outputs, params, payload_ring, dtype, wide):
    """A spawned rank: shard the shared inputs, run the step on the block,
    write its rows (and, on rank 0, the cohort-wide fields) in place.
    Returns the step's spans, for the rank's report."""
    values, mask, reads, reads_valid, *hap = (h.open() for h in inputs)
    n = values.shape[0]
    *block, row_valid, row0 = shard_cohort_inputs(group, values, mask, reads, reads_valid,
                                                  dtype, wide)
    hap = [t.to(group.device) for t in hap]
    timer = StepTimer()
    out = rank_cohort_step(group, *block, *hap, params, row_valid, n, payload_ring, timer)
    _write_outputs(group, out, outputs, row0)
    return timer.report()


def _default_dtype(platform: str, dtype):
    if dtype is None:
        return torch.float64 if platform == "cpu" else torch.float32
    return dtype


def _reads_dtype(platform: str, dtype):
    """The reads' dtype: the step's, but for bfloat16, whose reads (and
    step 7) compute as under auto (``utils.device.step_dtype``)."""
    if dtype == torch.bfloat16:
        return _default_dtype(platform, None)
    return dtype


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
            float32 on the card, float64 on the CPU); bfloat16 rounds the
            depths alone, the reads keep the step dtype (module docstring).
        console: where the transport is logged.
        reports: a list that receives one dict per rank: its kernel
            launches, peak device memory and seconds (``run_ranks``), and
            the seconds of its spans (:func:`rank_cohort_step`).

    Returns CohortOutputs of CPU tensors; the row fields have W * B rows,
    the padding last, as the JAX package returns them.
    """
    dtype = _default_dtype(platform, dtype)
    wide = _reads_dtype(platform, dtype)
    n, r = values.shape
    n_pad = block_rows(n, world) * world
    with RankWorkspace() as ws:
        inputs = (ws.put(values, dtype), ws.put(mask, torch.bool), ws.put(reads, wide),
                  ws.put(reads_valid, torch.bool), ws.put(hap_nbr_idx, torch.int32),
                  ws.put(hap_nbr_w), ws.put(hap_nbr_valid, torch.bool))
        outputs = _output_handles(ws, n_pad, r, params.num_neighbors,
                                  hap_nbr_idx.shape[0] // 2, dtype, wide, ring=True)
        got = run_ranks(_rank_step, world, (inputs, outputs, params, payload_ring, dtype, wide),
                        platform, ws, console, shapes=[(n_pad // world, r)], dtype=dtype)
        result = CohortOutputs._make(h.open() for h in outputs)
    if reports is not None:
        reports.extend(got)
    return result


def _rank_auto_step(group: CohortGroup, inputs, outputs, params, dtype, wide):
    """A spawned rank of the gather form: its block of the shared (already
    padded) inputs, the step, its rows written in place. Returns the
    step's spans."""
    values, mask, reads, reads_valid, row_valid, *hap = (h.open() for h in inputs)
    b = values.shape[0] // group.world
    row0 = group.rank * b

    def block(t, dt=None):
        return t[row0:row0 + b].to(device=group.device, dtype=dt)

    timer = StepTimer()
    out = rank_auto_cohort_step(
        group, block(values, dtype), block(mask, torch.bool), block(reads, wide),
        block(reads_valid, torch.bool), *(t.to(group.device) for t in hap), params,
        block(row_valid, torch.bool), int(row_valid.sum()), row0, timer)
    _write_outputs(group, out, outputs, row0)
    return timer.report()


def auto_sharded_cohort_step(world: int, params: CohortParams = CohortParams(),
                             platform: str = "cuda", dtype=None, console=None, reports=None):
    """The gather form over ``world`` ranks (module docstring): the port's
    ``auto_sharded_cohort_step``.

    Args:
        world, platform, dtype, console: as in :func:`sharded_cohort_step`.
        params: hyperparameters.
        reports: a list that receives one dict per rank and call: its
            launches, peak device memory, seconds and the seconds of its
            spans (:func:`rank_auto_cohort_step`).

    Returns ``step(values, mask, reads, reads_valid, hap_idx, hap_w,
    hap_valid, row_valid)``, the JAX callable's arguments: host arrays of
    N_pad rows, a multiple of ``world`` (``row_valid`` marks the padding),
    with the haplotype arrays sized for N_pad. It returns CohortOutputs of
    CPU tensors with N_pad rows, equal to ``cohort_step(...,
    row_valid=row_valid)``'s.
    """
    dtype = _default_dtype(platform, dtype)
    wide = _reads_dtype(platform, dtype)

    def step(values, mask, reads, reads_valid, hap_idx, hap_w, hap_valid, row_valid):
        n_pad, r = values.shape
        if n_pad % world:
            raise ValueError(f"the gather form takes N_pad rows, a multiple of world={world}; "
                             f"got {n_pad}")
        with RankWorkspace() as ws:
            inputs = (ws.put(values, dtype), ws.put(mask, torch.bool), ws.put(reads, wide),
                      ws.put(reads_valid, torch.bool), ws.put(row_valid, torch.bool),
                      ws.put(hap_idx, torch.int32), ws.put(hap_w), ws.put(hap_valid, torch.bool))
            outputs = _output_handles(ws, n_pad, r, params.num_neighbors, hap_idx.shape[0] // 2,
                                      dtype, wide, ring=False)
            got = run_ranks(_rank_auto_step, world, (inputs, outputs, params, dtype, wide),
                            platform, ws, console, shapes=[(n_pad // world, r)], dtype=dtype)
            result = CohortOutputs._make(h.open() for h in outputs)
        if reports is not None:
            reports.extend(got)
        return result

    return step


def _rank_staged_step(group: CohortGroup, shares, excluded, min_depth, max_depth, inputs,
                      run_dir, params, dtype, wide):
    """A spawned rank of the staged step: stage its share of the samples
    (``shares[rank]``, (sample, bed.gz path) pairs), run the ring step on
    the staged block, write its rows in place. Rank 0 creates the output
    files once the region count is known, and writes the stage's host
    fields. Returns the stage's and the step's spans, R, the host buffer's
    bytes and the rank's peak resident set."""
    from grid_tpu_torch.io.staging import bed_files_source, stage_cohort_sharded

    reads, reads_valid, *hap = (h.open() for h in inputs)
    timer = StepTimer()
    stage = stage_cohort_sharded(bed_files_source(shares[group.rank], excluded), group,
                                 min_depth, max_depth, dtype=dtype, timer=timer)
    b, r = stage.values.shape
    row_valid_all = group.all_gather_rows(stage.row_valid)
    rows = slice(stage.row0, stage.row0 + b)
    out = rank_cohort_step(group, stage.values, stage.mask,
                           reads[rows].to(device=group.device, dtype=wide),
                           reads_valid[rows].to(group.device), *(t.to(group.device) for t in hap),
                           params, stage.row_valid, int(row_valid_all.sum()), timer=timer)
    outputs = _output_handles(run_dir, b * group.world, r, params.num_neighbors,
                              hap[0].shape[0] // 2, dtype, wide, ring=True)
    if group.rank == 0:
        for handle in outputs:
            handle.open()  # the file exists, at its size, before any rank maps it
        np.save(os.path.join(run_dir, "stage_regions.npy"), stage.regions)
        np.save(os.path.join(run_dir, "stage_sample_rows.npy"), stage.sample_rows)
        np.save(os.path.join(run_dir, "stage_row_valid.npy"), row_valid_all.cpu().numpy())
        with open(os.path.join(run_dir, "stage.json"), "w") as f:
            json.dump({"sample_ids": stage.sample_ids, "chroms": stage.chroms, "n": stage.n}, f)
    group.barrier()
    _write_outputs(group, out, outputs, stage.row0)
    host_bytes = b * r * stage.values.element_size() + b * r + b  # values, mask, row_valid
    return timer.report() | {
        "r": r, "rows_per": b, "host_buffer_bytes": host_bytes,
        "peak_rss_bytes": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024,
        "rss_bytes": _rss_bytes()}


def _rss_bytes() -> int:
    """This process's resident set now (Linux ``/proc/self/statm``), or 0
    where /proc does not say."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return 0


def staged_sharded_cohort_step(world: int, mosdepth_dir, samples, reads_map, hap_nbr_idx,
                               hap_nbr_w, hap_nbr_valid, params: CohortParams, min_depth: float,
                               max_depth: float, excluded=None, platform: str = "cuda",
                               dtype=None, console=None, reports=None):
    """Stage a cohort from a mosdepth directory on ``world`` ranks and run
    the ring step on it: the port's composition of ``stage_cohort_sharded``
    and ``sharded_cohort_step(..., row_valid=stage.row_valid)``.

    The parent maps and sorts the sample IDs as ``bed_source`` does and
    hands rank r the r-th contiguous share of ceil(N / W) (a file each);
    the layout is then the JAX package's single-process layout on a
    W-device mesh, the padding last. Each rank stages its share
    (:func:`grid_tpu_torch.io.staging.stage_cohort_sharded`) and runs
    :func:`rank_cohort_step` on its block with the stage's row validity; no
    process holds the [N, R] depths. The fused pipeline keeps staging on the
    host, as the JAX package's does, so no config key reaches this entry.

    Args:
        mosdepth_dir, samples, excluded: as for ``bed_source``.
        reads_map: {sample_id: read count}; a sample without one has no
            usable count.
        hap_nbr_*: [2N, K] padded haplotype neighbors of the N samples in
            sorted order.
        params, platform, dtype, console: as in :func:`sharded_cohort_step`.
        min_depth, max_depth: the regions' population-mean depth bounds.
        reports: a list that receives one dict per rank: its launches,
            peak device memory and seconds, its spans (``stage.pass1``,
            ``stage.pass2`` and the step's), R, ``rows_per``, the host
            buffer's bytes, the peak resident set by ``getrusage`` (on
            Linux it counts the parent's too, from before the spawn's exec)
            and the resident set at the end.

    Returns (stage, outputs): a ShardedCohortStage of the cohort's host
    fields (``values`` and ``mask`` None, ``row_valid`` the [N_pad] row
    validity of every rank, ``row0`` 0), and CohortOutputs of CPU tensors
    with N_pad rows.
    """
    from grid_tpu_torch.io.staging import ShardedCohortStage

    dtype = _default_dtype(platform, dtype)
    wide = _reads_dtype(platform, dtype)
    sample_to_bed = map_bed_gz_to_samples(mosdepth_dir, samples)
    if not sample_to_bed:
        raise FileNotFoundError(f"No mosdepth files found in {mosdepth_dir}")
    ordered = sorted(sample_to_bed)
    b = block_rows(len(ordered), world)
    shares = [[(sid, str(sample_to_bed[sid])) for sid in ordered[i * b:(i + 1) * b]]
              for i in range(world)]
    reads = np.zeros(b * world)
    reads_valid = np.zeros(b * world, bool)
    for i, sid in enumerate(ordered):
        if sid in reads_map:
            reads[i], reads_valid[i] = reads_map[sid], True
    with RankWorkspace() as ws:
        inputs = (ws.put(reads, wide), ws.put(reads_valid, torch.bool),
                  ws.put(hap_nbr_idx, torch.int32), ws.put(hap_nbr_w),
                  ws.put(hap_nbr_valid, torch.bool))
        got = run_ranks(_rank_staged_step, world,
                        (shares, excluded, min_depth, max_depth, inputs, ws.dir, params, dtype,
                         wide),
                        platform, ws, console, dtype=dtype)
        outputs = _output_handles(ws.dir, b * world, got[0]["r"], params.num_neighbors,
                                  hap_nbr_idx.shape[0] // 2, dtype, wide, ring=True)
        result = CohortOutputs._make(h.open() for h in outputs)
        with open(os.path.join(ws.dir, "stage.json")) as f:
            fields = json.load(f)
        stage = ShardedCohortStage(
            sample_ids=fields["sample_ids"], chroms=fields["chroms"],
            regions=np.load(os.path.join(ws.dir, "stage_regions.npy")), values=None, mask=None,
            row_valid=torch.from_numpy(np.load(os.path.join(ws.dir, "stage_row_valid.npy"))),
            n=fields["n"], sample_rows=np.load(os.path.join(ws.dir, "stage_sample_rows.npy")),
            row0=0)
    if reports is not None:
        reports.extend(got)
    return stage, result
