"""Rank functions for the sharded layer's tests (``tests/test_torch_parallel.py``,
``tests/test_torch_fused.py``, ``tests/test_torch_staging_sharded.py``,
``tests/test_torch_auto_sharded.py``, ``tests/test_torch_utils.py``) and
for ``chip_smoke.py``.

``run_ranks`` spawns its ranks, which import the function they run by its
module's name: these live here, in a module that imports no JAX, so a
rank starts in about a second. Each writes what it computed into the
shared tensors it is handed; the test holds them to ``grid_tpu``'s.
"""

from __future__ import annotations

import json
import os

import grid_tpu_torch.io.staging as staging
import grid_tpu_torch.parallel.pcohort as pcohort
import grid_tpu_torch.parallel.pknn as pknn
import numpy as np
import torch
from grid_tpu_torch import native
from grid_tpu_torch.io.staging import bed_files_source, stage_cohort_sharded
from grid_tpu_torch.models.cohort import CohortParams, panel_knn_dipcn
from grid_tpu_torch.ops.gpu_kernels import SplitZ, zprep_split
from grid_tpu_torch.ops.normalize import select_high_variance_mask
from grid_tpu_torch.parallel.mesh import shard_cohort_inputs
from grid_tpu_torch.parallel.pcohort import _rank_step
from grid_tpu_torch.parallel.pstats import normalize_cohort_sharded

# where the keeping rank functions below save what they keep (a directory
# the parent names before it spawns the ranks, which inherit it)
KEEP_ENV = "GRID_TPU_TORCH_KEEP_DIR"
NORMALIZE_ROW_FIELDS = ("z", "mask", "row_means_raw")
NORMALIZE_COL_FIELDS = ("col_means", "col_vars", "var_ratio", "scale", "selected")


def rank_step_failing_on_rank_1(group, *args):
    """The sharded step's rank function, but rank 1 raises at once."""
    if group.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    return _rank_step(group, *args)


def normalize_rank(group, cases):
    """Each case: (values, mask, outputs) handles; the rank writes its rows
    of z, mask and the raw row means, and rank 0 the column statistics, the
    scale and the high-variance selection."""
    for values_h, mask_h, outs in cases:
        values, mask = values_h.open(), mask_h.open()
        n = values.shape[0]
        v, m, _, _, row_valid, row0 = shard_cohort_inputs(
            group, values, mask, torch.zeros(n), torch.zeros(n, dtype=torch.bool))
        res = normalize_cohort_sharded(v, m & row_valid[:, None], group, n_rows=n)
        b = v.shape[0]
        for name in NORMALIZE_ROW_FIELDS:
            outs[name].open()[row0:row0 + b] = getattr(res, name)
        if group.rank == 0:
            got = res._asdict() | {"selected": select_high_variance_mask(res.var_ratio)}
            for name in NORMALIZE_COL_FIELDS:
                outs[name].open().copy_(got[name])


def knn_rank(group, cases):
    """Each case: (z, row_valid, w, usable, k, outputs) handles; the rank
    writes its rows of the ring's distances, indices and carried payloads,
    and the widest input of any merge it made (k + the visiting block's
    rows) into ``widest[rank]``."""
    real, merge_rows = pknn.merge_candidates, pknn.MERGE_ROWS
    for z_h, valid_h, w_h, u_h, k, outs in cases:
        widths = []

        def recording(best_d, best_i, best_p, d2, *rest):
            widths.append(best_d.shape[1] + d2.shape[1])
            return real(best_d, best_i, best_p, d2, *rest)

        z, valid, w, usable = (h.open() for h in (z_h, valid_h, w_h, u_h))
        zb, valid_b, w_b, u_b, _, row0 = shard_cohort_inputs(group, z, valid, w, usable)
        # two rows a merge panel, so every block merges in several panels
        pknn.merge_candidates, pknn.MERGE_ROWS = recording, 2
        try:
            found = pknn.ring_knn(zb, k, group, row_valid=valid_b, payloads=(w_b, u_b))
        finally:
            pknn.merge_candidates, pknn.MERGE_ROWS = real, merge_rows
        b = zb.shape[0]
        for name, t in zip(("d", "idx", "w", "usable"), found):
            outs[name].open()[row0:row0 + b] = t
        outs["widest"].open()[group.rank] = max(widths)


def both_rank(group, norm_cases, knn_cases):
    """:func:`normalize_rank`, then :func:`knn_rank`, in one spawn."""
    normalize_rank(group, norm_cases)
    knn_rank(group, knn_cases)


def stage_rank(group, cases, out_dir):
    """Each case: (name, per_rank, min_depth, max_depth, dtype), per_rank
    holding each rank's source: a list of (sample, segments), or
    ``("files", [(sample, path), ...])`` (with a repeat mask as a third
    item where one applies) read through ``bed_files_source``.
    The rank stages its source and saves its block and the stage's fields
    (:func:`_save_stage`) to ``<out_dir>/<name>.rank<r>``."""
    for name, per_rank, min_depth, max_depth, dtype in cases:
        mine = per_rank[group.rank]
        if isinstance(mine, tuple) and mine[0] == "files":
            source = bed_files_source(*mine[1:])
        else:
            source = lambda mine=mine: iter(mine)  # noqa: E731
        st = stage_cohort_sharded(source, group, min_depth, max_depth, dtype=dtype)
        _save_stage(st, os.path.join(out_dir, f"{name}.rank{group.rank}"))


def _save_stage(st, base: str) -> None:
    """A rank's stage: its block and the arrays to ``<base>.npz``, the
    lists to ``<base>.json``."""
    values = st.values.cpu()
    if values.dtype == torch.bfloat16:  # numpy has no bf16: float32 holds each value exactly
        values = values.float()
    np.savez(base + ".npz", values=values.numpy(), mask=st.mask.cpu().numpy(),
             row_valid=st.row_valid.cpu().numpy(), regions=st.regions,
             sample_rows=st.sample_rows)
    with open(base + ".json", "w") as f:
        json.dump({"sample_ids": st.sample_ids, "chroms": st.chroms, "n": st.n,
                   "row0": st.row0}, f)


def auto_knn_rank(group, cases):
    """Each case: (z, z_mask, region, zmax, row_valid, w, usable, k, n_nbr,
    row_block, outputs), the tensors as handles (z_mask and region may be
    None, for z prepared already), whole on every rank, N a multiple of W.
    The rank splits its block of z, gathers the split as the gather form
    does (``pcohort.gather_split``) and takes its rows through
    ``panel_knn_dipcn``; it writes its rows of the lists and dipCN, and
    rank 0 the gathered split's halves (P itself on the CPU) and norms."""
    for z_h, m_h, r_h, zmax, valid_h, w_h, u_h, k, n_nbr, row_block, outs in cases:
        z, valid, w, usable = (h.open().to(group.device) for h in (z_h, valid_h, w_h, u_h))
        mask, region = (None if h is None else h.open().to(group.device) for h in (m_h, r_h))
        b = z.shape[0] // group.world
        rows = slice(group.rank * b, (group.rank + 1) * b)
        block = zprep_split(z[rows].contiguous(), None if mask is None else mask[rows].contiguous(),
                            region, zmax)
        whole = pcohort.gather_split(group, block)
        params = CohortParams(num_neighbors=k, n_nbr=n_nbr, row_block=row_block)
        found = panel_knn_dipcn(whole, valid, w, usable, params, rows=(rows.start, rows.stop))
        for name, t in zip(("d", "idx", "dipcn", "dipcn_valid"), found):
            outs[name].open()[rows] = t.cpu()
        if group.rank == 0:
            outs["p"].open().copy_(whole.p.cpu())
            outs["norms"].open().copy_(whole.norms.cpu())


def gather_split_rank(group, cases):
    """Each case: (p, norms, out_p, out_norms) handles, whole on every rank:
    p [H, N, R] (the card's layouts: P's two TF32 halves, or the float64 P
    itself as [1, N, R]) or [N, R] (the CPU's P), norms [N], N a multiple
    of W. The rank hands ``pcohort.gather_split`` its rows as a split of
    its own; rank 0 writes what it gathered."""
    for p_h, norms_h, out_p, out_norms in cases:
        p, norms = p_h.open(), norms_h.open()
        b = norms.shape[0] // group.world
        rows = slice(group.rank * b, (group.rank + 1) * b)
        whole = pcohort.gather_split(group, SplitZ(p[..., rows, :].contiguous(),
                                                   norms[rows].contiguous()))
        if group.rank == 0:
            out_p.open().copy_(whole.p)
            out_norms.open().copy_(whole.norms)


def bf16_sharded_rank(group, reduce_cases, ring_cases, auto_cases, split_cases, knn_cases):
    """The bfloat16 cases of ``tests/test_torch_bf16_sharded.py`` in one
    spawn: each reduce case ([W, ...] handle, output handle) all-reduces
    this rank's row and rank 0 writes the sum; each ring case runs
    ``pcohort._rank_step`` on its arguments and each auto case
    ``pcohort._rank_auto_step`` (the entries' rank functions, writing their
    rows in place); then :func:`gather_split_rank` and :func:`knn_rank`."""
    for t_h, out_h in reduce_cases:
        got = group.all_reduce_sum(t_h.open()[group.rank])
        if group.rank == 0:
            out_h.open().copy_(got)
    for args in ring_cases:
        pcohort._rank_step(group, *args)
    for args in auto_cases:
        pcohort._rank_auto_step(group, *args)
    gather_split_rank(group, split_cases)
    knn_rank(group, knn_cases)


def cache_rank(group):
    """Report where this rank builds the kernel libraries and Triton's
    cache."""
    return {"build_dir": str(native.build_dir()),
            "triton_cache": os.environ.get("TRITON_CACHE_DIR", "")}


def auto_rank_keeping_split(group, *args):
    """``pcohort._rank_auto_step``, which the parent replaces by this: the
    step as it is, then rank 0 saves the split it gathered to
    ``$GRID_TPU_TORCH_KEEP_DIR/split.pt``."""
    real, kept = pcohort.gather_split, {}

    def keep(group_, split):
        kept["whole"] = real(group_, split)
        return kept["whole"]

    pcohort.gather_split = keep
    try:
        report = pcohort._rank_auto_step(group, *args)
    finally:
        pcohort.gather_split = real
    if group.rank == 0:
        whole = kept["whole"]
        torch.save({"p": whole.p.cpu(), "norms": whole.norms.cpu()},
                   os.path.join(os.environ[KEEP_ENV], "split.pt"))
    return report


def staged_rank_keeping_stage(group, *args):
    """``pcohort._rank_staged_step``, which the parent replaces by this: the
    step as it is, then the rank saves the block it staged, as
    :func:`stage_rank` does, to ``$GRID_TPU_TORCH_KEEP_DIR/stage.rank<r>``."""
    real, kept = staging.stage_cohort_sharded, {}

    def keep(*a, **kw):
        kept["stage"] = real(*a, **kw)
        return kept["stage"]

    staging.stage_cohort_sharded = keep
    try:
        report = pcohort._rank_staged_step(group, *args)
    finally:
        staging.stage_cohort_sharded = real
    _save_stage(kept["stage"], os.path.join(os.environ[KEEP_ENV], f"stage.rank{group.rank}"))
    return report
