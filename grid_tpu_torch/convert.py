"""Carry the cohort step's state between the JAX package and the port.

The system has no weights: its state is the staged cohort (depths, masks,
read counts), the haplotype-neighbor tables and the hyperparameters. These
helpers take them as the JAX package holds them (numpy arrays and a
``CohortParams._asdict()``) and give them back as numpy arrays, so both
packages can be fed the same inputs and their outputs compared. The fused
steps make their own tensors with the same functions
(:func:`fused_inputs`), so a test and the pipeline cannot stage differently.
"""

from __future__ import annotations

import numpy as np
import torch

from grid_tpu_torch.io.hap_neighbors import pad_hap_neighbors
from grid_tpu_torch.io.staging import CohortStage
from grid_tpu_torch.models.cohort import CohortOutputs, CohortParams


def params_from_reference(d: dict) -> CohortParams:
    """``grid_tpu``'s ``CohortParams._asdict()`` -> the port's CohortParams.
    An unknown field raises TypeError."""
    return CohortParams(**d)


def inputs_to_torch(values, mask, reads, reads_valid, hi, hw, hv, device, dtype):
    """numpy inputs of ``cohort_step`` -> tensors on ``device``.

    ``values`` and ``reads`` take ``dtype``; masks become bool, the
    neighbor indices stay int32, and the neighbor weights keep their own
    float dtype, as the JAX package keeps them.
    """
    device = torch.device(device)

    def as_tensor(a, dt=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)

    return (
        as_tensor(values, dtype),
        as_tensor(mask, torch.bool),
        as_tensor(reads, dtype),
        as_tensor(reads_valid, torch.bool),
        as_tensor(hi, torch.int32),
        as_tensor(hw),
        as_tensor(hv, torch.bool),
    )


def outputs_to_numpy(out: CohortOutputs) -> CohortOutputs:
    """CohortOutputs of tensors -> CohortOutputs of numpy arrays."""
    return CohortOutputs._make(t.detach().cpu().numpy() for t in out)


def stage_from_reference(stage) -> CohortStage:
    """``grid_tpu``'s ``CohortStage`` (numpy fields) -> the port's, field by
    field, sharing the arrays."""
    return CohortStage(
        sample_ids=list(stage.sample_ids),
        regions=np.asarray(stage.regions),
        values=np.asarray(stage.values),
        mask=np.asarray(stage.mask),
    )


def fused_host_inputs(stage: CohortStage, reads_map: dict, max_nbr: int):
    """The fused steps' host arrays: the read counts in row order (NaN and
    ``reads_valid`` False for a sample the counts file lacks), and empty
    haplotype-neighbor placeholders [2N, max_nbr] (the fused steps phase
    afterwards, over the dipCN-valid samples). Returns (reads,
    reads_valid, hi, hw, hv)."""
    n = len(stage.sample_ids)
    reads = np.array([reads_map.get(sid, np.nan) for sid in stage.sample_ids], dtype=np.float64)
    reads_valid = np.array([sid in reads_map for sid in stage.sample_ids], dtype=bool)
    hi, hw, hv = pad_hap_neighbors([[] for _ in range(2 * n)], max_nbr, dtype=np.float64)
    return reads, reads_valid, hi, hw, hv


def fused_inputs(stage: CohortStage, reads_map: dict, max_nbr: int, device, dtype):
    """The fused steps' inputs to ``cohort_step`` as tensors on ``device``:
    the staged depths and mask and :func:`fused_host_inputs`. Depths,
    reads and the placeholder weights take ``dtype``."""
    reads, reads_valid, hi, hw, hv = fused_host_inputs(stage, reads_map, max_nbr)
    values, mask, reads, reads_valid, hi, hw, hv = inputs_to_torch(
        stage.values, stage.mask, reads, reads_valid, hi, hw, hv, device, dtype
    )
    return values, mask, reads, reads_valid, hi, hw.to(dtype), hv
