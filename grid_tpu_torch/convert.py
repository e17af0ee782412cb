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


def _host(a):
    """An array as numpy takes it: ``grid_tpu``'s bfloat16 arrays (numpy's
    ml_dtypes bfloat16, which torch does not read) through float32, which
    holds every bfloat16 value exactly."""
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def inputs_to_torch(values, mask, reads, reads_valid, hi, hw, hv, device, dtype,
                    reads_dtype=None):
    """numpy inputs of ``cohort_step`` -> tensors on ``device``.

    ``values`` take ``dtype``, ``reads`` ``reads_dtype`` (default
    ``dtype``; the bfloat16 step takes its reads as ``grid_tpu``'s fused
    step does, in the host's float type); masks become bool, the neighbor
    indices stay int32, and the neighbor weights keep their own float
    dtype, as the JAX package keeps them. bfloat16 arrays of ``grid_tpu``
    come in through float32.
    """
    device = torch.device(device)

    def as_tensor(a, dt=None):
        return torch.as_tensor(np.ascontiguousarray(_host(a)), dtype=dt, device=device)

    return (
        as_tensor(values, dtype),
        as_tensor(mask, torch.bool),
        as_tensor(reads, reads_dtype or dtype),
        as_tensor(reads_valid, torch.bool),
        as_tensor(hi, torch.int32),
        as_tensor(hw),
        as_tensor(hv, torch.bool),
    )


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array on the host; bfloat16, which numpy lacks,
    as float32 arrays that hold its values exactly."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def outputs_to_numpy(out: CohortOutputs) -> CohortOutputs:
    """CohortOutputs of tensors -> CohortOutputs of numpy arrays (bfloat16
    fields as float32 arrays of the same values)."""
    return CohortOutputs._make(to_numpy(t) for t in out)


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


def fused_inputs(stage: CohortStage, reads_map: dict, max_nbr: int, device, dtype,
                 wide_dtype=None):
    """The fused steps' inputs to ``cohort_step`` as tensors on ``device``:
    the staged depths and mask and :func:`fused_host_inputs`. Depths take
    ``dtype``; reads and the placeholder weights ``wide_dtype`` (default
    ``dtype``: the steps that do not read ``device.dtype``'s type,
    ``utils.device.step_dtype``)."""
    wide = wide_dtype or dtype
    reads, reads_valid, hi, hw, hv = fused_host_inputs(stage, reads_map, max_nbr)
    values, mask, reads, reads_valid, hi, hw, hv = inputs_to_torch(
        stage.values, stage.mask, reads, reads_valid, hi, hw, hv, device, dtype, wide
    )
    return values, mask, reads, reads_valid, hi, hw.to(wide), hv
