"""Carry the cohort step's state between the JAX package and the port.

The system has no weights: its state is the staged cohort (depths, masks,
read counts), the haplotype-neighbor tables and the hyperparameters. These
helpers take them as the JAX package holds them (numpy arrays and a
``CohortParams._asdict()``) and give them back as numpy arrays, so both
packages can be fed the same inputs and their outputs compared.
"""

from __future__ import annotations

import numpy as np
import torch

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
