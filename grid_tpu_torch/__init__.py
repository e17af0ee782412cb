"""grid_tpu_torch — the PyTorch/CUDA port of grid_tpu for NVIDIA Hopper.

The package mirrors ``grid_tpu``'s module paths and function names so each
function's counterpart is easy to find, but it imports neither ``jax`` nor
``grid_tpu``: the machines it runs on carry PyTorch, Triton and the CUDA
toolkit and no JAX. The numpy helpers it needs are copied in.

Ported so far: the fused WGS pipeline, files in and four artifacts out
(:func:`grid_tpu_torch.pipeline.run_wgs_pipeline`, ``python -m
grid_tpu_torch.cli wgs``, :mod:`grid_tpu_torch.steps.fused`), with the host
modules it needs (config, staging, formats, the cohort generator), around
the fused cohort step on both of its branches
(:func:`grid_tpu_torch.models.cohort.cohort_step`). The config-driven entry
points run on the card unless ``device.platform: cpu``. The three
hand-written Hopper kernels live in :mod:`grid_tpu_torch.ops.gpu_kernels`
(Triton column statistics, CUDA z-prep Gram) and
:mod:`grid_tpu_torch.ops.gpu_select` (CUDA threshold dipCN); the CUDA sources
are under ``csrc/`` and are built with ``nvcc`` at first use
(:mod:`grid_tpu_torch.native`).

Importing the package loads no kernel and needs no GPU.
"""

__version__ = "0.1.0"
