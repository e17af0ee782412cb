"""Device ops of the cohort step, each the twin of its ``grid_tpu.ops``
module; ``gpu_kernels`` and ``gpu_select`` hold the hand-written Hopper
kernels."""
