"""Models: the fused cohort step (twin of ``grid_tpu.models``)."""
