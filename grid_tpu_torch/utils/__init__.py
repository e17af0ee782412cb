"""Device and dtype helpers (twin of ``grid_tpu.utils``)."""
