"""Host-side readers, writers and staging (numpy only; twin of ``grid_tpu.io``)."""
