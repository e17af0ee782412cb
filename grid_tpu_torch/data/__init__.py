"""Bundled data tables (twin of ``grid_tpu/data``): the VNTR catalog and
the KIV-2 repeat positions, with their loaders in :mod:`.loci`."""
