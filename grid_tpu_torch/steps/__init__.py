"""Pipeline steps: config-driven wrappers around ops + io (twin of
``grid_tpu.steps``). Ported so far: the fused steps 4-7 (``fused.py``) and
the staging choice they share with step 4 (``normalize.py``)."""
