"""Pipeline steps: config-driven wrappers around ops + io (twin of
``grid_tpu.steps``). Each file-mode step has the reference signature
``step(config, console=None)`` (plus an optional ``timer`` for its spans)
and reads and writes the reference's files: ``normalize.py`` (step 4, and
the staging choice it shares with the fused steps), ``neighbors.py`` (5),
``dipcn.py`` (6), ``haploid.py`` (7). ``fused.py`` runs steps 4-7 as one
device step; ``index.py``, ``count_reads.py``, ``coverage.py`` and
``ingest.py`` are steps 1-3 on the host; ``ibs.py`` makes step 7's IBS
neighbor file from a phased panel; ``multilocus.py`` is the sweep."""
