"""Step 4's staging choice (twin of the staging half of
``grid_tpu/steps/normalize.py``). The file-mode step itself,
``normalize_mosdepth``, is not ported yet."""

from __future__ import annotations

from grid_tpu_torch.io.formats import read_samples
from grid_tpu_torch.io.staging import stage_cohort, stage_cohort_streaming


def stage_would_stream(config) -> bool:
    """True when _stage will use the bounded-memory streaming stager
    (device.streaming_stage = true, or auto with > 5000 samples)."""
    mode = str(config.get("device", {}).get("streaming_stage", "auto")).lower()
    if mode == "true":
        return config.get("chrom") is not None
    if mode == "auto":
        try:
            n = len(read_samples(config["samples_file"]))
        except (OSError, KeyError):
            return False
        return n > 5000 and config.get("chrom") is not None
    return False


def _stage(config, samples, chrom, start, end, excluded, min_depth, max_depth, threads, console):
    """Pick the staging strategy: config device.streaming_stage = auto|true|false.
    'auto' streams for cohorts above 5000 samples (bounded-memory two-pass).

    Pre-scanned per-sample arrays under the private ``_ingest_staged`` key
    ({sample: (starts, ends, depths)}, already window/mask/depth-filtered)
    are staged as they are and the bed.gz files are not read; the streaming
    stager never takes them."""
    mode = str(config.get("device", {}).get("streaming_stage", "auto")).lower()
    use_stream = (mode == "true" or (mode == "auto" and len(samples) > 5000)) and chrom is not None
    work_dir = config.get("mosdepth", {}).get("work_dir")

    if use_stream:
        return stage_cohort_streaming(
            work_dir, samples, chrom, start, end, excluded, min_depth, max_depth,
            bin_size=config.get("mosdepth", {}).get("bin_size", 1000),
            threads=threads, console=console,
        )
    return stage_cohort(
        work_dir, samples, chrom, start, end, excluded, min_depth, max_depth, threads, console,
        per_sample=config.get("_ingest_staged"),
    )
