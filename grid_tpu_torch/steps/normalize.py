"""Step 4: normalize binned coverage across the cohort (twin of
``grid_tpu/steps/normalize.py``; reference
``grid/utils/normalize_mosdepth.py:23``).

One host scan per sample (:func:`_stage`, the choice of stager that the
fused steps share), then the normalize transform on the device
(:func:`grid_tpu_torch.ops.normalize.normalize_cohort`: two launches of the
``masked_column_stats`` kernel on the card), one transfer back, the
reference's region selection on the host and the normalized matrix file.
Spans ``normalize.stage`` and ``normalize.device``.
"""

from __future__ import annotations

from pathlib import Path

import torch

from grid_tpu_torch.convert import to_numpy
from grid_tpu_torch.io.bed import load_repeat_mask
from grid_tpu_torch.io.formats import read_samples, write_normalized_output
from grid_tpu_torch.io.staging import stage_cohort, stage_cohort_streaming
from grid_tpu_torch.ops.normalize import normalize_cohort, select_high_variance_indices
from grid_tpu_torch.utils.device import compute_dtype, config_device
from grid_tpu_torch.utils.logging import log
from grid_tpu_torch.utils.timing import step_timer


def normalize_mosdepth(config, console=None, timer=None):
    """Normalize the cohort's mosdepth coverage and write the normalized
    matrix (``<output_dir>/<prefix>.<type>.gz``); returns its path. On the
    card unless ``device.platform: cpu``, in ``compute_dtype`` (bfloat16
    too: the kernel's bf16 form, each step rounded as ``grid_tpu``'s file
    step 4 rounds it)."""
    device = config_device(config)
    samples = read_samples(config["samples_file"])
    ncfg = config.get("mosdepth", {}).get("normalize", {})
    output_path = (Path(config.get("output_dir", "."))
                   / f"{ncfg.get('output_file_prefix')}.{config.get('output_file_type', 'tsv')}.gz")
    repeat_mask = ncfg.get("repeat_mask_file")
    excluded = load_repeat_mask(repeat_mask) if repeat_mask else {}

    with step_timer("normalize.stage", timer, None):
        stage = _stage(
            config, samples, config.get("chrom"), config.get("start_bp"), config.get("end_bp"),
            excluded, ncfg.get("min_depth", 20), ncfg.get("max_depth", 100),
            config.get("threads", 1), console,
        )

    with step_timer("normalize.device", timer, None):
        values = torch.as_tensor(stage.values, dtype=compute_dtype(config, device), device=device)
        res = normalize_cohort(values, torch.as_tensor(stage.mask, device=device))
        res = type(res)(*map(to_numpy, res))  # waits for the device
        selected = select_high_variance_indices(res.var_ratio, ncfg.get("top_frac", 0.1))

    write_normalized_output(
        output_path, stage.sample_ids, res.row_means_raw, res.z, res.mask, res.col_means,
        res.col_vars, selected,
    )
    log(console, f"Mosdepth normalization complete. Results written to {output_path}",
        style="success")
    return output_path


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
