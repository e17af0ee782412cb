"""Fused steps 2+3 (+ the staging scan): one native pass per sample (twin
of ``grid_tpu/steps/ingest.py``).

The reference runs three separate passes over every alignment file:
pysam read counting (grid/utils/count_reads.py:82-107), the mosdepth
binary (grid/utils/mosdepth.py:179-297), and then normalize's full re-scan
of the bed.gz mosdepth just wrote (grid/utils/normalize_mosdepth.py:
218-357). At 2,504 samples those passes are ~85% of pipeline wall-clock
while the accelerator idles.

This step replaces all three with ONE decompression pass per sample
(the host library's C++: grid_bam_ingest / grid_cram_ingest): the window read count,
the window coverage integer, the genome-wide regions.bed.gz artifact
(byte-identical to the separate-step output), and the staged window bins
are all byproducts of the same scan. The staged bins are handed to the
normalize stage in-process, so step 4 never re-reads the bed.gz.

Artifact parity: read_counts TSV, coverage TSV, and every bed.gz are
byte-identical to the sequential steps (tests/test_torch_alignments.py
runs both modes and compares). Failure semantics match the sequential
steps: a failing sample gets an "Error" row in the counts file and is
dropped from coverage/staging with a logged warning.

The slower routes stay as the JAX package has them, and each adds to
``native_host.fallbacks`` when taken: ``"per_sample"`` for a file the
native pass failed on (it runs through the sequential steps' backends
instead), ``"per_sample_loop"`` when the whole-cohort batch call was
refused (the per-sample threaded loop runs instead).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor, as_completed
from concurrent.futures import TimeoutError as FuturesTimeout
from pathlib import Path
from threading import Lock

import numpy as np

from grid_tpu_torch import native_host
from grid_tpu_torch.ingest.alignments import count_reads_in_region, find_files
from grid_tpu_torch.io.bed import (
    load_repeat_mask, norm_chrom, read_regions_bed_gz, region_overlaps_mask,
)
from grid_tpu_torch.io.formats import read_samples, setup_output_file
from grid_tpu_torch.native_host._ingest import _window_cap, ingest_batch
from grid_tpu_torch.steps.coverage import (
    mosdepth_available, remove_intermediate_files, run_coverage_single,
)
from grid_tpu_torch.utils.logging import log, progress_bar


def fused_ingest_enabled(config) -> bool:
    """True when the one-pass native ingest can replace step 3 (and step 2
    when it is gated on — the window count is a free byproduct of the scan;
    with ``count_reads.run: false``, e.g. the multi-locus sweep's shared
    phase, the pass still produces the bed.gz artifacts, the coverage TSV
    and the in-process staged bins).

    Requirements: mosdepth gated on, a BAM/CRAM cohort, the host library
    loaded, and — in ``auto`` mode — the mosdepth binary absent (when
    mosdepth IS on PATH the classic step 3 defers to it for bit-level
    reference parity; ``device.fused_ingest: true`` overrides).
    """
    mode = str(config.get("device", {}).get("fused_ingest", "auto")).lower()
    if mode == "false":
        return False
    if config.get("mosdepth", {}).get("run") is not True:
        return False
    if str(config.get("file_type", "")).lower() not in ("bam", "cram"):
        return False
    if mode == "auto" and mosdepth_available():
        return False
    return native_host.lib() is not None


def _available_ram_bytes():
    """MemAvailable from /proc/meminfo (None where unreadable — non-Linux);
    used to refuse batch-ingest staging allocations that would risk an
    overcommit OOM-kill instead of a catchable MemoryError."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return None


def _ingest_backend(path):
    if str(path).endswith(".cram"):
        from grid_tpu_torch.native_host import cram as backend
    else:
        from grid_tpu_torch.native_host import bam as backend
    return backend


def run_fused_ingest(config, console=None, collect_staged=True):
    """One native pass per sample -> counts TSV + coverage TSV + bed.gz
    artifacts + in-memory staged window bins.

    Returns (counts_path, coverage_path, staged) where staged maps
    sample id -> (starts, ends, depths) arrays with exactly the semantics
    of read_regions_bed_gz(bed, chrom, start, end, excluded) on the file
    this pass wrote (the repeat mask is applied here, per-bin, like the
    file reader does per-line). ``collect_staged=False`` skips the
    accumulation and returns staged=None — the pipeline passes it when the
    normalize step will use the bounded-memory streaming stager, whose
    whole point is not holding per-sample arrays for the full cohort.

    The private ``_extra_count_windows`` config key (list of dicts with
    chrom/start/end/counts_path) adds count-only windows — the multi-locus
    sweep's per-locus step-2 counts, each a byproduct of the same scan
    (native grid_*_ingest_multi), each written as its own counts TSV.
    """
    directory_loc = config["directory_loc"]
    samples = read_samples(config["samples_file"])
    chrom = config.get("chrom")
    start = config.get("start_bp")
    end = config.get("end_bp")
    threads = config.get("threads", 1)
    flags = config.get("count_reads", {}).get("flags", [])
    count_min_mapq = config.get("min_mapq", 1)  # quirk Q3: top level

    out_dir = config.get("output_dir", ".")
    out_type = config.get("output_file_type", "tsv")
    do_counts = config.get("count_reads", {}).get("run") is True
    counts_path = None
    if do_counts:
        counts_path = setup_output_file(
            Path(f"{out_dir}/{config.get('count_reads', {}).get('output_file_prefix')}.{out_type}"),
            chrom, start, end,
        )

    # extra count-only windows (the multi-locus sweep, steps/multilocus.py):
    # every window's step-2 count is a byproduct of the SAME native scan
    # (grid_*_ingest_multi), one counts TSV per window. Private key, same
    # convention as _ingest_staged.
    extras = config.get("_extra_count_windows") or []
    extra_paths = [
        setup_output_file(Path(w["counts_path"]), w["chrom"], w["start"], w["end"])
        for w in extras
    ]
    extra_wins = [(w["chrom"], w["start"], w["end"]) for w in extras]
    mcfg = config.get("mosdepth", {})
    coverage_path = setup_output_file(
        Path(f"{out_dir}/{mcfg.get('output_file_prefix')}.{out_type}"),
        chrom, start, end,
    )
    region_name = mcfg.get("region_name", "region")
    by = int(mcfg.get("bin_size", 1000))
    sparse_bed = bool(mcfg.get("sparse_bed", False))
    work_dir = Path(mcfg.get("work_dir")).expanduser()
    work_dir.mkdir(parents=True, exist_ok=True)

    ncfg = mcfg.get("normalize", {})
    repeat_mask = ncfg.get("repeat_mask_file")
    excluded = load_repeat_mask(repeat_mask) if repeat_mask else {}

    files = {
        sample: path
        for sample, path in find_files(
            directory_loc, samples, config.get("file_type")
        ).items()
        if path is not None
    }

    write_lock = Lock()
    staged: dict | None = {} if collect_staged else None
    failed = []

    def apply_mask(backend, path, starts, ends, depths, refids):
        if not excluded:
            return starts, ends, depths
        names = [norm_chrom(n) for n, _ in backend.references(path)]
        keep = np.array([
            not region_overlaps_mask(names[r], int(s), int(e), excluded)
            for r, s, e in zip(refids, starts, ends)
        ], dtype=bool) if len(refids) else np.ones(0, bool)
        return starts[keep], ends[keep], depths[keep]

    def process(sample, path):
        bed = work_dir / f"{Path(path).stem}_{region_name}.regions.bed.gz"
        try:
            backend = _ingest_backend(path)
            out = backend.ingest(
                path, str(bed), chrom, start, end, flags, count_min_mapq,
                bin_size=by, skip_zero=sparse_bed,
                windows=extra_wins or None,
            )
            count, cov100, starts, ends, depths, refids = out[:6]
            # -1 marks a window whose chromosome the per-format sequential
            # counter would raise on (CRAM exact-name semantics)
            wcounts = (
                [int(c) if c >= 0 else "Error" for c in out[6]]
                if extra_wins else []
            )
            starts, ends, depths = apply_mask(
                backend, path, starts, ends, depths, refids)
            return count, cov100, (starts, ends, depths), wcounts
        except Exception:
            # per-sample fallback (no hard native requirement): run this
            # sample through the SEQUENTIAL per-step paths, which carry
            # their own backend chains (pysam -> cramlite -> ...). Count and
            # coverage fail INDEPENDENTLY, like the sequential steps do — a
            # bad count chromosome yields an Error counts row while
            # coverage/staging proceed, and vice versa.
            native_host.count_fallback("per_sample")
            count = None
            if do_counts:  # the count fallback is a real extra pass — skip
                # it entirely when the counts artifact is disabled
                try:
                    count = count_reads_in_region(
                        path, config.get("reference_genome"), chrom, start,
                        end, flags, count_min_mapq,
                    )
                except Exception as e:
                    log(console, f"count fallback failed for {sample}: {e}",
                        style="danger")
                    count = "Error"
            wcounts = []
            for (wc_chrom, wc_start, wc_end) in extra_wins:
                try:
                    wcounts.append(count_reads_in_region(
                        path, config.get("reference_genome"), wc_chrom,
                        wc_start, wc_end, flags, count_min_mapq,
                    ))
                except Exception:
                    wcounts.append("Error")
            try:
                cov100 = run_coverage_single(
                    path, config.get("reference_genome"), work_dir, chrom,
                    start, end, region_name, by, True, threads=1,
                    sparse_bed=sparse_bed,
                )
                starts, ends, depths = read_regions_bed_gz(
                    bed, chrom, start, end, excluded
                )
                return count, cov100, (starts, ends, depths), wcounts
            except Exception as e:
                log(console, f"coverage fallback failed for {sample}: {e}",
                    style="danger")
                return count, None, None, wcounts

    def emit(sample, count, cov100, arrays, wcounts):
        if cov100 is None:
            failed.append(sample)
        with write_lock:
            if do_counts:
                with open(counts_path, "a") as f:
                    f.write(f"{sample}\t{count}\n")
            for p, wcount in zip(extra_paths, wcounts):
                with open(p, "a") as f:
                    f.write(f"{sample}\t{wcount}\n")
            if cov100 is not None:
                with open(coverage_path, "a", newline="") as f:
                    f.write(f"{sample}\t{cov100}\n")
        if collect_staged and arrays is not None:
            staged[sample] = arrays

    def process_fallback(sample, path):
        try:
            return process(sample, path)
        except Exception as e:  # catch-all: fallback itself died
            log(console, f"✗ {sample} ingest failed: {e}", style="danger")
            return "Error", None, None, ["Error"] * len(extra_wins)

    def run_batched() -> bool:
        """Whole-cohort fan-out in ONE native call (grid_ingest_batch):
        worker threads below the GIL, per-file statuses, a polled progress
        counter. Files the batch flags failed re-run through the same
        per-sample fallback chain the threaded loop uses, so failure
        semantics are identical. Returns False when the batch is not taken
        (GRID_TPU_BATCH_INGEST=0, the RAM guard, the call itself failed) —
        the caller then uses the per-sample threaded loop."""
        import os

        if os.environ.get("GRID_TPU_BATCH_INGEST", "1") == "0":
            return False

        if collect_staged:
            # the batch call stages all four bin buffers upfront at
            # n * cap_per slots (28 B each) — over a whole-chromosome
            # window that is cohort_size x window_bins, where the threaded
            # loop peaks at threads x cap.  A MemoryError would fall back
            # anyway, but Linux overcommit can OOM-kill mid-memcpy
            # instead, so refuse upfront past half of available RAM.
            need = len(files) * _window_cap(start, end, by) * 28
            avail = _available_ram_bytes()
            if avail is not None and need > avail // 2:
                log(console,
                    f"batched ingest would stage {need / 1e9:.1f} GB "
                    f"(> half of the {avail / 1e9:.1f} GB available); "
                    "using the per-sample loop", style="warning")
                native_host.count_fallback("per_sample_loop")
                return False

        items = list(files.items())
        entries = [
            (path,
             str(work_dir / f"{Path(path).stem}_{region_name}.regions.bed.gz"))
            for _, path in items
        ]
        ctr = np.zeros(1, np.int64)
        try:
            with progress_bar(console, total=len(items),
                              description="Ingesting (one pass)") as (progress, task):
                with ThreadPoolExecutor(max_workers=1) as ex:
                    fut = ex.submit(
                        ingest_batch, entries, chrom, start, end, flags,
                        count_min_mapq, bin_size=by, skip_zero=sparse_bed,
                        windows=extra_wins or None, threads=max(1, threads),
                        collect_bins=collect_staged, progress=ctr,
                    )
                    done_n = 0
                    while True:
                        try:
                            status, counts, covs, bins, wc = fut.result(timeout=0.2)
                            break
                        except FuturesTimeout:
                            cur = int(ctr[0])
                            progress.update(task, advance=cur - done_n)
                            done_n = cur
                    progress.update(task, advance=len(items) - done_n)
        except Exception as e:  # batch entry itself died: per-sample loop
            log(console, f"batched ingest unavailable ({e}); "
                "using the per-sample loop", style="warning")
            native_host.count_fallback("per_sample_loop")
            return False

        failed_items = []
        for i, (sample, path) in enumerate(items):
            if int(status[i]) != 0:
                failed_items.append((sample, path))
                continue
            wcounts = (
                [int(c) if c >= 0 else "Error" for c in wc[i]]
                if extra_wins else []
            )
            arrays = None
            if bins[i] is not None:
                s_, e_, d_, r_ = bins[i]
                s_, e_, d_ = apply_mask(
                    _ingest_backend(path), path, s_, e_, d_, r_)
                arrays = (s_, e_, d_)
            emit(sample, int(counts[i]), int(covs[i]), arrays, wcounts)
        if failed_items:
            # re-run failures through the per-sample fallback chain with the
            # same thread fan-out the non-batched loop uses
            with ThreadPoolExecutor(max_workers=max(1, threads)) as ex:
                futures = {
                    ex.submit(process_fallback, sample, path): sample
                    for sample, path in failed_items
                }
                for fut in as_completed(futures):
                    emit(futures[fut], *fut.result())
        return True

    if not run_batched():
        with progress_bar(console, total=len(files), description="Ingesting (one pass)") as (progress, task):
            with ThreadPoolExecutor(max_workers=max(1, threads)) as executor:
                futures = {
                    executor.submit(process_fallback, sample, path): sample
                    for sample, path in files.items()
                }
                for future in as_completed(futures):
                    sample = futures[future]
                    emit(sample, *future.result())
                    progress.update(task, advance=1)

    if mcfg.get("remove_intermediate", False):
        remove_intermediate_files(work_dir, console)

    log(console,
        "One-pass ingest complete: "
        + (f"counts → {counts_path}, " if do_counts else "")
        + f"coverage → {coverage_path}",
        style="success")
    return counts_path, coverage_path, staged
