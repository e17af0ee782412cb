"""Step 3: genome-binned coverage per sample, mosdepth-compatible (twin of
``grid_tpu/steps/coverage.py``).

File-compatible with the reference step (grid/utils/mosdepth.py:16): per
sample, produce ``{sample}_{region}.regions.bed.gz`` genome-wide binned
depth in ``work_dir`` plus an overlap-weighted window coverage written as
``int(round(100 * cov))`` to the coverage TSV (quirk Q4: the 100x integer
here vs the 1x ``scale`` in later files).

Backend chain:
1. **mosdepth** binary when on PATH (reference parity, Nim binary);
2. **native** — the host library's C++ BAM and CRAM depth binners
   (fast-mode semantics: read-span coverage, no CIGAR walk); a CRAM the
   native binner fails on takes cramlite's binner and adds one to
   ``native_host.fallbacks["alignment_reader"]``.
"""

from __future__ import annotations

import gzip
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor, as_completed
from pathlib import Path
from threading import Lock

from grid_tpu_torch import native_host
from grid_tpu_torch.ingest.alignments import find_files
from grid_tpu_torch.io.formats import read_samples, setup_output_file
from grid_tpu_torch.utils.logging import log, progress_bar


def mosdepth_available() -> bool:
    return shutil.which("mosdepth") is not None


def _native_binner():
    """The native BAM wrappers, or None where the host library did not load."""
    if native_host.lib() is None:
        return None
    from grid_tpu_torch.native_host import bam

    return bam


def build_mosdepth_command(cram_path, ref_fasta, output_prefix, by, fast_mode, threads=1):
    """mosdepth CLI invocation (ref: grid/utils/mosdepth.py:193-225)."""
    cmd = [
        "mosdepth",
        "-n",
        "--by",
        str(by),
        "-f",
        str(ref_fasta),
        str(output_prefix),
        str(cram_path),
        "-t",
        str(threads),
    ]
    if fast_mode:
        cmd.insert(1, "--fast-mode")
    return cmd


def compute_region_coverage(regions_file, chrom, start, end, sparse=False) -> int:
    """Overlap-weighted mean depth over [start, end], scaled by 100 and
    rounded (ref: grid/utils/mosdepth.py:264-297; formula
    docs/source/algorithms/coverage.rst:25-45).

    ``sparse``: the bed.gz was written with skip_zero — zero-depth bins
    inside the window are absent from the file but MUST still count in the
    denominator (they carry 0 depth). The built-in binners always emit each
    contig's final bin in sparse mode, so the max bin end seen for ``chrom``
    is the contig length; the denominator is the window clipped to it —
    identical to summing overlaps over the dense tiling.
    """
    region_cov = 0.0
    covered_bp = 0
    contig_end = 0
    with gzip.open(regions_file, "rt") as f:
        for line in f:
            fields = line.strip().split("\t")
            if len(fields) < 4:
                continue
            r_chr, r_start, r_end, mean_cov = fields[0], int(fields[1]), int(fields[2]), float(fields[3])
            if r_chr != chrom:
                continue
            contig_end = max(contig_end, r_end)
            overlap = min(end, r_end) - max(start, r_start)
            if overlap > 0:
                region_cov += mean_cov * overlap
                covered_bp += overlap
    if sparse:
        covered_bp = max(0, min(end, contig_end) - max(start, 0))
    return int(round(100 * (region_cov / covered_bp))) if covered_bp > 0 else 0


def run_coverage_single(
    aln_path, ref_fasta, work_dir, chrom, start, end, region_name, by, fast_mode,
    threads=1, sparse_bed=False,
):
    """Produce the per-sample regions.bed.gz and window coverage."""
    aln = Path(aln_path)
    sample_name = aln.stem
    out_prefix = Path(work_dir) / f"{sample_name}_{region_name}"
    regions_file = Path(f"{out_prefix}.regions.bed.gz")

    if mosdepth_available():
        sparse_bed = False  # mosdepth always writes the dense tiling
        cmd = build_mosdepth_command(str(aln), ref_fasta, out_prefix, by, fast_mode, threads)
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        if not regions_file.exists():
            matches = sorted(Path(work_dir).glob(f"{sample_name}*regions.bed.gz"))
            if not matches:
                raise FileNotFoundError(f"mosdepth output missing for {sample_name}")
            regions_file = matches[0]
    elif str(aln).endswith(".cram"):
        try:
            from grid_tpu_torch.native_host import cram as native_cram

            native_cram.binned_depth(str(aln), str(regions_file), int(by),
                                     skip_zero=sparse_bed)
        except (RuntimeError, OSError):  # no host library / unsupported block codec
            from grid_tpu_torch.io import cramlite

            native_host.count_fallback("alignment_reader")
            cramlite.binned_depth(str(aln), str(regions_file), int(by),
                                  skip_zero=sparse_bed)
    else:
        native = _native_binner()
        if native is None or not str(aln).endswith(".bam"):
            raise RuntimeError(
                "No coverage backend: install mosdepth, or provide BAM/CRAM "
                "input for the built-in depth binners."
            )
        native.binned_depth(str(aln), str(regions_file), int(by),
                            skip_zero=sparse_bed)

    return compute_region_coverage(regions_file, chrom, start, end, sparse=sparse_bed)


_INTERMEDIATE_SUFFIXES = (
    "mosdepth.global.dist.txt",
    "mosdepth.region.dist.txt",
    "mosdepth.summary.txt",
    "regions.bed.gz.csi",
)


def remove_intermediate_files(work_dir, console=None, include_region_bed_gz=False):
    """Delete mosdepth side-products from work_dir, keeping the
    regions.bed.gz step 4 consumes (ref: grid/utils/mosdepth.py:300-326;
    gated by ``mosdepth.remove_intermediate`` like ref mosdepth.py:36,104).
    The built-in binners produce none of these, so this is a no-op on the
    native path."""
    suffixes = _INTERMEDIATE_SUFFIXES
    if include_region_bed_gz:
        suffixes = suffixes + ("regions.bed.gz",)
    for f in Path(work_dir).glob("*"):
        if f.name.endswith(suffixes):
            try:
                f.unlink()
            except OSError as e:
                log(console, f"Failed to remove intermediate file {f}: {e}",
                    style="warning")


def compute_mosdepth(config, console=None, timer=None):
    """Step 3 for every sample found in ``directory_loc``: the
    regions.bed.gz files in ``mosdepth.work_dir`` and the coverage TSV
    ``<output_dir>/<prefix>.<type>``, whose path it returns. ``timer`` is
    accepted for the pipeline's step signature and not used."""
    directory_loc = config["directory_loc"]
    samples = read_samples(config["samples_file"])
    chrom = config.get("chrom")
    start = config.get("start_bp")
    end = config.get("end_bp")

    mcfg = config.get("mosdepth", {})
    output_file_prefix = mcfg.get("output_file_prefix")
    output_file_type = config.get("output_file_type", "tsv")
    output_dir = config.get("output_dir", ".")
    output_file = Path(f"{output_dir}/{output_file_prefix}.{output_file_type}")

    threads = config.get("threads", 1)
    ref = config.get("reference_genome")
    region_name = mcfg.get("region_name", "region")
    by = mcfg.get("bin_size", 1000)
    fast_mode = str(mcfg.get("mode", "fast")).lower() == "fast"
    sparse_bed = bool(mcfg.get("sparse_bed", False))
    work_dir = Path(mcfg.get("work_dir")).expanduser()
    work_dir.mkdir(parents=True, exist_ok=True)

    output_path = setup_output_file(output_file, chrom, start, end)

    files = {
        sample: path
        for sample, path in find_files(
            directory_loc, samples, config.get("file_type")
        ).items()
        if path is not None
    }

    write_lock = Lock()
    failed = []

    errors = {}

    def process(path):
        try:
            return run_coverage_single(
                path, ref, work_dir, chrom, start, end, region_name, by,
                fast_mode, threads, sparse_bed=sparse_bed,
            )
        except Exception as e:
            detail = getattr(e, "stderr", "") or str(e)
            errors[str(path)] = str(detail)[-500:]
            return "Error"

    with progress_bar(console, total=len(files), description="Running coverage") as (progress, task):
        with ThreadPoolExecutor(max_workers=max(1, threads)) as executor:
            futures = {executor.submit(process, path): sample for sample, path in files.items()}
            for future in as_completed(futures):
                sample = futures[future]
                coverage = future.result()
                if coverage != "Error":
                    with write_lock:
                        with open(output_path, "a", newline="") as f:
                            f.write(f"{sample}\t{coverage}\n")
                else:
                    detail = errors.get(str(files[sample]), "")
                    log(console, f"✗ {sample} failed: {detail}", style="danger")
                    failed.append(sample)
                progress.update(task, advance=1)

    if mcfg.get("remove_intermediate", False):
        remove_intermediate_files(work_dir, console)

    log(console, f"Coverage results written to {output_path}", style="success")
    return output_path
