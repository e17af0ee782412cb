"""Cohort-building and support tooling (twin of ``grid_tpu/tools.py``).

Re-implementations of the reference's standalone utilities (SURVEY §2.2:
``utils/ensure_crai.py``, ``utils/subset_cram.py``, ``utils/batch_crai.py``,
``utils/batch_subset_cram.py`` and
``grid/utils/helper_dir/add_gen_mapping.py``), without the reference's
use-before-assignment bug in batch_subset (utils/batch_subset_cram.py:40).
They run on the host.

The routes are the JAX package's: a BAM goes to the host library's
subsetter; a CRAM goes to cramlite, whose records the host library's
verbatim writer writes (the Python writer where a reference is named or
embedded), or to pysam where it is installed. One repair: where the native
CRAM writer fails, the JAX package passes on silently to the Python writer;
here that adds one to ``native_host.fallbacks["cram_write"]`` and logs a
warning.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor, as_completed
from pathlib import Path

import numpy as np

from grid_tpu_torch import native_host
from grid_tpu_torch.ingest.alignments import create_index_for_file, has_index
from grid_tpu_torch.io.phased import read_genetic_map
from grid_tpu_torch.utils.logging import log, progress_bar


def _alignment_files(directory: Path) -> list:
    return sorted(list(directory.glob("*.bam")) + list(directory.glob("*.cram")))


def ensure_index(aln_path, reference_genome=None, console=None) -> bool:
    """Ensure a .bai/.crai exists for one alignment file
    (covers utils/ensure_crai.py). Returns True if present or created."""
    aln_path = str(aln_path)
    file_type = "cram" if aln_path.endswith(".cram") else "bam"
    if has_index(aln_path, file_type):
        return True
    create_index_for_file(aln_path, file_type, reference_genome)
    return has_index(aln_path, file_type)


def batch_ensure_index(directory, reference_genome=None, threads: int = 1, console=None):
    """Index every BAM/CRAM in a directory (covers utils/batch_crai.py).

    Returns {path: ok}.
    """
    files = _alignment_files(Path(directory).expanduser())
    results: dict[str, bool] = {}
    with progress_bar(console, total=len(files), description="Indexing") as (progress, task):
        with ThreadPoolExecutor(max_workers=max(1, threads)) as ex:
            futures = {ex.submit(ensure_index, f, reference_genome, console): f for f in files}
            for fut in as_completed(futures):
                f = futures[fut]
                try:
                    results[str(f)] = fut.result()
                except Exception as e:
                    log(console, f"Failed to index {f.name}: {e}", style="danger")
                    results[str(f)] = False
                progress.advance(task)
    return results


def subset_alignment(aln_path, chrom, start, end, out_path, reference_genome=None,
                     embed_reference: bool = False, console=None) -> int:
    """Extract the reads overlapping a region into a new file
    (covers utils/subset_cram.py). BAM uses the native subsetter; CRAM uses
    cramlite (or pysam when installed). Returns the number of records
    written.

    With ``embed_reference=True`` (CRAM output via cramlite), each slice
    carries its reference window: the subset decodes anywhere without the
    FASTA, the natural mode for shipping locus cutouts."""
    aln_path = str(aln_path)
    if aln_path.endswith(".bam") and native_host.lib() is not None:
        from grid_tpu_torch.native_host import bam

        return bam.subset_region(aln_path, chrom, start, end, out_path)
    try:
        import pysam  # type: ignore
    except ImportError:
        pysam = None
    if aln_path.endswith(".cram") and (pysam is None or embed_reference):
        from grid_tpu_torch.io import cramlite

        with cramlite.CramReader(aln_path, reference=reference_genome) as rd:
            recs = list(rd.iter_records(chrom, start, end))
            if not embed_reference and reference_genome is None:
                try:  # verbatim mode: the C++ writer
                    from grid_tpu_torch.native_host import cram as native_cram

                    native_cram.write_cram(out_path, rd.references, recs)
                    return len(recs)
                except Exception as e:
                    native_host.count_fallback("cram_write")
                    log(console, f"native CRAM writer failed on {out_path} ({e}); writing it "
                        "with cramlite's Python writer", style="warning")
            cramlite.write_cram(out_path, rd.references, recs, reference=reference_genome,
                                embed_reference=embed_reference)
        return len(recs)
    if pysam is None:
        raise RuntimeError(
            "Subsetting needs the native library (BAM), cramlite (CRAM), or pysam")
    n = 0
    with pysam.AlignmentFile(aln_path, "rc", reference_filename=reference_genome) as fin:
        with pysam.AlignmentFile(str(out_path), "wc", template=fin,
                                 reference_filename=reference_genome) as fout:
            for read in fin.fetch(chrom, start, end):
                fout.write(read)
                n += 1
    return n


def batch_subset(directory, chrom, start, end, output_dir, reference_genome=None,
                 threads: int = 1, console=None):
    """Subset every alignment file in a directory to a region
    (covers utils/batch_subset_cram.py, with its broken file-list bug fixed).

    Returns {input_path: n_records or None on failure}.
    """
    output_dir = Path(output_dir).expanduser()
    output_dir.mkdir(parents=True, exist_ok=True)
    files = _alignment_files(Path(directory).expanduser())
    results: dict[str, int | None] = {}

    def _one(f: Path):
        out = output_dir / f"{f.stem}_subset{f.suffix}"
        return subset_alignment(f, chrom, start, end, out, reference_genome, console=console)

    with progress_bar(console, total=len(files), description="Subsetting") as (progress, task):
        with ThreadPoolExecutor(max_workers=max(1, threads)) as ex:
            futures = {ex.submit(_one, f): f for f in files}
            for fut in as_completed(futures):
                f = futures[fut]
                try:
                    results[str(f)] = fut.result()
                except Exception as e:
                    log(console, f"Failed to subset {f.name}: {e}", style="danger")
                    results[str(f)] = None
                progress.advance(task)
    return results


def add_genetic_map(map_file, genetic_map_file, out_prefix) -> Path:
    """Interpolate cM positions onto a PLINK MAP file using an Eagle genetic
    map (covers helper_dir/add_gen_mapping.py, support tooling for the
    computeIBSpbwt input). Writes ``{out_prefix}.map``."""
    gpos, gcm = read_genetic_map(genetic_map_file)

    rows = []
    with open(map_file) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 4:
                parts = line.split()
            if len(parts) < 4:
                continue
            rows.append(parts[:4])

    bp = np.array([float(r[3]) for r in rows])
    cm = np.interp(bp, gpos, gcm)

    out = Path(f"{out_prefix}.map")
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "w") as f:
        for r, c in zip(rows, cm):
            f.write(f"{r[0]}\t{r[1]}\t{c}\t{r[3]}\n")
    return out
