"""Step 1: check/create alignment-file indexes (twin of
``grid_tpu/steps/index.py``).

File-compatible with the reference step (grid/utils/utils.py:115-222):
per sample, locate the CRAM/BAM in ``directory_loc``, check or create the
.crai/.bai, write a status TSV.
"""

from __future__ import annotations

from pathlib import Path

from grid_tpu_torch.ingest.alignments import create_index_for_file, find_files, has_index
from grid_tpu_torch.io.formats import read_samples
from grid_tpu_torch.utils.logging import log, progress_bar


def _scan(config, console, create: bool):
    file_type = config.get("file_type")
    directory_loc = config["directory_loc"]
    samples = read_samples(config["samples_file"])
    reference_genome = config.get("reference_genome")

    results = {"missing_file": [], "missing_index": [], "has_index": []}
    desc = "Creating index" if create else "Checking indexes"
    file_paths = find_files(directory_loc, samples, file_type)
    with progress_bar(console, total=len(samples), description=desc) as (progress, task):
        for sample in samples:
            file_path = file_paths[sample]
            if not file_path:
                results["missing_file"].append(sample)
                progress.advance(task)
                continue
            if has_index(file_path, file_type):
                results["has_index"].append(sample)
                progress.advance(task)
                continue
            if create:
                try:
                    create_index_for_file(file_path, file_type, reference_genome)
                    results["has_index"].append(sample)
                except Exception as e:
                    log(console, f"Failed to create index for {sample}: {e}", style="danger")
                    results["missing_index"].append(sample)
            else:
                results["missing_index"].append(sample)
            progress.advance(task)
    return results


def _write_status(config, results, suffix, only_on_problem=False):
    prefix = config.get("index", {}).get("output_file_prefix")
    if not prefix:
        return None
    if only_on_problem and not (results["missing_file"] or results["missing_index"]):
        return None
    output_dir = config.get("output_dir", ".")
    out = Path(output_dir) / f"{prefix}.{suffix}"
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "w") as f:
        f.write("Sample\tStatus\n")
        for sample in results["has_index"]:
            f.write(f"{sample}\tHas index\n")
        for sample in results["missing_file"]:
            f.write(f"{sample}\tMissing file\n")
        for sample in results["missing_index"]:
            status = "Failed to create index" if suffix == "err" else "Missing index"
            f.write(f"{sample}\t{status}\n")
    return out


def check_index(config, console=None):
    """Verify every sample has an index; write status TSV
    (ref: grid/utils/utils.py:115-162)."""
    results = _scan(config, console, create=False)
    out = _write_status(config, results, config.get("output_file_type", "tsv"))
    if out:
        log(console, f"Index check results written to {out}", style="success")
    return results


def create_index(config, console=None):
    """Create missing indexes; write .err status on problems
    (ref: grid/utils/utils.py:166-222)."""
    results = _scan(config, console, create=True)
    out = _write_status(config, results, "err", only_on_problem=True)
    if out:
        log(console, f"Index creation results written to {out}", style="success")
    return results
