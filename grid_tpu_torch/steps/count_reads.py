"""Step 2: count VNTR-window reads per sample (twin of
``grid_tpu/steps/count_reads.py``).

File-compatible with the reference step (grid/utils/count_reads.py:14):
thread-pool fan-out over samples, thread-safe appends to the counts TSV,
"Error" rows for failing samples. Quirk Q3 preserved: ``min_mapq`` is read
from the config TOP LEVEL (default 1); ``count_reads.min_mapq`` is ignored.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor, as_completed
from pathlib import Path
from threading import Lock

from grid_tpu_torch.ingest.alignments import count_reads_in_region, find_files
from grid_tpu_torch.io.formats import read_samples, setup_output_file
from grid_tpu_torch.utils.logging import log, progress_bar


def count_reads(config, console=None, timer=None):
    """Count the window's reads of every sample found in ``directory_loc``
    into ``<output_dir>/<prefix>.<type>``; returns its path. ``timer`` is
    accepted for the pipeline's step signature and not used."""
    directory_loc = config["directory_loc"]
    samples = read_samples(config["samples_file"])
    chrom = config.get("chrom")
    start = config.get("start_bp")
    end = config.get("end_bp")
    flags = config.get("count_reads", {}).get("flags", [])
    threads = config.get("threads", 1)
    min_mapq = config.get("min_mapq", 1)  # quirk Q3: top level, not step level

    output_file_prefix = config.get("count_reads", {}).get("output_file_prefix")
    output_file_type = config.get("output_file_type", "tsv")
    output_dir = config.get("output_dir", ".")
    output_file = Path(f"{output_dir}/{output_file_prefix}.{output_file_type}")
    ref = config.get("reference_genome")

    output_path = setup_output_file(output_file, chrom, start, end)

    files = {
        sample: path
        for sample, path in find_files(
            directory_loc, samples, config.get("file_type")
        ).items()
        if path is not None
    }

    write_lock = Lock()

    def process(sample, path):
        try:
            return count_reads_in_region(path, ref, chrom, start, end, flags, min_mapq)
        except Exception as e:
            log(console, f"Failed to count reads for {Path(path).name}: {e}", style="danger")
            return "Error"

    with progress_bar(console, total=len(files), description="Counting reads") as (progress, task):
        with ThreadPoolExecutor(max_workers=max(1, threads)) as executor:
            futures = {
                executor.submit(process, sample, path): sample for sample, path in files.items()
            }
            for future in as_completed(futures):
                sample = futures[future]
                count = future.result()
                with write_lock:
                    with open(output_path, "a") as f:
                        f.write(f"{sample}\t{count}\n")
                progress.advance(task)

    log(console, f"Read counting completed. Results written to {output_path}", style="success")
    return output_path
