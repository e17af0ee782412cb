"""Host IO for the exon-level (legacy) dipCN path (twin of
``grid_tpu/models/kiv_io.py``).

Covers the reference's ``compute_dipcn_dir`` loaders/writers (SURVEY §2.2):
the 5-column realignment counts format, the neighbor-results parser with
sample-ID normalization, overlap validation, and the ``ID\\tdipCN`` %.6f
output format (§2.3.8 legacy variant).
"""

from __future__ import annotations

import gzip
from pathlib import Path

from grid_tpu_torch.models.kiv import normalize_sample_id


def load_count_results(count_file) -> dict[str, dict[str, int]]:
    """Realignment counts: ``sample\\t1B_KIV3\\t1B_KIV2\\t1B_tied\\t1A``
    (ref: compute_dipcn_dir/load_count_results.py:9-49). Malformed or
    non-5-column rows are skipped; IDs are normalized."""
    counts: dict[str, dict[str, int]] = {}
    with open(count_file) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            fields = line.split("\t")
            if len(fields) != 5:
                continue
            sid = normalize_sample_id(fields[0])
            try:
                counts[sid] = {
                    "1B_KIV3": int(fields[1]),
                    "1B_KIV2": int(fields[2]),
                    "1B_tied": int(fields[3]),
                    "1A": int(fields[4]),
                }
            except ValueError:
                continue
    return counts


def load_neighbor_results(neighbor_file):
    """Neighbors with normalized IDs:
    {sample: (scale, [(nbr_id, nbr_scale, distance), ...])}
    (ref: compute_dipcn_dir/load_neighbor_results.py:10-69)."""
    neighbors: dict[str, tuple[float, list[tuple[str, float, float]]]] = {}
    opener = gzip.open if str(neighbor_file).endswith(".gz") else open
    with opener(neighbor_file, "rt") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            fields = line.split("\t")
            if len(fields) < 2:
                continue
            sid = normalize_sample_id(fields[0])
            try:
                scale = float(fields[1])
            except ValueError:
                continue
            nbr_list = []
            for j in range(2, len(fields), 3):
                if j + 2 < len(fields):
                    try:
                        nbr_list.append(
                            (
                                normalize_sample_id(fields[j]),
                                float(fields[j + 1]),
                                float(fields[j + 2]),
                            )
                        )
                    except ValueError:
                        continue
            neighbors[sid] = (scale, nbr_list)
    return neighbors


def validate_sample_overlap(counts, neighbors, console=None):
    """Overlap between counts and neighbors keys
    (ref: compute_dipcn_dir/validate_sample_overlap.py:8-30).
    Returns (n_overlap, overlap_set)."""
    overlap = set(counts.keys()) & set(neighbors.keys())
    if console:
        console.print(f"  • Samples in count file: {len(counts)}")
        console.print(f"  • Samples in neighbor file: {len(neighbors)}")
        console.print(f"  • Overlapping samples: {len(overlap)}")
    return len(overlap), overlap


def write_dipcn_output(results: dict[str, float], output_file) -> None:
    """Legacy ``ID\\tdipCN`` %.6f format, sorted by sample
    (ref: compute_dipcn_dir/write_dipcn_output.py:8-31)."""
    output_path = Path(output_file)
    output_path.parent.mkdir(parents=True, exist_ok=True)
    with open(output_path, "w") as f:
        f.write("ID\tdipCN\n")
        for sid, dip_cn in sorted(results.items()):
            f.write(f"{sid}\t{dip_cn:.6f}\n")
