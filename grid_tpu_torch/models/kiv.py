"""LPA KIV-2 exon-level capabilities (twin of ``grid_tpu/models/kiv.py``).

Preserves the reference's dormant-but-tested exon taxonomy and KIV2 linear
estimate (SURVEY §3.5):

- exon-count taxonomy 1A / 1B_KIV3 / 1B_notKIV3 / 1B
  (ref: grid/utils/compute_dipcn_dir/get_exon_count.py:27-44);
- per-exon neighbor-normalized diploid CN
  (ref: grid/utils/compute_dipcn_dir/compute_diploid_cn.py:8-63);
- the KIV2 copy-number formula ``dipCN_est = 34.9*exon1A + 5.2*exon1B - 1``
  (ref: grid/utils/estimate_kiv.py:22-24).

The per-exon dipCN is vectorized like :mod:`grid_tpu_torch.ops.dipcn`; the tiny
linear estimate stays host-side numpy.
"""

from __future__ import annotations

import numpy as np

EXON_TYPES = ("1B_KIV3", "1B_notKIV3", "1B", "1A")

# dip_estimate = KIV2_1A_COEF * exon1A + KIV2_1B_COEF * exon1B + KIV2_OFFSET
KIV2_1A_COEF = 34.9
KIV2_1B_COEF = 5.2
KIV2_OFFSET = -1.0


def get_exon_count(counts: dict[str, int], exon_type: str) -> int:
    """Combine raw realignment counts into an exon-type count.

    1B_KIV3 -> 1B_KIV3; 1B_notKIV3 -> 1B_KIV2 + 1B_tied;
    1B -> 1B_KIV3 + 1B_KIV2 + 1B_tied; 1A -> 1A.
    """
    if exon_type == "1B_KIV3":
        return counts.get("1B_KIV3", 0)
    if exon_type == "1B_notKIV3":
        return counts.get("1B_KIV2", 0) + counts.get("1B_tied", 0)
    if exon_type == "1B":
        return counts.get("1B_KIV3", 0) + counts.get("1B_KIV2", 0) + counts.get("1B_tied", 0)
    if exon_type == "1A":
        return counts.get("1A", 0)
    raise ValueError(f"Unknown exon type: {exon_type}")


def compute_dipcn_for_exon(
    counts: dict[str, dict[str, int]],
    neighbors: dict[str, tuple[float, list[tuple[str, float, float]]]],
    exon_type: str,
    n_neighbors: int = 200,
) -> dict[str, float]:
    """Per-exon diploid CN over string-keyed host data.

    Semantics differ subtly from the main dipCN step (reference parity):
    zero-count samples are dropped, zero-count/zero-scale neighbors are
    skipped, and the first ``n_neighbors`` LIST entries are considered (a
    skipped neighbor DOES consume a slot here, unlike step 6).
    """
    results: dict[str, float] = {}
    for sample_id, (sample_scale, neighbor_list) in neighbors.items():
        if sample_id not in counts:
            continue
        sample_count = get_exon_count(counts[sample_id], exon_type)
        if sample_count == 0:
            continue
        total = 0.0
        num = 0
        for nbr_id, nbr_scale, _dist in neighbor_list[:n_neighbors]:
            if nbr_id not in counts:
                continue
            nbr_count = get_exon_count(counts[nbr_id], exon_type)
            if nbr_count > 0 and nbr_scale > 0:
                total += nbr_count / nbr_scale
                num += 1
        if num > 0 and sample_scale > 0:
            mean_nbr = total / num
            if mean_nbr > 0:
                results[sample_id] = (sample_count / sample_scale) / mean_nbr
    return results


def estimate_kiv2(exon1a: np.ndarray, exon1b: np.ndarray):
    """KIV2 copy-number estimates from exon dipCNs.

    Returns (dip_estimate, hap_estimate) where
    dip = 34.9*exon1A + 5.2*exon1B - 1 and hap = dip / 2.
    """
    exon1a = np.asarray(exon1a, dtype=float)
    exon1b = np.asarray(exon1b, dtype=float)
    dip = KIV2_1A_COEF * exon1a + KIV2_1B_COEF * exon1b + KIV2_OFFSET
    return dip, dip / 2


def estimate_kiv_files(exon1a_file, exon1b_file, output) -> int:
    """Join two exon dipCN TSVs on sample ID, apply :func:`estimate_kiv2`,
    and write ``ID exon1A exon1B dip_estimate estimate``. Returns the
    number of overlapping samples (raises when there is no overlap)."""
    from pathlib import Path

    from grid_tpu_torch.io.formats import read_dipcn

    ids_a, vals_a, _ = read_dipcn(exon1a_file)
    ids_b, vals_b, _ = read_dipcn(exon1b_file)
    a = dict(zip(ids_a, vals_a))
    b = dict(zip(ids_b, vals_b))
    overlap = sorted(set(a) & set(b))
    if not overlap:
        raise ValueError("No overlapping samples between exon files")
    dip, hap = estimate_kiv2(
        np.array([a[s] for s in overlap]), np.array([b[s] for s in overlap])
    )
    out = Path(output)
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "w") as f:
        f.write("ID\texon1A\texon1B\tdip_estimate\testimate\n")
        for i, s in enumerate(overlap):
            f.write(f"{s}\t{a[s]:.6f}\t{b[s]:.6f}\t{dip[i]:.4f}\t{hap[i]:.4f}\n")
    return len(overlap)


def normalize_sample_id(sample_id: str) -> str:
    """Strip CRAM/BAM suffixes and the TOPMed subset marker from an ID
    (ref: grid/utils/compute_dipcn_dir/normalize_sample_id.py:3-30)."""
    sample_id = sample_id.strip()
    if ".b38.irc.v1_subset" in sample_id:
        sample_id = sample_id.replace(".b38.irc.v1_subset", "")
    if sample_id.endswith(".cram"):
        sample_id = sample_id[:-5]
    elif sample_id.endswith(".bam"):
        sample_id = sample_id[:-4]
    return sample_id.strip()
