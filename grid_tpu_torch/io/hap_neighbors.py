"""IBS / IBD haplotype-neighbor input parsers (twin of
``grid_tpu/io/hap_neighbors.py``, numpy only).

Parses the two external haplotype-matching formats consumed by haploid
inference:

- computeIBSpbwt output: header + ``ID hap nbrInd cMlen cMedge IDnbr hapNbr``
  with 1-indexed haplotypes (ref: grid/utils/hi_inference.py:34-74).
- iLASH output: 11 columns ``FID1 HAP_ID1 FID2 HAP_ID2 CHR BP1 BP2 SNP_BP1
  SNP_BP2 LENGTH MATCH`` with 0-indexed haps encoded as ``{FID}_{h}``
  (ref: grid/utils/hi_inference.py:86-172).

Both produce ragged per-haplotype neighbor lists; ``pad_hap_neighbors``
converts them to fixed-shape index/weight arrays for the phasing op.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from grid_tpu_torch.io.formats import open_maybe_gz


def load_ibs_neighbors(path, id_to_ind: dict[str, int], max_nbr: int):
    """Load IBS neighbors from computeIBSpbwt output.

    Returns hap_nbrs: list (length 2N) of lists of (neighbor_hap_idx, weight).
    Haplotype index for sample row i, hap h in {1,2} is ``2*i + h - 1``.
    Per-hap lists are capped at ``max_nbr`` in file order (matches reference
    first-come truncation, grid/utils/hi_inference.py:71-72).
    """
    n = len(id_to_ind)
    hap_nbrs: list[list[tuple[int, float]]] = [[] for _ in range(2 * n)]
    with open_maybe_gz(path) as f:
        next(f)  # header
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split()
            if len(parts) < 7:
                continue
            try:
                hap = int(parts[1])
                hap_nbr = int(parts[6])
            except ValueError:
                continue
            if hap not in (1, 2) or hap_nbr not in (1, 2):
                continue
            i = id_to_ind.get(parts[0])
            j = id_to_ind.get(parts[5])
            if i is None or j is None:
                continue
            h_idx = 2 * i + hap - 1
            if len(hap_nbrs[h_idx]) < max_nbr:
                hap_nbrs[h_idx].append((2 * j + hap_nbr - 1, 1.0))
    return hap_nbrs


def segment_distance(bp1: int, bp2: int, region_start: int, region_end: int) -> float:
    """bp distance from IBD segment [bp1, bp2] to the target region; 0 if
    overlapping (ref: grid/utils/hi_inference.py:77-83)."""
    if bp2 < region_start:
        return float(region_start - bp2)
    if bp1 > region_end:
        return float(bp1 - region_end)
    return 0.0


def load_ibd_neighbors(
    path,
    id_to_ind: dict[str, int],
    max_nbr: int,
    region_start: int,
    region_end: int,
    min_length: float = 0.5,
    min_match: float = 0.70,
    weighted: bool = False,
    weight_scale: float = 1_000_000,
):
    """Load IBD neighbors from iLASH output (segments are symmetric — both
    endpoints get each other as neighbors). Segments filtered by
    ``min_length`` (cM) and ``min_match``; per-hap lists sorted by segment
    length descending then truncated to ``max_nbr``. With ``weighted=True``
    each neighbor carries a Lorentzian weight
    ``(weight_scale / (distance_bp + weight_scale)) * match``.

    Returns hap_nbrs: list (length 2N) of lists of (neighbor_hap_idx, weight).
    """
    n = len(id_to_ind)
    raw: dict[int, list[tuple[int, float, float]]] = defaultdict(list)
    with open_maybe_gz(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split("\t")
            if len(parts) < 11:
                parts = line.split()
            if len(parts) < 11:
                continue
            fid1, hap_id1, fid2, hap_id2 = parts[0], parts[1], parts[2], parts[3]
            try:
                bp1 = int(parts[5])
                bp2 = int(parts[6])
                length = float(parts[9])
                match = float(parts[10])
            except (ValueError, IndexError):
                continue
            if length < min_length or match < min_match:
                continue
            try:
                hap1 = int(hap_id1.rsplit("_", 1)[-1])
                hap2 = int(hap_id2.rsplit("_", 1)[-1])
            except ValueError:
                continue
            if hap1 not in (0, 1) or hap2 not in (0, 1):
                continue
            i = id_to_ind.get(fid1)
            j = id_to_ind.get(fid2)
            if i is None or j is None:
                continue
            if weighted:
                dist = segment_distance(bp1, bp2, region_start, region_end)
                w = (weight_scale / (dist + weight_scale)) * match
            else:
                w = 1.0
            h1 = 2 * i + hap1
            h2 = 2 * j + hap2
            raw[h1].append((h2, w, length))
            raw[h2].append((h1, w, length))

    hap_nbrs: list[list[tuple[int, float]]] = [[] for _ in range(2 * n)]
    for h_idx, segments in raw.items():
        segments.sort(key=lambda x: -x[2])
        hap_nbrs[h_idx] = [(nbr, w) for nbr, w, _ in segments[:max_nbr]]
    return hap_nbrs


def pad_hap_neighbors(hap_nbrs, max_nbr: int, dtype=np.float32):
    """Convert ragged hap_nbrs into fixed [2N, max_nbr] arrays.

    Returns (nbr_idx int32, nbr_w ``dtype``, nbr_valid bool). Padded slots get
    index 0 and weight 0 with valid=False; the phasing op masks them out, and
    the reference's 1e-9 wsum floor (grid/utils/hi_inference.py:209) makes an
    all-padding hap behave identically to an empty neighbor list.
    """
    two_n = len(hap_nbrs)
    nbr_idx = np.zeros((two_n, max_nbr), dtype=np.int32)
    nbr_w = np.zeros((two_n, max_nbr), dtype=dtype)
    nbr_valid = np.zeros((two_n, max_nbr), dtype=bool)
    for h, lst in enumerate(hap_nbrs):
        for k, (j, w) in enumerate(lst[:max_nbr]):
            nbr_idx[h, k] = j
            nbr_w[h, k] = w
            nbr_valid[h, k] = True
    return nbr_idx, nbr_w, nbr_valid
