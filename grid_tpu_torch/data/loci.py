"""Locus catalogs and hardcoded coordinates (twin of ``grid_tpu/data/loci.py``).

The tables under ``grid_tpu_torch/data/files/`` are byte copies of
``grid_tpu/data/files/`` (a test holds them equal):

- ``734_possible_coding_vntr_regions.IBD2R_gt_0.25.uniq.txt`` — the
  Mukamel 2021 VNTR catalog (whitespace columns CHR BP_START_HG38
  BP_END_HG38 SAMTOOLS_START SAMTOOLS_END IBD2R GENE, a header row; 733
  regions, 492 distinct genes), which :func:`load_vntr_catalog` reads by
  default;
- ``hardcoded_positions.txt`` — the KIV-2 repeat-unit starts, hg38 and
  hg19, also inlined below.

:func:`resolve_locus` is the ``wgs --locus GENE`` lookup: the first catalog
row whose GENE matches (several genes appear more than once), then a member
of a comma-separated GENE list.
"""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple

BUNDLED_CATALOG = (
    Path(__file__).parent
    / "files"
    / "734_possible_coding_vntr_regions.IBD2R_gt_0.25.uniq.txt"
)
BUNDLED_HARDCODED_POSITIONS = Path(__file__).parent / "files" / "hardcoded_positions.txt"


class Locus(NamedTuple):
    chrom: str
    start: int
    end: int
    gene: str


# the validated flagship locus: LPA KIV-2 on hg38
LPA_KIV2_HG38 = Locus(chrom="chr6", start=160_605_062, end=160_647_661, gene="LPA")

# KIV-2 repeat-unit start positions (hardcoded_positions.txt: hg38, hg19)
KIV2_REPEAT_STARTS_HG38 = (
    160_611_000,
    160_611_561,
    160_617_116,
    160_622_662,
    160_628_206,
    160_633_752,
    160_639_299,
    160_644_846,
)

KIV2_REPEAT_STARTS_HG19 = (
    161_032_032,
    161_032_593,
    161_038_148,
    161_043_694,
    161_049_238,
    161_054_784,
    161_060_331,
    161_065_878,
)


def load_vntr_catalog(path=None) -> list[Locus]:
    """Parse a VNTR catalog in the Mukamel-2021 table format (whitespace
    columns, a header row, GENE named in the header); rows with fewer than
    three columns or non-integer coordinates are skipped. Defaults to the
    bundled catalog."""
    if path is None:
        path = BUNDLED_CATALOG
    loci: list[Locus] = []
    with open(path) as f:
        header = f.readline().split()
        gene_idx = header.index("GENE") if "GENE" in header else -1
        for line in f:
            parts = line.split()
            if len(parts) < 3:
                continue
            try:
                chrom = parts[0] if parts[0].startswith("chr") else f"chr{parts[0]}"
                start = int(parts[1])
                end = int(parts[2])
            except ValueError:
                continue
            gene = parts[gene_idx] if gene_idx != -1 and len(parts) > gene_idx else ""
            loci.append(Locus(chrom, start, end, gene))
    return loci


def find_locus(loci: list[Locus], gene: str) -> Locus | None:
    """The first locus whose GENE is exactly ``gene``, or None."""
    for locus in loci:
        if locus.gene == gene:
            return locus
    return None


def resolve_locus(gene: str, catalog_path=None) -> Locus:
    """Look a gene up in the (bundled by default) VNTR catalog: an exact
    GENE first, then a member of a comma-separated GENE list (e.g.
    ``AC005324.4,ZNF286A``). Raises ``KeyError`` with up to five close
    matches when absent."""
    loci = load_vntr_catalog(catalog_path)
    hit = find_locus(loci, gene)
    if hit is not None:
        return hit
    for locus in loci:
        if gene in locus.gene.split(","):
            return locus
    close = sorted({locus.gene for locus in loci if gene.lower() in locus.gene.lower()})[:5]
    hint = f"; close matches: {', '.join(close)}" if close else ""
    raise KeyError(f"locus {gene!r} not in the VNTR catalog{hint}")
