"""Reference-genome FASTA region extraction (twin of ``grid_tpu/io/fasta.py``).

Implements the capability behind the reference's commented-out
``extract-reference`` CLI command (grid/cli.py:475-488 — its backing module
``grid/utils/extract_reference.py`` does not exist upstream): cut BED
regions out of a genome FASTA into a small per-region FASTA, the input the
exon realignment path (:mod:`grid_tpu_torch.models.realign`) consumes.

Design notes:

- the genome is streamed contig by contig (a whole hs37d5 is ~3 GB as one
  string; per-contig peak is the largest chromosome, ~250 MB);
- a ``.fai`` index (samtools faidx layout) is used for random access when
  present next to the FASTA — only the requested contigs' bytes are read;
- BED coordinates are 0-based half-open (the BED convention); the 4th BED
  column, when present, names the output record (so a BED of exon labels
  like ``1A``/``1B_KIV2``/``1B_KIV3`` produces a realign-ready FASTA),
  otherwise records are named ``chrom:start-end``.
"""

from __future__ import annotations

from pathlib import Path

from grid_tpu_torch.io.formats import open_maybe_gz
from grid_tpu_torch.utils.logging import log


def read_bed_regions(bed_file):
    """Parse a BED file into [(chrom, start, end, name|None), ...].

    Lines starting with ``#``, ``track`` or ``browser`` are skipped
    (standard BED headers); malformed lines raise with the line number.
    """
    regions = []
    with open_maybe_gz(bed_file) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line or line.startswith(("#", "track", "browser")):
                continue
            parts = line.split("\t")
            if len(parts) < 3:
                raise ValueError(
                    f"{bed_file}:{lineno}: BED line needs >=3 columns: {line!r}"
                )
            try:
                start, end = int(parts[1]), int(parts[2])
            except ValueError as exc:
                raise ValueError(
                    f"{bed_file}:{lineno}: non-integer BED coordinates"
                ) from exc
            if start < 0 or end < start:
                raise ValueError(
                    f"{bed_file}:{lineno}: invalid interval [{start}, {end})"
                )
            name = parts[3] if len(parts) > 3 and parts[3] else None
            regions.append((parts[0], start, end, name))
    if not regions:
        raise ValueError(f"No regions found in {bed_file}")
    return regions


def iter_fasta_contigs(path):
    """Yield ``(name_first_token, sequence)`` per contig, streaming."""
    name = None
    chunks: list[str] = []
    with open_maybe_gz(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if name is not None:
                    yield name, "".join(chunks)
                name = line[1:].split()[0]
                chunks = []
            else:
                chunks.append(line)
    if name is not None:
        yield name, "".join(chunks)


def _read_fai(fai_path):
    """Parse a samtools .fai: {name: (length, offset, linebases, linewidth)}."""
    index = {}
    with open(fai_path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 5:
                continue
            index[parts[0]] = (
                int(parts[1]), int(parts[2]), int(parts[3]), int(parts[4])
            )
    return index


def _fetch_indexed(fa_path, index, chrom, start, end):
    """Random-access slice [start, end) via the .fai layout (no newline
    arithmetic errors: offsets count the newline bytes per sequence line)."""
    length, offset, linebases, linewidth = index[chrom]
    end = min(end, length)
    if start >= end:
        return ""
    byte_lo = offset + (start // linebases) * linewidth + (start % linebases)
    byte_hi = offset + ((end - 1) // linebases) * linewidth + ((end - 1) % linebases) + 1
    with open(fa_path, "rb") as f:
        f.seek(byte_lo)
        raw = f.read(byte_hi - byte_lo)
    return raw.replace(b"\n", b"").replace(b"\r", b"").decode()


def extract_reference(reference_fa, bed_file, output_dir, output_prefix="ref_lpa",
                      line_width: int = 60, console=None):
    """Cut BED regions from a reference genome FASTA into
    ``output_dir/output_prefix.fa`` (the reference CLI's contract,
    grid/cli.py:475-488). Returns the output path.

    Uses ``reference_fa.fai`` for random access when present (plain FASTA
    only); otherwise streams the genome contig by contig. Regions on
    contigs missing from the FASTA raise (silent empty records would
    poison realignment downstream); out-of-range ends are clamped to the
    contig, matching samtools faidx.
    """
    reference_fa = Path(reference_fa).expanduser()
    regions = read_bed_regions(bed_file)
    out_dir = Path(output_dir).expanduser()
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path = out_dir / f"{output_prefix}.fa"

    wanted = {}
    for chrom, start, end, name in regions:
        wanted.setdefault(chrom, []).append((start, end, name))

    seqs: dict[int, str] = {}
    fai = Path(str(reference_fa) + ".fai")
    if fai.exists() and not str(reference_fa).endswith(".gz"):
        index = _read_fai(fai)
        missing = [c for c in wanted if c not in index]
        if missing:
            raise ValueError(
                f"contigs in {bed_file} absent from {fai.name}: {missing}"
            )
        for i, (chrom, start, end, _name) in enumerate(regions):
            seqs[i] = _fetch_indexed(reference_fa, index, chrom, start, end)
    else:
        seen = set()
        for contig, seq in iter_fasta_contigs(reference_fa):
            if contig not in wanted:
                continue
            seen.add(contig)
            for i, (chrom, start, end, _name) in enumerate(regions):
                if chrom == contig:
                    seqs[i] = seq[start:min(end, len(seq))]
            if seen == set(wanted):
                break
        missing = set(wanted) - seen
        if missing:
            raise ValueError(
                f"contigs in {bed_file} absent from {reference_fa}: "
                f"{sorted(missing)}"
            )

    with open(out_path, "w") as f:
        for i, (chrom, start, end, name) in enumerate(regions):
            header = name if name else f"{chrom}:{start}-{end}"
            f.write(f">{header}\n")
            seq = seqs.get(i, "")
            for j in range(0, len(seq), line_width):
                f.write(seq[j:j + line_width] + "\n")
            if not seq:
                f.write("\n")
    log(console, f"Extracted {len(regions)} regions → {out_path}",
        style="success")
    return out_path
