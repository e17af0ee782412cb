"""Exon realignment: classify window reads against exon references (twin of
``grid_tpu/models/realign.py``).

Reads starting in the VNTR window are re-scored against exon reference
sequences with the batched Smith-Waterman op (:mod:`grid_tpu_torch.ops.align`,
the hand kernel on the card) and counted per exon type, producing the
5-column counts file the exon dipCN path consumes
(:mod:`grid_tpu_torch.models.kiv_io`).

Classification taxonomy (matches get_exon_count's categories):
- best hit 1A                      -> "1A"
- best hit a 1B variant, decisive  -> "1B_KIV3" or "1B_KIV2"
- best hit a 1B variant, tied      -> "1B_tied"
- below min_score                  -> unclassified (dropped)

The scores run on the card unless the caller asks for ``device="cpu"``. A
sample whose alignments cannot be read is logged and skipped, as in the JAX
package; a kernel's or the card's own failure ends the run
(:func:`grid_tpu_torch.native.is_device_failure`).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor, as_completed
from pathlib import Path

from grid_tpu_torch.native import is_device_failure
from grid_tpu_torch.ops.align import classify_reads, encode_seqs
from grid_tpu_torch.utils.device import get_device
from grid_tpu_torch.utils.logging import log, progress_bar

EXON_COLUMNS = ("1B_KIV3", "1B_KIV2", "1B_tied", "1A")


def read_fasta(path) -> dict[str, str]:
    """Minimal FASTA reader: {header_first_token: sequence}."""
    seqs: dict[str, str] = {}
    name = None
    chunks: list[str] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if name is not None:
                    seqs[name] = "".join(chunks)
                name = line[1:].split()[0]
                chunks = []
            else:
                chunks.append(line)
    if name is not None:
        seqs[name] = "".join(chunks)
    return seqs


def classify_window_reads(seqs, exon_refs: dict[str, str], min_score: int, margin: int,
                          device="cuda"):
    """Count reads per exon category.

    Args:
        seqs: read sequences (strings).
        exon_refs: {label: sequence}; labels must include "1A" and the 1B
            variants ("1B_KIV3", "1B_KIV2") to exercise the tie rule.
        device: where the scores are computed.
    """
    counts = {c: 0 for c in EXON_COLUMNS}
    if not seqs:
        return counts
    labels = list(exon_refs.keys())
    refs = encode_seqs([exon_refs[l] for l in labels])
    queries = encode_seqs(list(seqs))
    assigned, scores = classify_reads(queries, refs, labels, min_score=min_score, margin=0,
                                      device=device)

    idx = {l: i for i, l in enumerate(labels)}
    for i, label in enumerate(assigned):
        if label is None:
            continue
        if label.startswith("1B") and "1B_KIV3" in idx and "1B_KIV2" in idx:
            s3 = scores[i, idx["1B_KIV3"]]
            s2 = scores[i, idx["1B_KIV2"]]
            if abs(int(s3) - int(s2)) < margin:
                counts["1B_tied"] += 1
            elif s3 > s2:
                counts["1B_KIV3"] += 1
            else:
                counts["1B_KIV2"] += 1
        elif label in counts:
            counts[label] += 1
    return counts


def realign_sample(aln_path, chrom, start, end, exon_refs, min_score=30, margin=3,
                   min_mapq=0, ref_fasta=None, device="cuda"):
    """Fetch + classify one sample's window reads. Returns the counts dict.

    Uses the backend-dispatching fetch (native C++ for BAM, cramlite for
    CRAM). ``ref_fasta`` stays None on the realignment path, as in the JAX
    package, so a CRAM that needs its reference cannot be read there.
    """
    from grid_tpu_torch.ingest.alignments import fetch_reads_region

    _, _, _, seqs = fetch_reads_region(
        aln_path, ref_fasta, chrom, start, end, min_mapq=min_mapq
    )
    return classify_window_reads(seqs, exon_refs, min_score, margin, device=device)


def run_realignment(aln_dir, exon_fasta, chrom, start, end, output_file,
                    min_score=30, margin=3, threads=1, console=None, device="cuda"):
    """Realign every BAM/CRAM in a directory; write the 5-column counts file
    (``sample  1B_KIV3  1B_KIV2  1B_tied  1A``, the kiv_io format).

    The device is resolved before any sample is read: without a card,
    ``device="cuda"`` raises here."""
    device = get_device(str(device))
    aln_dir = Path(aln_dir).expanduser()
    exon_refs = read_fasta(exon_fasta)
    bams = sorted(list(aln_dir.glob("*.bam")) + list(aln_dir.glob("*.cram")))
    results: dict[str, dict[str, int]] = {}

    def one(p: Path):
        return p.stem, realign_sample(p, chrom, start, end, exon_refs, min_score, margin,
                                      device=device)

    with progress_bar(console, total=len(bams), description="Realigning") as (progress, task):
        with ThreadPoolExecutor(max_workers=max(1, threads)) as ex:
            futures = [ex.submit(one, p) for p in bams]
            for fut in as_completed(futures):
                try:
                    sid, counts = fut.result()
                    results[sid] = counts
                except Exception as e:
                    # a kernel's or the card's own failure is never logged
                    # away: the samples not yet started are dropped, and it
                    # propagates
                    if is_device_failure(e):
                        for other in futures:
                            other.cancel()
                        raise
                    log(console, f"Realignment failed: {e}", style="danger")
                progress.advance(task)

    output_file = Path(output_file)
    output_file.parent.mkdir(parents=True, exist_ok=True)
    with open(output_file, "w") as f:
        for sid in sorted(results):
            c = results[sid]
            f.write(
                f"{sid}\t{c['1B_KIV3']}\t{c['1B_KIV2']}\t{c['1B_tied']}\t{c['1A']}\n"
            )
    log(console, f"Realignment counts for {len(results)} samples → {output_file}",
        style="success")
    return output_file
