"""grid_tpu_torch command-line interface (twin of ``grid_tpu/cli.py``).

Run as ``python -m grid_tpu_torch.cli ...``. Ported so far: ``wgs`` (steps
1-3 on the host from BAM/CRAM files, steps 4-7 fused or in file mode, on
the card unless the config says ``device.platform: cpu``; ``--locus GENE``
takes the window from the VNTR catalog), ``multi-locus`` (the sweep over
catalog genes), ``loci`` (the catalog), the per-step commands of steps 1-7
(``check-index``, ``crai``, ``count-reads``, ``mosdepth``, ``normalize``,
``find-neighbors``, ``compute-dipcn``, ``hi-inference``), the exome path
(``wes``, on the card unless ``device.platform: cpu``; ``realign``, on the
card unless ``--device cpu``; ``exon-dipcn``, ``estimate-kiv``,
``extract-reference``), ``ibs`` (IBS haplotype neighbors from a phased
panel, on the host), the alignment tools (``subset``, ``batch-subset``,
``batch-crai``, ``add-gen-map``), ``report``, ``validate``, ``synth`` and
``devices``.

``click`` is needed by this module only.
"""

from __future__ import annotations

import sys

import click

from grid_tpu_torch import __version__
from grid_tpu_torch.utils.logging import log, make_console

BANNER = r"""
   ____ ____  _ ____        _____ ___  ____   ____ _   _
  / ___|  _ \(_)  _ \      |_   _/ _ \|  _ \ / ___| | | |
 | |  _| |_) | | | | |_____  | || | | | |_) | |   | |_| |
 | |_| |  _ <| | |_| |_____| | || |_| |  _ <| |___|  _  |
  \____|_| \_\_|____/        |_| \___/|_| \_\\____|_| |_|

  VNTR copy-number inference on NVIDIA Hopper
"""


@click.group(context_settings=dict(help_option_names=["-h", "--help"]))
@click.version_option(package_name=None, version=__version__)
def cli():
    """grid_tpu_torch — haplotype-resolved VNTR copy-number estimation, the
    PyTorch/CUDA port of grid_tpu."""


@cli.command()
@click.argument("config", type=click.Path(exists=True))
@click.option("--no-validate", is_flag=True, help="Skip config validation (reference parity).")
@click.option("--locus", default=None, metavar="GENE",
              help="Take the VNTR window from the bundled 734-region catalog "
                   "(overrides chrom/start_bp/end_bp), e.g. LPA.")
@click.option("--catalog", default=None, type=click.Path(exists=True),
              help="Another VNTR catalog table for --locus.")
def wgs(config, no_validate, locus, catalog):
    """Run the WGS pipeline from a YAML CONFIG."""
    console = make_console()
    if console:
        console.print(BANNER, style="info")
    from grid_tpu_torch.config import load_config
    from grid_tpu_torch.pipeline import run_wgs_pipeline

    cfg = load_config(config)
    if locus:
        from grid_tpu_torch.data.loci import resolve_locus

        try:
            hit = resolve_locus(locus, catalog)
        except KeyError as e:
            raise click.ClickException(str(e))
        cfg["chrom"], cfg["start_bp"], cfg["end_bp"] = hit.chrom, hit.start, hit.end
        log(console, f"Locus {locus}: {hit.chrom}:{hit.start:,}-{hit.end:,} "
                     f"(catalog gene {hit.gene})", style="info")
    run_wgs_pipeline(console, cfg, validate=not no_validate)


@cli.command(name="multi-locus")
@click.argument("config", type=click.Path(exists=True))
@click.option("--locus", "loci", multiple=True, required=True, metavar="GENE",
              help="Catalog gene to sweep (repeatable).")
@click.option("--catalog", default=None, type=click.Path(exists=True),
              help="Another VNTR catalog table.")
def multi_locus(config, loci, catalog):
    """Sweep many VNTR loci in one run: the locus-independent cohort steps
    (normalize, kNN) run once; dipCN (one batched device call) and phasing
    repeat per locus with .GENE-suffixed artifacts."""
    console = make_console()
    if console:
        console.print(BANNER, style="info")
    from grid_tpu_torch.steps.multilocus import run_multi_locus

    run_multi_locus(config, list(loci), console, catalog)


@cli.command(name="loci")
@click.option("--gene", default=None, help="Filter by (sub)string match.")
@click.option("--catalog", default=None, type=click.Path(exists=True))
@click.option("--limit", default=20, show_default=True, type=int)
def loci_cmd(gene, catalog, limit):
    """List or search the bundled 734-region VNTR catalog (Mukamel 2021)."""
    from grid_tpu_torch.data.loci import load_vntr_catalog

    table = load_vntr_catalog(catalog)
    if gene:
        table = [locus for locus in table if gene.lower() in locus.gene.lower()]
    for locus in table[:limit]:
        click.echo(f"{locus.gene}\t{locus.chrom}:{locus.start}-{locus.end}")
    if len(table) > limit:
        click.echo(f"... {len(table) - limit} more (raise --limit)")


@cli.command()
@click.argument("config", type=click.Path(exists=True))
@click.option("--no-validate", is_flag=True, help="Skip config validation.")
def wes(config, no_validate):
    """Run the exome (WES) KIV-2 pipeline from a YAML CONFIG: exon
    realignment -> per-exon dipCN -> KIV-2 estimates (on the card unless
    the config says device.platform: cpu)."""
    console = make_console()
    if console:
        console.print(BANNER, style="info")
    from grid_tpu_torch.pipeline import run_wes_pipeline

    run_wes_pipeline(console, config, validate=not no_validate)


def _step_command(name, help_text, import_path):
    """Register a command that runs one pipeline step from CONFIG (defaults
    applied, not validated), as grid_tpu's CLI does."""

    @cli.command(name=name, help=help_text)
    @click.argument("config", type=click.Path(exists=True))
    def _cmd(config):
        import importlib

        from grid_tpu_torch.config import apply_defaults, load_config

        module_name, fn_name = import_path
        fn = getattr(importlib.import_module(module_name), fn_name)
        fn(apply_defaults(load_config(config)), make_console())

    _cmd.__name__ = name.replace("-", "_")
    return _cmd


_step_command("check-index", "Check CRAI/BAI indexes for all samples.",
              ("grid_tpu_torch.steps.index", "check_index"))
_step_command("crai", "Create missing CRAI/BAI indexes.",
              ("grid_tpu_torch.steps.index", "create_index"))
_step_command("count-reads", "Count VNTR-window reads per sample.",
              ("grid_tpu_torch.steps.count_reads", "count_reads"))
_step_command("mosdepth", "Compute genome-binned coverage per sample.",
              ("grid_tpu_torch.steps.coverage", "compute_mosdepth"))
_step_command("normalize", "Normalize the cohort coverage matrix.",
              ("grid_tpu_torch.steps.normalize", "normalize_mosdepth"))
_step_command("find-neighbors", "Find depth-matched nearest neighbors.",
              ("grid_tpu_torch.steps.neighbors", "find_neighbors"))
_step_command("compute-dipcn", "Compute neighbor-normalized diploid CN.",
              ("grid_tpu_torch.steps.dipcn", "compute_diploid_genotypes"))
_step_command("hi-inference", "Infer haplotype copy numbers (IBS/IBD).",
              ("grid_tpu_torch.steps.haploid", "hi_inference"))


@cli.command()
@click.option("--exon1a", required=True, type=click.Path(exists=True), help="exon1A dipCN TSV")
@click.option("--exon1b", required=True, type=click.Path(exists=True), help="exon1B dipCN TSV")
@click.option("-o", "--output", required=True, type=click.Path(), help="output TSV")
def estimate_kiv(exon1a, exon1b, output):
    """KIV2 CN estimates from exon dipCNs: 34.9*exon1A + 5.2*exon1B - 1."""
    from grid_tpu_torch.models.kiv import estimate_kiv_files

    try:
        n = estimate_kiv_files(exon1a, exon1b, output)
    except ValueError as e:
        raise click.ClickException(str(e))
    log(make_console(), f"KIV2 estimates for {n} samples → {output}", style="success")


@cli.command(name="extract-reference")
@click.option("-r", "--reference-fa", required=True, type=click.Path(exists=True),
              help="Reference genome FASTA (e.g. hs37d5.fa; .fai used if present)")
@click.option("-b", "--bed-file", required=True, type=click.Path(exists=True),
              help="BED of regions to extract (4th column names the records)")
@click.option("-o", "--output-dir", required=True, type=click.Path())
@click.option("-f", "--output-prefix", default="ref_lpa", show_default=True)
def extract_reference_cmd(reference_fa, bed_file, output_dir, output_prefix):
    """Cut BED regions out of a reference genome into a small FASTA: the
    exon-reference prep for ``realign``/``wes`` (a BED whose names are
    1A/1B_KIV2/1B_KIV3 yields a realign-ready exon FASTA)."""
    from grid_tpu_torch.io.fasta import extract_reference

    console = make_console()
    try:
        extract_reference(reference_fa, bed_file, output_dir, output_prefix, console=console)
    except Exception as e:
        log(console, f"✗ Reference extraction failed: {e}", style="danger")
        sys.exit(1)


@cli.command()
@click.option("-C", "--aln-dir", required=True, type=click.Path(exists=True))
@click.option("--exon-fasta", required=True, type=click.Path(exists=True),
              help="FASTA of exon references (headers: 1A, 1B_KIV3, 1B_KIV2)")
@click.option("-c", "--chrom", required=True)
@click.option("-s", "--start", required=True, type=int)
@click.option("-e", "--end", required=True, type=int)
@click.option("-o", "--output", required=True, type=click.Path())
@click.option("--min-score", default=30, show_default=True, type=int)
@click.option("--margin", default=3, show_default=True, type=int)
@click.option("-t", "--threads", default=1, type=int)
@click.option("--device", default="cuda", show_default=True, type=click.Choice(["cuda", "cpu"]),
              help="Where the Smith-Waterman scores run.")
def realign(aln_dir, exon_fasta, chrom, start, end, output, min_score, margin, threads, device):
    """Re-score window reads against exon references (Smith-Waterman, the
    hand kernel on the card); writes the 5-column exon counts file."""
    from grid_tpu_torch.models.realign import run_realignment

    run_realignment(aln_dir, exon_fasta, chrom, start, end, output,
                    min_score, margin, threads, make_console(), device=device)


@cli.command(name="exon-dipcn")
@click.option("--counts", required=True, type=click.Path(exists=True), help="5-col exon counts")
@click.option("--neighbors", "neighbors_file", required=True, type=click.Path(exists=True))
@click.option("--exon-type", required=True,
              type=click.Choice(["1B_KIV3", "1B_notKIV3", "1B", "1A"]))
@click.option("-o", "--output", required=True, type=click.Path())
@click.option("--n-neighbors", default=200, show_default=True, type=int)
def exon_dipcn(counts, neighbors_file, exon_type, output, n_neighbors):
    """Per-exon diploid CN from realignment counts + neighbor file (the
    legacy exon path feeding estimate-kiv)."""
    from grid_tpu_torch.models.kiv import compute_dipcn_for_exon
    from grid_tpu_torch.models.kiv_io import (
        load_count_results,
        load_neighbor_results,
        validate_sample_overlap,
        write_dipcn_output,
    )

    console = make_console()
    cnts = load_count_results(counts)
    nbrs = load_neighbor_results(neighbors_file)
    n_overlap, _ = validate_sample_overlap(cnts, nbrs, console)
    if n_overlap == 0:
        raise click.ClickException("No overlapping samples between counts and neighbors")
    res = compute_dipcn_for_exon(cnts, nbrs, exon_type, n_neighbors)
    write_dipcn_output(res, output)
    log(console, f"{exon_type} dipCN for {len(res)} samples → {output}", style="success")


@cli.command()
@click.argument("results_dir", type=click.Path(exists=True))
@click.option("--dipcn-prefix", default="diploid_genotypes", show_default=True)
@click.option("--haploid-prefix", default="haploid_genotypes", show_default=True)
def report(results_dir, dipcn_prefix, haploid_prefix):
    """Summarize a finished run: cohort size, dipCN distribution, phasing
    coverage."""
    from pathlib import Path

    import numpy as np

    from grid_tpu_torch.io.formats import read_dipcn

    console = make_console()
    results = Path(results_dir)
    dip_file = results / f"{dipcn_prefix}.tsv"
    if dip_file.exists():
        ids, vals, _ = read_dipcn(dip_file)
        v = np.asarray(vals)
        log(console, f"dipCN: n={len(ids)}  mean={v.mean():.3f}  sd={v.std():.3f}  "
                     f"min={v.min():.3f}  max={v.max():.3f}")
    else:
        log(console, f"no dipCN file at {dip_file}", style="warning")

    hap_file = results / f"{haploid_prefix}.tsv"
    if hap_file.exists():
        lines = hap_file.read_text().splitlines()[1:]
        n = len(lines)
        phased = imp_only = 0
        h1s, h2s = [], []
        for line in lines:
            p = line.split("\t")
            h1, h2 = float(p[2]), float(p[3])
            if np.isnan(h1) or np.isnan(h2):
                imp_only += 1
            else:
                phased += 1
                h1s.append(h1)
                h2s.append(h2)
        log(console, f"haploid: n={n}  phased={phased} ({100 * phased / max(n, 1):.1f}%)  "
                     f"imputation-only={imp_only}")
        if h1s:
            alloc = np.asarray(h1s) / (np.asarray(h1s) + np.asarray(h2s)).clip(1e-9)
            log(console, f"hap1 allocation: mean={alloc.mean():.3f}  sd={alloc.std():.3f}")
    else:
        log(console, f"no haploid file at {hap_file}", style="warning")

    timings = results / "step_timings.json"
    if timings.exists():
        log(console, f"timings: {timings.read_text().strip()}")


@cli.command()
@click.argument("config", type=click.Path(exists=True))
def validate(config):
    """Validate a config file without running anything."""
    from grid_tpu_torch.config import error_check_config, load_config

    console = make_console()
    try:
        error_check_config(load_config(config), console)
    except ValueError as e:
        raise click.ClickException(str(e))
    log(console, "Config OK", style="success")


@cli.command()
@click.option("--out", required=True, type=click.Path(), help="output directory")
@click.option("-n", "--n-samples", default=12, type=int, show_default=True)
@click.option("--seed", default=0, type=int, show_default=True)
@click.option("--missing-frac", default=0.0, type=float, show_default=True)
def synth(out, n_samples, seed, missing_frac):
    """Fabricate a synthetic cohort (bed.gz + counts + IBS/IBD + config)."""
    from grid_tpu_torch.synth import make_synthetic_cohort

    res = make_synthetic_cohort(out, n_samples=n_samples, seed=seed, missing_frac=missing_frac)
    console = make_console()
    log(console, f"Synthetic cohort of {n_samples} samples → {out}", style="success")
    log(console, f"Config: {res['config_file']}", style="info")


@cli.command()
@click.option("-a", "--aln", required=True, type=click.Path(exists=True), help="BAM/CRAM file")
@click.option("-c", "--chrom", required=True)
@click.option("-s", "--start", required=True, type=int)
@click.option("-e", "--end", required=True, type=int)
@click.option("-o", "--output", required=True, type=click.Path())
@click.option("-R", "--reference", type=click.Path(exists=True), help="FASTA (CRAM only)")
@click.option("--embed-reference", is_flag=True,
              help="CRAM output: store each slice's reference window in the "
                   "file so it decodes without the FASTA")
def subset(aln, chrom, start, end, output, reference, embed_reference):
    """Extract the reads of a region into a new BAM/CRAM."""
    from grid_tpu_torch.tools import subset_alignment

    console = make_console()
    n = subset_alignment(aln, chrom, start, end, output, reference,
                         embed_reference=embed_reference, console=console)
    log(console, f"Wrote {n} records → {output}", style="success")


@cli.command(name="batch-subset")
@click.option("-C", "--aln-dir", required=True, type=click.Path(exists=True))
@click.option("-c", "--chrom", required=True)
@click.option("-s", "--start", required=True, type=int)
@click.option("-e", "--end", required=True, type=int)
@click.option("-o", "--output-dir", required=True, type=click.Path())
@click.option("-R", "--reference", type=click.Path(exists=True))
@click.option("-t", "--threads", default=1, type=int)
def batch_subset_cmd(aln_dir, chrom, start, end, output_dir, reference, threads):
    """Subset every alignment file in a directory to a region."""
    from grid_tpu_torch.tools import batch_subset

    console = make_console()
    res = batch_subset(aln_dir, chrom, start, end, output_dir, reference, threads, console)
    ok = sum(1 for v in res.values() if v is not None)
    log(console, f"Subset {ok}/{len(res)} files → {output_dir}", style="success")


@cli.command(name="batch-crai")
@click.option("-C", "--aln-dir", required=True, type=click.Path(exists=True))
@click.option("-R", "--reference", type=click.Path(exists=True))
@click.option("-t", "--threads", default=1, type=int)
def batch_crai(aln_dir, reference, threads):
    """Create missing BAI/CRAI indexes for every file in a directory."""
    from grid_tpu_torch.tools import batch_ensure_index

    console = make_console()
    res = batch_ensure_index(aln_dir, reference, threads, console)
    log(console, f"Indexed {sum(res.values())}/{len(res)} files", style="success")


@cli.command(name="add-gen-map")
@click.option("--map", "map_file", required=True, type=click.Path(exists=True), help="PLINK MAP")
@click.option("--genetic-map", required=True, type=click.Path(exists=True), help="Eagle genetic map")
@click.option("--out", required=True, help="output prefix")
def add_gen_map(map_file, genetic_map, out):
    """Interpolate cM onto a PLINK MAP (computeIBSpbwt input prep)."""
    from grid_tpu_torch.tools import add_genetic_map

    log(make_console(), f"Wrote {add_genetic_map(map_file, genetic_map, out)}", style="success")


@cli.command()
@click.option("--vcf", type=click.Path(exists=True), help="phased VCF(.gz) panel")
@click.option("--bgen", type=click.Path(exists=True), help="phased BGEN v1.2 panel")
@click.option("--sample", "sample_file", type=click.Path(exists=True),
              help="Oxford .sample file (BGEN without embedded IDs)")
@click.option("-c", "--chrom", help="restrict the panel to one chromosome")
@click.option("--focal-bp", required=True, type=int, help="focal position (bp)")
@click.option("--genetic-map", type=click.Path(exists=True),
              help="Eagle genetic map (else uniform 1 cM/Mb)")
@click.option("-k", "--num-neighbors", default=200, show_default=True, type=int)
@click.option("-t", "--threads", default=1, show_default=True, type=int)
@click.option("-o", "--output", required=True, type=click.Path(),
              help="neighbors file (.gz => gzip)")
@click.option("--backend", default="auto", show_default=True,
              type=click.Choice(["auto", "native", "numpy"]))
@click.option("--max-scan", default=None, type=int,
              help="per-side PBWT expansion cap (default max(4k, k+64)); "
                   "raise if the engine logs that the cap was hit")
def ibs(vcf, bgen, sample_file, chrom, focal_bp, genetic_map, num_neighbors,
        threads, output, backend, max_scan):
    """IBS haplotype neighbors from a phased panel (native PBWT engine on
    the host; replaces the reference's external computeIBSpbwt tool, same
    output format, read directly by hi-inference)."""
    from grid_tpu_torch.steps.ibs import compute_ibs_neighbors

    if (vcf is None) == (bgen is None):
        raise click.ClickException("pass exactly one of --vcf / --bgen")
    compute_ibs_neighbors(
        output=output, focal_bp=focal_bp, vcf=vcf, bgen=bgen,
        sample_file=sample_file, chrom=chrom, genetic_map=genetic_map,
        num_neighbors=num_neighbors, threads=threads, max_scan=max_scan,
        backend=backend, console=make_console(),
    )


@cli.command()
def devices():
    """Show the CUDA devices PyTorch sees on this host."""
    import torch

    console = make_console()
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    log(console, f"backend: torch {torch.__version__}, CUDA {torch.version.cuda}, {n} device(s)")
    for i in range(n):
        props = torch.cuda.get_device_properties(i)
        log(console, f"  {i}: {props.name} ({props.total_memory / 2**30:.0f} GiB, "
                     f"compute capability {props.major}.{props.minor})")


def main():
    try:
        cli()
    except KeyboardInterrupt:
        sys.exit(130)


if __name__ == "__main__":
    main()
