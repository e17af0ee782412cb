"""grid_tpu_torch command-line interface (twin of ``grid_tpu/cli.py``).

Run as ``python -m grid_tpu_torch.cli ...``. Ported so far: ``wgs`` (steps
1-3 on the host from BAM/CRAM files, steps 4-7 fused or in file mode, on
the card unless the config says ``device.platform: cpu``; ``--locus GENE``
takes the window from the VNTR catalog), ``multi-locus`` (the sweep over
catalog genes), ``loci`` (the catalog), the per-step commands of steps 1-7
(``check-index``, ``crai``, ``count-reads``, ``mosdepth``, ``normalize``,
``find-neighbors``, ``compute-dipcn``, ``hi-inference``), ``report``,
``validate``, ``synth`` and ``devices``. ``wes``, ``ibs`` and the alignment
tools wait for the modules behind them.

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
