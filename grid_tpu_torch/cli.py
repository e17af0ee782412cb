"""grid_tpu_torch command-line interface (twin of ``grid_tpu/cli.py``).

Run as ``python -m grid_tpu_torch.cli ...``. Ported so far: ``wgs`` (the
fused steps 4-7; on the card unless the config says ``device.platform:
cpu``), ``validate``, ``synth`` and ``devices``. The per-step subcommands,
``wes``, ``multi-locus``, the alignment tools and ``wgs --locus`` wait for
the modules behind them.

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
def wgs(config, no_validate):
    """Run the WGS pipeline from a YAML CONFIG."""
    console = make_console()
    if console:
        console.print(BANNER, style="info")
    from grid_tpu_torch.pipeline import run_wgs_pipeline

    run_wgs_pipeline(console, config, validate=not no_validate)


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
