"""The port's exome (WES) path end to end against grid_tpu's on the CPU:
``run_wes_pipeline`` and the ``wes`` command on the world of
``tests/test_wes_pipeline.py`` (``device: {platform: cpu}``) write the
counts, both exon dipCN files and the KIV-2 estimates byte for byte as
grid_tpu does; ``realign --device cpu``, ``exon-dipcn`` and
``estimate-kiv`` write grid_tpu's files. Without a platform named the
pipeline wants the card and raises before any step. Exact."""

import copy
import shutil

import numpy as np
import pytest
import torch
import yaml
from click.testing import CliRunner

from grid_tpu.cli import cli as jax_cli
from grid_tpu.pipeline import run_wes_pipeline as jax_run_wes_pipeline
from grid_tpu_torch import native
from grid_tpu_torch.cli import cli
from grid_tpu_torch.config import WES_SCHEMA, error_check_config
from grid_tpu_torch.io.bamlite import encode_record, write_bam
from grid_tpu_torch.pipeline import run_wes_pipeline

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ toolchain")

ARTIFACTS = ("exon_counts.tsv", "exon_dipcn.1A.tsv", "exon_dipcn.1B.tsv", "kiv2_estimates.tsv")


def _seq(rng, n):
    return "".join(rng.choice(list("ACGT"), size=n))


@pytest.fixture(scope="module")
def wes_world(tmp_path_factory):
    """tests/test_wes_pipeline.py's world, with a few reads made of N and
    of random bases beside the exon reads."""
    rng = np.random.default_rng(21)
    base = tmp_path_factory.mktemp("wes")
    backbone = _seq(rng, 120)
    exons = {
        "1A": _seq(rng, 120),
        "1B_KIV3": backbone[:60] + _seq(rng, 10) + backbone[70:],
        "1B_KIV2": backbone[:60] + _seq(rng, 10) + backbone[70:],
    }
    fasta = base / "exons.fa"
    fasta.write_text("".join(f">{name}\n{s}\n" for name, s in exons.items()))
    aln = base / "aln"
    aln.mkdir()
    samples = {"WES1": 10, "WES2": 16, "WES3": 22, "WES4": 13}
    for sid, n_per in samples.items():
        reads = []
        for label in ("1A", "1B_KIV3", "1B_KIV2"):
            s = exons[label]
            for _ in range(n_per):
                start = int(rng.integers(0, len(s) - 50))
                reads.append(s[start:start + 50])
        reads += [_seq(rng, 50), "N" * 50, reads[0][:25] + "n" + reads[0][26:]]
        recs = [encode_record(0, int(1000 + i % 900), 99, read_name=f"{sid}r{i}", seq=r)
                for i, r in enumerate(reads)]
        recs.sort(key=lambda r: int.from_bytes(r[8:12], "little"))
        write_bam(aln / f"{sid}.bam", [("chr6", 10_000)], recs)
    samples_file = base / "samples.txt"
    samples_file.write_text("".join(f"{s}\n" for s in samples))
    nbr_file = base / "nbrs.tsv"
    ids = list(samples)
    with open(nbr_file, "w") as f:
        for sid in ids:
            row = [sid, "1.00"]
            for o in (x for x in ids if x != sid):
                row += [o, f"{rng.uniform(0.8, 1.2):.2f}", "0.10"]
            f.write("\t".join(row) + "\n")
    config = {
        "samples_file": str(samples_file), "directory_loc": str(aln),
        "reference_genome": str(samples_file), "output_dir": str(base / "results"),
        "threads": 2, "file_type": "bam", "chrom": "chr6", "start_bp": 0, "end_bp": 10_000,
        "output_file_type": "tsv", "index": {"run": False},
        "realign": {"run": True, "exon_fasta": str(fasta), "min_score": 60,
                    "output_file_prefix": "exon_counts"},
        "exon_dipcn": {"run": True, "neighbors_file": str(nbr_file), "n_neighbors": 5,
                       "output_file_prefix": "exon_dipcn"},
        "estimate_kiv": {"run": True, "output_file_prefix": "kiv2_estimates"},
    }
    return base, config, fasta, nbr_file


def _configs(config, out, cpu=True):
    """(port's config, grid_tpu's config) writing under ``out``."""
    port, jax = copy.deepcopy(config), copy.deepcopy(config)
    port["output_dir"], jax["output_dir"] = str(out / "port"), str(out / "jax")
    if cpu:
        port["device"] = {"platform": "cpu"}
    return port, jax


def _same_artifacts(out):
    for name in ARTIFACTS:
        got, want = (out / "port" / name).read_bytes(), (out / "jax" / name).read_bytes()
        assert got == want, name
        assert got


def test_run_wes_pipeline_byte_equal_to_grid_tpu(wes_world, tmp_path):
    _, config, _, _ = wes_world
    port, jax = _configs(config, tmp_path)
    timings = run_wes_pipeline(config=port)
    assert {"realign", "exon_dipcn", "estimate_kiv"} <= set(timings)
    jax_run_wes_pipeline(config=jax)
    _same_artifacts(tmp_path)
    assert (tmp_path / "port" / "step_timings.json").exists()
    rows = (tmp_path / "port" / "exon_counts.tsv").read_text().splitlines()
    assert [r.split("\t")[0] for r in rows] == ["WES1", "WES2", "WES3", "WES4"]


def test_wes_command_byte_equal_to_grid_tpu(wes_world, tmp_path):
    _, config, _, _ = wes_world
    port, jax = _configs(config, tmp_path)
    for group, cfg, name in ((cli, port, "port.yaml"), (jax_cli, jax, "jax.yaml")):
        path = tmp_path / name
        path.write_text(yaml.safe_dump(cfg, sort_keys=False))
        res = CliRunner().invoke(group, ["wes", str(path)])
        assert res.exit_code == 0, res.output
    _same_artifacts(tmp_path)


@pytest.mark.parametrize("device", [None, {}, {"platform": "auto"}, {"platform": "cuda"}],
                         ids=["absent", "empty", "auto", "cuda"])
def test_without_a_platform_the_pipeline_wants_the_card(wes_world, tmp_path, device,
                                                         monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    import grid_tpu_torch.steps.index as index

    _, config, _, _ = wes_world
    port, _ = _configs(config, tmp_path, cpu=False)
    port["index"] = {"run": True}
    if device is not None:
        port["device"] = device
    ran = []
    monkeypatch.setattr(index, "create_index", lambda *a, **k: ran.append(1))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_wes_pipeline(config=port)
    assert not ran and not (tmp_path / "port").exists()
    path = tmp_path / "port.yaml"
    path.write_text(yaml.safe_dump(port, sort_keys=False))
    res = CliRunner().invoke(cli, ["wes", str(path)])
    assert res.exit_code != 0 and "CUDA is not available" in str(res.exception)


def test_later_steps_need_no_card(wes_world, tmp_path):
    """With realign off, exon dipCN and the estimate read the counts file
    and run on the host, whatever the platform."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    _, config, _, _ = wes_world
    port, jax = _configs(config, tmp_path)
    jax_run_wes_pipeline(config=jax)
    (tmp_path / "port").mkdir()
    shutil.copy(tmp_path / "jax" / "exon_counts.tsv", tmp_path / "port" / "exon_counts.tsv")
    port["realign"]["run"] = False
    del port["device"]
    run_wes_pipeline(config=port)
    _same_artifacts(tmp_path)


def test_a_kernel_failure_ends_the_pipeline(wes_world, tmp_path, monkeypatch):
    """A KernelError in the realignment propagates out of run_wes_pipeline
    and the wes command fails, where other step failures are logged."""
    import grid_tpu_torch.models.realign as realign

    _, config, _, _ = wes_world
    port, _ = _configs(config, tmp_path)

    def failing(*args, **kwargs):
        raise native.KernelError("sw_scores kernel launch failed: cudaError 700")

    monkeypatch.setattr(realign, "classify_reads", failing)
    with pytest.raises(native.KernelError):
        run_wes_pipeline(config=port)
    assert not (tmp_path / "port" / "kiv2_estimates.tsv").exists()
    path = tmp_path / "port.yaml"
    path.write_text(yaml.safe_dump(port, sort_keys=False))
    res = CliRunner().invoke(cli, ["wes", str(path)])
    assert res.exit_code != 0 and isinstance(res.exception, native.KernelError)


def test_a_failing_step_is_logged_and_the_next_runs(wes_world, tmp_path):
    """grid_tpu's semantics for other failures: no alignments, so realign
    writes an empty counts file, exon dipCN fails (no overlap) and is
    logged, and the estimate fails on its missing inputs."""
    _, config, _, _ = wes_world
    port, jax = _configs(config, tmp_path)
    (tmp_path / "empty").mkdir()
    for cfg in (port, jax):
        cfg["directory_loc"] = str(tmp_path / "empty")
    assert isinstance(run_wes_pipeline(config=port), dict)
    jax_run_wes_pipeline(config=jax)
    for name in ARTIFACTS:
        assert (tmp_path / "port" / name).exists() == (tmp_path / "jax" / name).exists()
    assert not (tmp_path / "port" / "kiv2_estimates.tsv").exists()


def test_wes_config_validation_equals_grid_tpu(wes_world, tmp_path):
    from grid_tpu.config import WES_SCHEMA as JAX_WES_SCHEMA
    from grid_tpu.config import error_check_config as jax_error_check_config

    _, config, _, _ = wes_world
    bad = copy.deepcopy(config)
    bad["realign"]["exon_fasta"] = str(tmp_path / "missing.fa")
    with pytest.raises(ValueError, match="config error") as got:
        error_check_config(bad, None, schema=WES_SCHEMA)
    with pytest.raises(ValueError, match="config error") as want:
        jax_error_check_config(bad, None, schema=JAX_WES_SCHEMA)
    assert str(got.value) == str(want.value)
    bad["realign"]["run"] = False  # gated off: the missing file is no error
    error_check_config(bad, None, schema=WES_SCHEMA)


def test_realign_exon_dipcn_estimate_commands_equal_grid_tpu(wes_world, tmp_path):
    _, config, fasta, nbrs = wes_world
    outs = {}
    for name, group, extra in (("port", cli, ["--device", "cpu"]), ("jax", jax_cli, [])):
        out = tmp_path / name
        out.mkdir()
        runner = CliRunner()
        res = runner.invoke(group, ["realign", "-C", config["directory_loc"], "--exon-fasta",
                                    str(fasta), "-c", "chr6", "-s", "0", "-e", "10000", "-o",
                                    str(out / "counts.tsv"), "--min-score", "60", "--margin",
                                    "3", "-t", "2", *extra])
        assert res.exit_code == 0, res.output
        for exon in ("1A", "1B", "1B_KIV3", "1B_notKIV3"):
            res = runner.invoke(group, ["exon-dipcn", "--counts", str(out / "counts.tsv"),
                                        "--neighbors", str(nbrs), "--exon-type", exon, "-o",
                                        str(out / f"dip.{exon}.tsv"), "--n-neighbors", "2"])
            assert res.exit_code == 0, res.output
        res = runner.invoke(group, ["estimate-kiv", "--exon1a", str(out / "dip.1A.tsv"),
                                    "--exon1b", str(out / "dip.1B.tsv"), "-o",
                                    str(out / "kiv.tsv")])
        assert res.exit_code == 0, res.output
        outs[name] = {p.name: p.read_bytes() for p in sorted(out.iterdir())}
    assert outs["port"] == outs["jax"] and len(outs["port"]) == 6


def test_command_errors_equal_grid_tpu(wes_world, tmp_path):
    _, _, _, nbrs = wes_world
    counts = tmp_path / "counts.tsv"
    counts.write_text("NOBODY\t1\t2\t3\t4\n")
    a, b = tmp_path / "a.tsv", tmp_path / "b.tsv"
    a.write_text("ID\tdipCN\nA\t1.0\n")
    b.write_text("ID\tdipCN\nB\t1.0\n")
    for group in (cli, jax_cli):
        res = CliRunner().invoke(group, ["exon-dipcn", "--counts", str(counts), "--neighbors",
                                         str(nbrs), "--exon-type", "1A", "-o",
                                         str(tmp_path / "o.tsv")])
        assert res.exit_code == 1 and "No overlapping samples" in res.output
        res = CliRunner().invoke(group, ["estimate-kiv", "--exon1a", str(a), "--exon1b", str(b),
                                         "-o", str(tmp_path / "k.tsv")])
        assert res.exit_code == 1 and "No overlapping samples" in res.output


def test_realign_command_wants_the_card_by_default(wes_world, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    _, config, fasta, _ = wes_world
    res = CliRunner().invoke(cli, ["realign", "-C", config["directory_loc"], "--exon-fasta",
                                   str(fasta), "-c", "chr6", "-s", "0", "-e", "10000", "-o",
                                   str(tmp_path / "c.tsv")])
    assert res.exit_code != 0 and "CUDA is not available" in str(res.exception)
    assert not (tmp_path / "c.tsv").exists()
