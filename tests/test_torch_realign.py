"""The port's exon realignment (``models/realign.py``) against grid_tpu's on
the CPU: the same counts per exon category, and the same counts file byte
for byte from BAMs built as ``tests/test_realign.py`` builds them, on one
and two threads. An unreadable file is logged and skipped, as in grid_tpu;
a kernel's failure inside a worker ends the run. Exact."""

import shutil

import numpy as np
import pytest
import torch

from grid_tpu.io.bamlite import encode_record as jax_encode_record
from grid_tpu.models import realign as jax_realign
from grid_tpu_torch import native
from grid_tpu_torch.io.bamlite import encode_record, write_bam
from grid_tpu_torch.models import realign

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ toolchain")


def _seq(rng, n):
    return "".join(rng.choice(list("ACGT"), size=n))


@pytest.fixture(scope="module")
def exon_world(tmp_path_factory):
    """tests/test_realign.py's exons: 1A and two 1B variants that share a
    backbone, so some reads tie."""
    rng = np.random.default_rng(13)
    base = tmp_path_factory.mktemp("realign")
    backbone = _seq(rng, 120)
    exons = {
        "1A": _seq(rng, 120),
        "1B_KIV3": backbone[:60] + _seq(rng, 10) + backbone[70:],
        "1B_KIV2": backbone[:60] + _seq(rng, 10) + backbone[70:],
    }
    fasta = base / "exons.fa"
    fasta.write_text("".join(f">{name} exon\n{seq[:50]}\n{seq[50:]}\n"
                             for name, seq in exons.items()))
    return base, exons, fasta


def _reads_for(rng, exons, n_per, read_len=50):
    reads = []
    for label in ("1A", "1B_KIV3", "1B_KIV2"):
        seq = exons[label]
        for _ in range(n_per):
            start = int(rng.integers(0, len(seq) - read_len))
            read = list(seq[start:start + read_len])
            read[int(rng.integers(read_len))] = str(rng.choice(list("ACGT")))
            reads.append("".join(read))
    bb = exons["1B_KIV3"][:55]
    for _ in range(n_per):
        start = int(rng.integers(0, 5))
        reads.append(bb[start:start + read_len])
    reads += [_seq(rng, read_len) for _ in range(n_per)]  # unclassified
    reads.append("N" * 10 + reads[0][10:])
    return reads


def _aln_dir(path, rng, exons, samples):
    path.mkdir()
    for sid, n_per in samples:
        reads = _reads_for(rng, exons, n_per)
        recs = [encode_record(0, 1000 + i % 900, 99, read_name=f"{sid}r{i}", seq=s)
                for i, s in enumerate(reads)]
        assert recs[:3] == [jax_encode_record(0, 1000 + i % 900, 99, read_name=f"{sid}r{i}",
                                              seq=s) for i, s in enumerate(reads[:3])]
        recs.sort(key=lambda r: int.from_bytes(r[8:12], "little"))
        write_bam(path / f"{sid}.bam", [("chr6", 10_000)], recs)
    return path


def test_read_fasta_equals_grid_tpu(exon_world):
    _, exons, fasta = exon_world
    assert realign.read_fasta(fasta) == jax_realign.read_fasta(fasta) == exons


@pytest.mark.parametrize("min_score,margin", [(60, 3), (30, 0), (80, 6)])
def test_classify_window_reads_equals_grid_tpu(exon_world, min_score, margin):
    _, exons, _ = exon_world
    reads = _reads_for(np.random.default_rng(min_score + margin), exons, n_per=12)
    got = realign.classify_window_reads(reads, exons, min_score, margin, device="cpu")
    assert got == jax_realign.classify_window_reads(reads, exons, min_score, margin)
    assert got["1A"] and (got["1B_tied"] or margin == 0)  # margin 0 ties nothing


def test_classify_no_reads():
    assert realign.classify_window_reads([], {"1A": "ACGT"}, 10, 3, device="cpu") == \
        dict.fromkeys(realign.EXON_COLUMNS, 0)


@pytest.mark.parametrize("threads", [1, 2])
def test_run_realignment_counts_file_byte_equal(exon_world, tmp_path, threads):
    _, exons, fasta = exon_world
    aln = _aln_dir(tmp_path / "aln", np.random.default_rng(7), exons,
                   [("SAMP1", 12), ("SAMP2", 20), ("SAMP3", 5)])
    got = realign.run_realignment(aln, fasta, "chr6", 0, 10_000, tmp_path / "port.tsv",
                                  min_score=60, margin=3, threads=threads, device="cpu")
    want = jax_realign.run_realignment(aln, fasta, "chr6", 0, 10_000, tmp_path / "jax.tsv",
                                       min_score=60, margin=3, threads=threads)
    assert got.read_bytes() == want.read_bytes()
    assert len(got.read_text().splitlines()) == 3


def test_realign_sample_window_matches_grid_tpu(exon_world, tmp_path):
    _, exons, fasta = exon_world
    aln = _aln_dir(tmp_path / "aln", np.random.default_rng(8), exons, [("W1", 10)])
    for start, end in ((1200, 1500), (0, 1000), (1899, 5000)):
        got = realign.realign_sample(aln / "W1.bam", "chr6", start, end, exons, 60, 3,
                                     device="cpu")
        assert got == jax_realign.realign_sample(aln / "W1.bam", "chr6", start, end, exons,
                                                 60, 3)


class _Lines:
    def __init__(self):
        self.lines = []

    def print(self, msg, style=None):
        self.lines.append((str(msg), style))


def test_an_unreadable_file_is_logged_and_skipped(exon_world, tmp_path):
    _, exons, fasta = exon_world
    aln = _aln_dir(tmp_path / "aln", np.random.default_rng(9), exons, [("OK1", 8)])
    (aln / "BROKEN.bam").write_bytes(b"not a bam at all")
    console = _Lines()
    got = realign.run_realignment(aln, fasta, "chr6", 0, 10_000, tmp_path / "port.tsv",
                                  min_score=60, threads=2, console=console, device="cpu")
    want = jax_realign.run_realignment(aln, fasta, "chr6", 0, 10_000, tmp_path / "jax.tsv",
                                       min_score=60, threads=2)
    assert got.read_bytes() == want.read_bytes()
    assert [sid.split("\t")[0] for sid in got.read_text().splitlines()] == ["OK1"]
    assert any(style == "danger" and "Realignment failed" in msg for msg, style in console.lines)


@pytest.mark.parametrize("error", [native.KernelError("sw_scores kernel launch failed"),
                                   torch.cuda.OutOfMemoryError("out of memory")],
                         ids=["kernel", "device"])
def test_a_kernel_failure_inside_a_worker_propagates(exon_world, tmp_path, monkeypatch, error):
    """A failed build or launch is never logged away as one sample's
    failure: run_realignment raises it and writes no counts file."""
    _, exons, fasta = exon_world
    aln = _aln_dir(tmp_path / "aln", np.random.default_rng(10), exons,
                   [(f"K{i}", 4) for i in range(6)])
    calls = []

    def failing(*args, **kwargs):
        calls.append(1)
        raise error

    monkeypatch.setattr(realign, "classify_reads", failing)
    with pytest.raises(type(error)):
        realign.run_realignment(aln, fasta, "chr6", 0, 10_000, tmp_path / "out.tsv",
                                threads=2, device="cpu")
    assert not (tmp_path / "out.tsv").exists()
    assert calls


def test_realignment_without_a_card_raises_before_reading(exon_world, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    _, _, fasta = exon_world
    read = []
    monkeypatch.setattr(realign, "realign_sample", lambda *a, **k: read.append(1))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        realign.run_realignment(tmp_path, fasta, "chr6", 0, 10, tmp_path / "o.tsv")
    assert not read and not (tmp_path / "o.tsv").exists()
