"""The port's ``io/fasta.py`` (extract-reference) against grid_tpu's on the
same genomes and BEDs: byte-identical output FASTA with and without a
``.fai`` index, from a gzip genome, with BED names and headers, and the
same errors for malformed input. Host only; exact."""

import gzip

import numpy as np
import pytest
from click.testing import CliRunner

from grid_tpu.cli import cli as jax_cli
from grid_tpu.io import fasta as jax_fasta
from grid_tpu_torch.cli import cli
from grid_tpu_torch.io import fasta


def _genome(path, contigs, width=7, gz=False):
    """A FASTA with an awkward line width (exercises the .fai arithmetic)."""
    text = "".join(f">{name} description\n" + "".join(
        seq[i:i + width] + "\n" for i in range(0, len(seq), width))
        for name, seq in contigs.items())
    if gz:
        with gzip.open(path, "wt") as f:
            f.write(text)
    else:
        path.write_text(text)
    return path


def _fai(fa_path, contigs, width=7):
    """samtools faidx layout: name, length, offset, linebases, linewidth."""
    data, pos, lines = fa_path.read_bytes(), 0, []
    for name, seq in contigs.items():
        offset = data.index(b"\n", pos) + 1
        lines.append(f"{name}\t{len(seq)}\t{offset}\t{width}\t{width + 1}")
        pos = offset + len(seq) + -(-len(seq) // width)
    (fa_path.parent / (fa_path.name + ".fai")).write_text("\n".join(lines) + "\n")


@pytest.fixture()
def contigs():
    rng = np.random.default_rng(5)
    return {"chr1": "".join(rng.choice(list("ACGT"), 101)),
            "chr2": "".join(rng.choice(list("ACGTN"), 53)),
            "chr6": "".join(rng.choice(list("acgtACGT"), 240))}


BED = ("# a header\ntrack name=x\nchr1\t0\t10\t1A\nchr1\t95\t200\tpast_end\n"
       "chr6\t100\t182\t1B_KIV3\nchr2\t5\t5\tempty\nchr6\t30\t97\n")


def _both(tmp_path, reference, bed, **kw):
    """Each package's output bytes for one extraction."""
    got = fasta.extract_reference(reference, bed, tmp_path / "port", **kw)
    want = jax_fasta.extract_reference(reference, bed, tmp_path / "jax", **kw)
    assert got.name == want.name
    return got.read_bytes(), want.read_bytes()


@pytest.mark.parametrize("route", ["streamed", "fai", "gzip", "gzip-with-fai"])
def test_extract_reference_byte_equal(tmp_path, contigs, route):
    gz = route.startswith("gzip")
    reference = _genome(tmp_path / ("ref.fa.gz" if gz else "ref.fa"), contigs, gz=gz)
    if route == "fai":
        _fai(reference, contigs)
    if route == "gzip-with-fai":  # a .fai beside a gzip genome is not used
        (tmp_path / "ref.fa.gz.fai").write_text("chr1\t1\t0\t1\t2\n")
    bed = tmp_path / "r.bed"
    bed.write_text(BED)
    got, want = _both(tmp_path, reference, bed, output_prefix="exons", line_width=13)
    assert got == want
    assert got.startswith(b">1A\n")


def test_extract_reference_gzip_bed(tmp_path, contigs):
    reference = _genome(tmp_path / "ref.fa", contigs)
    bed = tmp_path / "r.bed.gz"
    with gzip.open(bed, "wt") as f:
        f.write(BED)
    got, want = _both(tmp_path, reference, bed)
    assert got == want


@pytest.mark.parametrize("text,match", [
    ("chr1\t0\n", ">=3 columns"),
    ("chr1\tx\t10\n", "non-integer"),
    ("chr1\t10\t5\n", "invalid interval"),
    ("# only a comment\n", "No regions"),
])
def test_malformed_bed_raises_as_grid_tpu(tmp_path, contigs, text, match):
    reference = _genome(tmp_path / "ref.fa", contigs)
    bed = tmp_path / "bad.bed"
    bed.write_text(text)
    with pytest.raises(ValueError, match=match) as got:
        fasta.extract_reference(reference, bed, tmp_path / "port")
    with pytest.raises(ValueError, match=match) as want:
        jax_fasta.extract_reference(reference, bed, tmp_path / "jax")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("with_fai", [False, True], ids=["streamed", "fai"])
def test_missing_contig_raises_as_grid_tpu(tmp_path, contigs, with_fai):
    reference = _genome(tmp_path / "ref.fa", contigs)
    if with_fai:
        _fai(reference, contigs)
    bed = tmp_path / "r.bed"
    bed.write_text("chr1\t0\t5\nchrX\t0\t5\n")
    with pytest.raises(ValueError) as got:
        fasta.extract_reference(reference, bed, tmp_path / "port")
    with pytest.raises(ValueError) as want:
        jax_fasta.extract_reference(reference, bed, tmp_path / "jax")
    assert str(got.value) == str(want.value)


def test_helpers_equal_grid_tpu(tmp_path, contigs):
    reference = _genome(tmp_path / "ref.fa.gz", contigs, gz=True)
    assert list(fasta.iter_fasta_contigs(reference)) == \
        list(jax_fasta.iter_fasta_contigs(reference))
    bed = tmp_path / "r.bed"
    bed.write_text(BED)
    assert fasta.read_bed_regions(bed) == jax_fasta.read_bed_regions(bed)


def test_extract_reference_cli_equals_grid_tpu(tmp_path, contigs):
    reference = _genome(tmp_path / "ref.fa", contigs)
    _fai(reference, contigs)
    bed = tmp_path / "r.bed"
    bed.write_text(BED)
    outs = {}
    for name, group in (("port", cli), ("jax", jax_cli)):
        res = CliRunner().invoke(group, ["extract-reference", "-r", str(reference), "-b", str(bed),
                                         "-o", str(tmp_path / name), "-f", "lpa"])
        assert res.exit_code == 0, res.output
        outs[name] = (tmp_path / name / "lpa.fa").read_bytes()
    assert outs["port"] == outs["jax"]
    bad = tmp_path / "bad.bed"
    bad.write_text("chr1\t0\n")
    res = CliRunner().invoke(cli, ["extract-reference", "-r", str(reference), "-b", str(bad),
                                   "-o", str(tmp_path / "x")])
    assert res.exit_code == 1
