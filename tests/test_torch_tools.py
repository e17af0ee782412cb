"""The port's alignment tools against grid_tpu's, on the CPU.

``add_genetic_map`` writes grid_tpu's MAP file; ``subset_alignment`` on a
BAM (the host library's subsetter) and on a CRAM in verbatim mode (cramlite
read, the host library's writer) writes grid_tpu's bytes, and with
``embed_reference`` (cramlite's writer) a file that decodes without the
FASTA to grid_tpu's records; ``batch_subset`` and ``batch_ensure_index``
give grid_tpu's results and files; a failing native CRAM writer is counted
in ``native_host.fallbacks["cram_write"]`` and logged; and the ``subset``,
``batch-subset``, ``batch-crai`` and ``add-gen-map`` commands write what
grid_tpu's write.
"""

import gzip
import shutil
from pathlib import Path

import numpy as np
import pytest

import grid_tpu.tools as j_tools
from grid_tpu_torch import native_host, tools
from grid_tpu_torch.io import cramlite
from grid_tpu_torch.io.bamlite import encode_record, write_bam

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ toolchain")

REFS = [("chr1", 20_000), ("chr2", 10_000)]
WINDOW = ("chr1", 2_000, 6_000)


class Recorder:
    def __init__(self):
        self.lines = []

    def print(self, msg, style=None):
        self.lines.append((str(msg), style))


def decoded(path, *region) -> list:
    """Every record's fields, from cramlite with no FASTA."""
    with cramlite.CramReader(path) as rd:
        return [(r.name, r.flag, r.ref_id, r.pos, r.mapq, r.seq, bytes(r.qual or b""),
                 tuple(r.cigar or ()), r.mate_ref_id, r.mate_pos, r.tlen)
                for r in rd.iter_records(*region)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Two BAMs and two CRAMs (one with CIGAR features) of seeded reads
    drawn from a FASTA, and the FASTA."""
    base = tmp_path_factory.mktemp("tools")
    rng = np.random.default_rng(4)
    seqs = {name: "".join(rng.choice(list("ACGT"), size=length)) for name, length in REFS}
    fasta = base / "ref.fa"
    fasta.write_text("".join(f">{name}\n{seq}\n" for name, seq in seqs.items()))
    aln = base / "aln"
    aln.mkdir()
    for i in range(2):
        recs = [encode_record(0, pos, 99, read_name=f"b{i}_{pos}", seq_len=100)
                for pos in range(0, 19_000, 70 + 10 * i)]
        write_bam(aln / f"S{i}.bam", REFS, recs)
        crecs = []
        for j, pos in enumerate(sorted(rng.integers(0, 19_800, size=300))):
            seq = list(seqs["chr1"][pos:pos + 100])
            for _ in range(int(rng.integers(0, 3))):
                k = int(rng.integers(0, 100))
                seq[k] = "ACGT"[("ACGT".index(seq[k]) + 1) % 4]
            cigar = [("M", 40), ("D", 3), ("M", 60)] if i and j % 5 == 0 else None
            crecs.append(cramlite.CramRecord(
                name=f"c{i}_{j}", flag=99 if j % 2 else 147, ref_id=0, pos=int(pos), mapq=60,
                rl=100, seq="".join(seq), qual=bytes(rng.integers(33, 74, size=100).tolist()),
                mate_ref_id=0, mate_pos=int(pos), tlen=0, cigar=cigar))
        cramlite.write_cram(aln / f"C{i}.cram", REFS, crecs, build_index=False)
    return {"aln": aln, "fasta": fasta}


def test_add_genetic_map_equals_grid_tpu_s(tmp_path):
    gmap = tmp_path / "gmap.txt"
    gmap.write_text("chr position COMBINED_rate(cM/Mb) Genetic_Map(cM)\n"
                    "6 1000 1.0 0.0\n6 2000 1.0 1.0\n# note\n6 3000 1.0 2.0\n")
    plink = tmp_path / "in.map"
    plink.write_text("6\trs1\t0\t1500\n6 rs2 0 2500\n6\trs3\t0\t9000\nbad\n6\trs0\t0\t10\n")
    for source in (gmap, tmp_path / "gmap.txt.gz"):
        if source.suffix == ".gz":
            source.write_bytes(gzip.compress(gmap.read_bytes()))
        out = tools.add_genetic_map(plink, source, tmp_path / "sub" / "out")
        want = j_tools.add_genetic_map(plink, source, tmp_path / "jax")
        assert out == tmp_path / "sub" / "out.map"
        assert out.read_bytes() == want.read_bytes()
    lines = out.read_text().splitlines()
    assert lines[:2] == ["6\trs1\t0.5\t1500", "6\trs2\t1.5\t2500"] and len(lines) == 4


def test_bam_subset_equals_grid_tpu_s(world, tmp_path):
    src = world["aln"] / "S0.bam"
    n = tools.subset_alignment(src, *WINDOW, tmp_path / "t.bam")
    want = j_tools.subset_alignment(src, *WINDOW, tmp_path / "j.bam")
    assert n == want > 0
    assert (tmp_path / "t.bam").read_bytes() == (tmp_path / "j.bam").read_bytes()
    from grid_tpu_torch.native_host import bam

    # the subset is the native fetch of the window's overlaps
    pos = bam.fetch_reads(tmp_path / "t.bam", "chr1", 0, 20_000, exclude_flags=0)[0]
    want_pos = bam.fetch_reads(src, "chr1", WINDOW[1] - 99, WINDOW[2], exclude_flags=0)[0]
    np.testing.assert_array_equal(pos, want_pos)
    with pytest.raises(ValueError, match="not found"):
        tools.subset_alignment(src, "chrX", 0, 10, tmp_path / "x.bam")


@pytest.mark.parametrize("embed", [False, True], ids=["verbatim", "embed_reference"])
def test_cram_subset_equals_grid_tpu_s(world, tmp_path, embed):
    src = world["aln"] / "C1.cram"
    ref = str(world["fasta"]) if embed else None
    # one file name in two directories: the CRAM file ID holds the name
    ours, theirs = tmp_path / "torch" / "s.cram", tmp_path / "jax" / "s.cram"
    for path in (ours, theirs):
        path.parent.mkdir()
    n = tools.subset_alignment(src, *WINDOW, ours, ref, embed_reference=embed)
    want = j_tools.subset_alignment(src, *WINDOW, theirs, ref, embed_reference=embed)
    assert n == want > 0
    got = decoded(ours)
    assert got == decoded(theirs) == decoded(src, *WINDOW)
    assert len(got) == n and any(rec[7] for rec in got)  # CIGAR features kept
    if not embed:  # the same C++ writer on the same records
        assert ours.read_bytes() == theirs.read_bytes()
        assert Path(f"{ours}.crai").read_bytes() == Path(f"{theirs}.crai").read_bytes()
        from grid_tpu_torch.native_host import cram

        assert len(cram.dump_records(ours)) == n


def test_a_failing_native_cram_writer_is_counted_and_logged(world, tmp_path, monkeypatch):
    """grid_tpu passes on to the Python writer silently; the port counts the
    fallback and logs it, and the file decodes to the same records."""
    from grid_tpu_torch.native_host import cram

    def fails(*args, **kwargs):
        raise IOError("grid_cram_write failed with code -1")

    monkeypatch.setattr(cram, "write_cram", fails)
    monkeypatch.setattr(native_host, "fallbacks", native_host.fallbacks.__class__())
    console = Recorder()
    src = world["aln"] / "C0.cram"
    n = tools.subset_alignment(src, *WINDOW, tmp_path / "t.cram", console=console)
    assert native_host.fallbacks == {"cram_write": 1}
    assert [m for m, style in console.lines if style == "warning"] == [
        f"native CRAM writer failed on {tmp_path / 't.cram'} (grid_cram_write failed with code "
        "-1); writing it with cramlite's Python writer"]
    assert decoded(tmp_path / "t.cram") == decoded(src, *WINDOW) and n > 0


def copy_of(world, dst: Path) -> Path:
    shutil.copytree(world["aln"], dst)
    return dst


def test_batch_subset_and_index_equal_grid_tpu_s(world, tmp_path):
    results = {}
    for tag, mod in (("torch", tools), ("jax", j_tools)):
        aln = copy_of(world, tmp_path / tag / "aln")
        idx = mod.batch_ensure_index(aln, threads=2)
        sub = mod.batch_subset(aln, *WINDOW, tmp_path / tag / "subsets", threads=2)
        results[tag] = (aln, {Path(k).name: v for k, v in idx.items()},
                        {Path(k).name: v for k, v in sub.items()})
    (aln, idx, sub), (j_aln, j_idx, j_sub) = results["torch"], results["jax"]
    assert idx == j_idx == {name: True for name in ("C0.cram", "C1.cram", "S0.bam", "S1.bam")}
    assert sub == j_sub and all(v for v in sub.values())
    for name in ("S0.bam.bai", "S1.bam.bai", "C0.cram.crai", "C1.cram.crai"):
        assert (aln / name).read_bytes() == (j_aln / name).read_bytes(), name
    for name in ("S0_subset.bam", "S1_subset.bam", "C0_subset.cram", "C1_subset.cram"):
        got, want = tmp_path / "torch" / "subsets" / name, tmp_path / "jax" / "subsets" / name
        assert got.read_bytes() == want.read_bytes(), name
    # indexes already there: nothing rebuilt
    assert tools.batch_ensure_index(aln) == {str(p): True for p in sorted(
        list(aln.glob("*.bam")) + list(aln.glob("*.cram")))}


def test_batch_tools_report_a_bad_file(world, tmp_path):
    aln = copy_of(world, tmp_path / "aln")
    (aln / "broken.bam").write_bytes(b"not a bam")
    console = Recorder()
    sub = tools.batch_subset(aln, *WINDOW, tmp_path / "out", console=console)
    assert sub[str(aln / "broken.bam")] is None
    assert sum(v is not None for v in sub.values()) == 4
    assert any(m.startswith("Failed to subset broken.bam") for m, s in console.lines
               if s == "danger")
    idx = tools.batch_ensure_index(aln, console=console)
    assert idx[str(aln / "broken.bam")] is False
    assert any(m.startswith("Failed to index broken.bam") for m, _ in console.lines)


def invoke_both(args, tmp_path):
    """Run one command through each package's CLI (the paths in ``args``
    with ``{tag}`` filled in); returns the two results."""
    from click.testing import CliRunner

    from grid_tpu.cli import cli as j_cli
    from grid_tpu_torch.cli import cli

    out = {}
    for tag, group in (("torch", cli), ("jax", j_cli)):
        (tmp_path / tag).mkdir(exist_ok=True)
        out[tag] = CliRunner().invoke(group, [a.format(tag=tmp_path / tag) for a in args])
    return out["torch"], out["jax"]


def test_tool_commands_equal_grid_tpu_s(world, tmp_path):
    for tag in ("torch", "jax"):
        copy_of(world, tmp_path / tag / "aln")
    chrom, start, end = WINDOW
    region = ["-c", chrom, "-s", str(start), "-e", str(end)]
    got, want = invoke_both(["subset", "-a", str(world["aln"] / "C1.cram"), *region,
                             "-o", "{tag}/one.cram"], tmp_path)
    assert got.exit_code == want.exit_code == 0, got.output
    assert (tmp_path / "torch" / "one.cram").read_bytes() == (
        tmp_path / "jax" / "one.cram").read_bytes()
    assert "Wrote " in got.output and got.output.split("Wrote ")[1].split()[0] == \
        want.output.split("Wrote ")[1].split()[0]
    got, want = invoke_both(["subset", "-a", str(world["aln"] / "C0.cram"), *region,
                             "-R", str(world["fasta"]), "--embed-reference",
                             "-o", "{tag}/emb.cram"], tmp_path)
    assert got.exit_code == want.exit_code == 0, got.output
    assert decoded(tmp_path / "torch" / "emb.cram") == decoded(tmp_path / "jax" / "emb.cram")
    got, want = invoke_both(["batch-crai", "-C", "{tag}/aln", "-t", "2"], tmp_path)
    assert got.exit_code == want.exit_code == 0 and "Indexed 4/4 files" in got.output
    got, want = invoke_both(["batch-subset", "-C", "{tag}/aln", *region, "-o", "{tag}/subsets",
                             "-t", "2"], tmp_path)
    assert got.exit_code == want.exit_code == 0 and "Subset 4/4 files" in got.output
    for p in sorted((tmp_path / "jax" / "subsets").iterdir()):
        assert (tmp_path / "torch" / "subsets" / p.name).read_bytes() == p.read_bytes(), p.name
    gmap = tmp_path / "gmap.txt"
    gmap.write_text("chr position COMBINED_rate(cM/Mb) Genetic_Map(cM)\n6 1000 1.0 0.0\n"
                    "6 3000 1.0 2.0\n")
    plink = tmp_path / "in.map"
    plink.write_text("6\trs1\t0\t1500\n")
    got, want = invoke_both(["add-gen-map", "--map", str(plink), "--genetic-map", str(gmap),
                             "--out", "{tag}/cm"], tmp_path)
    assert got.exit_code == want.exit_code == 0
    assert (tmp_path / "torch" / "cm.map").read_bytes() == (tmp_path / "jax" / "cm.map").read_bytes()
    got, want = invoke_both(["subset", "-a", str(tmp_path / "missing.bam"), *region, "-o", "x"],
                            tmp_path)
    assert got.exit_code == want.exit_code == 2
