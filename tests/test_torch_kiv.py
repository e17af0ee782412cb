"""The port's KIV-2 exon modules (``models/kiv.py``, ``models/kiv_io.py``)
against grid_tpu's on numpy-seeded inputs: the same dicts, the same floats
(the same host arithmetic) and byte-identical files. Exact."""

import gzip

import numpy as np
import pytest

from grid_tpu.models import kiv as jax_kiv
from grid_tpu.models import kiv_io as jax_kiv_io
from grid_tpu_torch import models
from grid_tpu_torch.models import kiv, kiv_io

EXON_TYPES = ("1B_KIV3", "1B_notKIV3", "1B", "1A")
COLUMNS = ("1B_KIV3", "1B_KIV2", "1B_tied", "1A")


def _counts(rng, ids, zero_frac=0.15):
    return {sid: {c: int(0 if rng.random() < zero_frac else rng.integers(1, 400))
                  for c in COLUMNS} for sid in ids}


def _neighbors(rng, ids, n_nbr, unknown=("GHOST1", "GHOST2")):
    """Neighbor lists with zero and negative scales and ids missing from
    the counts, so some neighbors are skipped and still take a slot."""
    out = {}
    for sid in ids:
        pool = [x for x in ids if x != sid] + list(unknown)
        order = rng.permutation(len(pool))[:n_nbr]
        nbrs = [(pool[i], float(rng.choice([0.0, -1.0, *rng.uniform(0.5, 1.5, 6)])),
                 float(rng.uniform(0, 1))) for i in order]
        out[sid] = (float(rng.choice([0.0, *rng.uniform(0.5, 1.5, 9)])), nbrs)
    return out


def test_models_exports_the_kiv_functions():
    assert models.estimate_kiv2 is kiv.estimate_kiv2
    assert models.get_exon_count is kiv.get_exon_count
    assert models.compute_dipcn_for_exon is kiv.compute_dipcn_for_exon


@pytest.mark.parametrize("exon_type", EXON_TYPES)
def test_get_exon_count_equals_grid_tpu(exon_type):
    rng = np.random.default_rng(1)
    for counts in _counts(rng, [f"S{i}" for i in range(20)]).values():
        partial = {k: v for k, v in counts.items() if rng.random() > 0.3}  # missing keys: 0
        for c in (counts, partial):
            assert kiv.get_exon_count(c, exon_type) == jax_kiv.get_exon_count(c, exon_type)


def test_get_exon_count_unknown_type_raises():
    with pytest.raises(ValueError, match="Unknown exon type"):
        kiv.get_exon_count({}, "2A")


@pytest.mark.parametrize("exon_type", EXON_TYPES)
@pytest.mark.parametrize("n_neighbors", [1, 3, 200])
def test_compute_dipcn_for_exon_equals_grid_tpu(exon_type, n_neighbors):
    rng = np.random.default_rng(len(exon_type) * 31 + n_neighbors)
    ids = [f"S{i:03d}" for i in range(40)]
    counts = _counts(rng, ids[:-3])  # 3 samples have neighbors but no counts
    nbrs = _neighbors(rng, ids, 12)
    got = kiv.compute_dipcn_for_exon(counts, nbrs, exon_type, n_neighbors)
    assert got == jax_kiv.compute_dipcn_for_exon(counts, nbrs, exon_type, n_neighbors)
    assert got  # not vacuous


def test_a_skipped_neighbor_still_takes_a_slot():
    counts = {"A": {"1A": 10}, "B": {"1A": 0}, "C": {"1A": 20}, "D": {"1A": 40}}
    nbrs = {"A": (1.0, [("B", 1.0, 0.1), ("C", 1.0, 0.2), ("D", 1.0, 0.3)])}
    # the first two slots: B (zero count, skipped) and C; D is past them
    for module in (kiv, jax_kiv):
        assert module.compute_dipcn_for_exon(counts, nbrs, "1A", 2) == {"A": 0.5}


def test_estimate_kiv2_equals_grid_tpu():
    rng = np.random.default_rng(4)
    a, b = rng.uniform(0, 3, 50), rng.uniform(0, 3, 50)
    for got, want in zip(kiv.estimate_kiv2(a, b), jax_kiv.estimate_kiv2(a, b)):
        np.testing.assert_array_equal(got, want)
    dip, hap = kiv.estimate_kiv2([1.0], [0.5])
    assert dip[0] == 34.9 + 5.2 * 0.5 - 1 and hap[0] == dip[0] / 2


def _dipcn_file(path, rng, ids):
    path.write_text("ID\tdipCN\n" + "".join(f"{s}\t{rng.uniform(0.2, 3):.6f}\n" for s in ids))
    return path


def test_estimate_kiv_files_byte_equal(tmp_path):
    rng = np.random.default_rng(9)
    a = _dipcn_file(tmp_path / "a.tsv", rng, [f"S{i}" for i in range(30)])
    b = _dipcn_file(tmp_path / "b.tsv", rng, [f"S{i}" for i in range(10, 45)])
    n = kiv.estimate_kiv_files(a, b, tmp_path / "port" / "kiv.tsv")
    assert n == jax_kiv.estimate_kiv_files(a, b, tmp_path / "jax" / "kiv.tsv") == 20
    assert (tmp_path / "port" / "kiv.tsv").read_bytes() == \
        (tmp_path / "jax" / "kiv.tsv").read_bytes()


def test_estimate_kiv_files_without_overlap_raises(tmp_path):
    rng = np.random.default_rng(2)
    a = _dipcn_file(tmp_path / "a.tsv", rng, ["A"])
    b = _dipcn_file(tmp_path / "b.tsv", rng, ["B"])
    with pytest.raises(ValueError, match="No overlapping samples"):
        kiv.estimate_kiv_files(a, b, tmp_path / "o.tsv")


@pytest.mark.parametrize("sid", ["NA12878", " NA12878.cram ", "NA12878.bam",
                                 "HG1.b38.irc.v1_subset", "HG1.b38.irc.v1_subset.cram",
                                 "x.cram.bam", "a.bam.cram", ""])
def test_normalize_sample_id_equals_grid_tpu(sid):
    assert kiv.normalize_sample_id(sid) == jax_kiv.normalize_sample_id(sid)


def _counts_text(rng, ids):
    lines = []
    for i, sid in enumerate(ids):
        name = f"{sid}.cram" if i % 3 == 0 else sid
        row = [name] + [str(int(v)) for v in rng.integers(0, 300, 4)]
        if i % 7 == 3:
            row = row[:4]  # four columns: skipped
        if i % 11 == 5:
            row[2] = "x"  # not an integer: skipped
        lines.append("\t".join(row))
    return "\n".join(lines[:5]) + "\n\n" + "\n".join(lines[5:]) + "\n"


def test_load_count_results_equals_grid_tpu(tmp_path):
    rng = np.random.default_rng(12)
    path = tmp_path / "counts.tsv"
    path.write_text(_counts_text(rng, [f"S{i}" for i in range(40)]))
    got = kiv_io.load_count_results(path)
    assert got == jax_kiv_io.load_count_results(path) and len(got) > 25


def _neighbor_text(rng, ids):
    lines = []
    for i, sid in enumerate(ids):
        scale = "x" if i % 13 == 6 else f"{rng.uniform(0.5, 1.5):.4f}"
        row = [f"{sid}.bam" if i % 4 == 0 else sid, scale]
        for j in rng.permutation(len(ids))[:6]:
            scale = "nan?" if (i + j) % 17 == 0 else f"{rng.uniform(0.5, 1.5):.4f}"
            row += [f"{ids[j]}.cram", scale, f"{rng.uniform(0, 1):.4f}"]
        if i % 5 == 2:
            row.append(ids[0])  # a trailing partial triple
        lines.append("\t".join(row))
    lines.append("lonely")
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gzip"])
def test_load_neighbor_results_equals_grid_tpu(tmp_path, gz):
    rng = np.random.default_rng(13)
    text = _neighbor_text(rng, [f"S{i}" for i in range(30)])
    path = tmp_path / ("nbrs.tsv.gz" if gz else "nbrs.tsv")
    if gz:
        with gzip.open(path, "wt") as f:
            f.write(text)
    else:
        path.write_text(text)
    got = kiv_io.load_neighbor_results(path)
    assert got == jax_kiv_io.load_neighbor_results(path) and len(got) > 25


def test_validate_overlap_and_write_equal_grid_tpu(tmp_path):
    class Lines:
        def __init__(self):
            self.lines = []

        def print(self, msg, style=None):
            self.lines.append(msg)

    rng = np.random.default_rng(14)
    counts = _counts(rng, [f"S{i}" for i in range(20)])
    nbrs = _neighbors(rng, [f"S{i}" for i in range(5, 30)], 4)
    got_console, want_console = Lines(), Lines()
    got = kiv_io.validate_sample_overlap(counts, nbrs, got_console)
    assert got == jax_kiv_io.validate_sample_overlap(counts, nbrs, want_console)
    assert got_console.lines == want_console.lines
    results = {f"S{i}": float(v) for i, v in enumerate(rng.uniform(0, 3, 15))}
    kiv_io.write_dipcn_output(results, tmp_path / "p" / "d.tsv")
    jax_kiv_io.write_dipcn_output(results, tmp_path / "j" / "d.tsv")
    assert (tmp_path / "p" / "d.tsv").read_bytes() == (tmp_path / "j" / "d.tsv").read_bytes()
