"""The port's IBS step against grid_tpu's, on the CPU.

The same seeded panels go through both packages: the numpy PBWT engine
(``ops/pbwt.py``) and the host library's C++ engine (``csrc/host/ibs.cpp``)
give grid_tpu's neighbors exactly (indices, cM lengths and edges, counts);
the phased VCF and BGEN readers give its panels and the BGEN writer its
bytes; ``compute_ibs_neighbors`` writes its neighbor file (compared
decompressed: a gzip header holds a time); the pipeline with
``compute_ibs.run: true`` writes its IBS file and, in float64, its haploid
table (``docs/parity.md:23-30``); the sweep makes one IBS file per locus as
grid_tpu's does; the synthetic panel is grid_tpu's; and the ``ibs`` command
behaves as grid_tpu's.
"""

import copy
import gzip
import shutil
import struct
from pathlib import Path

import numpy as np
import pytest

import grid_tpu.io.phased as j_phased
import grid_tpu.pipeline as jax_pipeline
from grid_tpu.ops.pbwt import pbwt_ibs_neighbors as j_pbwt
from grid_tpu.ops.pbwt import pbwt_order as j_pbwt_order
from grid_tpu.steps.ibs import compute_ibs_neighbors as j_compute_ibs_neighbors
from grid_tpu.synth import make_synthetic_cohort
from grid_tpu.synth import make_synthetic_phased_panel as j_make_panel
from grid_tpu_torch import native_host
from grid_tpu_torch.io import phased
from grid_tpu_torch.ops.pbwt import pbwt_ibs_neighbors, pbwt_order
from grid_tpu_torch.pipeline import run_wgs_pipeline
from grid_tpu_torch.steps import ibs as ibs_step
from grid_tpu_torch.steps.ibs import OUTPUT_HEADER, compute_ibs_neighbors
from grid_tpu_torch.synth import make_synthetic_phased_panel

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ toolchain")


class Recorder:
    """A console that keeps what the pipeline logs."""

    def __init__(self):
        self.lines = []

    def print(self, msg, style=None):
        self.lines.append((str(msg), style))


def text(path) -> str:
    path = Path(path)
    return gzip.open(path, "rt").read() if path.name.endswith(".gz") else path.read_text()


def random_panel(rng, n_hap, m, related_pairs=0):
    """tests/test_ibs.py's panel: random alleles, with pairs sharing a long
    segment around the middle."""
    H = rng.integers(0, 2, size=(n_hap, m), dtype=np.uint8)
    mid = m // 2
    for _ in range(related_pairs):
        x, y = rng.choice(n_hap, size=2, replace=False)
        span = rng.integers(m // 4, m // 2)
        H[y, max(0, mid - span // 2):min(m, mid + span // 2)] = H[x, max(0, mid - span // 2):
                                                                   min(m, mid + span // 2)]
    return H


def assert_same_neighbors(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


# ------------------------------------------------------------ the engine ---


@pytest.mark.parametrize("seed", [0, 1])
def test_pbwt_order_equals_grid_tpu_s(seed):
    rng = np.random.default_rng(seed)
    for H in (rng.integers(0, 2, size=(20, 13), dtype=np.uint8), np.zeros((6, 0), np.uint8)):
        assert_same_neighbors(pbwt_order(H), j_pbwt_order(H))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("shape", [(24, 40), (50, 80)])
def test_numpy_engine_equals_grid_tpu_s(seed, shape):
    rng = np.random.default_rng(seed)
    n_hap, m = shape
    H = random_panel(rng, n_hap, m, related_pairs=4)
    pos = np.sort(rng.choice(np.arange(1, 10 * m), size=m, replace=False)).astype(float)
    cm = np.cumsum(rng.uniform(0.001, 0.05, size=m))
    focal_bp = float(pos[m // 2]) - 0.5
    f = int(np.searchsorted(pos, focal_bp))
    focal_cm = float(np.interp(focal_bp, pos, cm))
    for max_scan in (n_hap + 8, None, 3):  # uncapped, the default, and capped
        assert_same_neighbors(pbwt_ibs_neighbors(H, cm, f, focal_cm, 5, max_scan=max_scan),
                              j_pbwt(H, cm, f, focal_cm, 5, max_scan=max_scan))


def test_numpy_engine_edge_focals_identical_panel_and_mate():
    rng = np.random.default_rng(7)
    H = random_panel(rng, 16, 30, related_pairs=2)
    cm = np.cumsum(rng.uniform(0.01, 0.02, size=30))
    for f, focal_cm in [(0, float(cm[0])), (30, float(cm[-1]))]:
        assert_same_neighbors(pbwt_ibs_neighbors(H, cm, f, focal_cm, 3, max_scan=64),
                              j_pbwt(H, cm, f, focal_cm, 3, max_scan=64))
    same = np.ones((10, 12), dtype=np.uint8)  # ranking falls through to the index
    cm12 = np.arange(12, dtype=float) * 0.1
    got = pbwt_ibs_neighbors(same, cm12, 6, 0.55, 4, max_scan=32)
    assert_same_neighbors(got, j_pbwt(same, cm12, 6, 0.55, 4, max_scan=32))
    H = random_panel(np.random.default_rng(3), 12, 20)
    H[5] = H[4]  # sample 2's haplotypes identical: still not each other's neighbor
    cm20 = np.arange(20, dtype=float) * 0.05
    idx = pbwt_ibs_neighbors(H, cm20, 10, 0.48, 11, max_scan=64)[0]
    assert_same_neighbors((idx,), (j_pbwt(H, cm20, 10, 0.48, 11, max_scan=64)[0],))
    for h in range(12):
        row = idx[h][idx[h] >= 0]
        assert h not in row and (h ^ 1) not in row


def test_numpy_engine_refuses_a_focal_outside_the_panel():
    H = np.zeros((4, 5), np.uint8)
    for engine in (pbwt_ibs_neighbors, j_pbwt):
        with pytest.raises(ValueError, match="outside"):
            engine(H, np.arange(5.0), 6, 0.0, 1)


@needs_gxx
@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("threads", [1, 4])
def test_native_engine_equals_grid_tpu_s_and_numpy(seed, threads):
    from grid_tpu.native.ibs import pbwt_ibs_neighbors as j_native
    from grid_tpu_torch.native_host.ibs import pbwt_ibs_neighbors as native

    rng = np.random.default_rng(seed)
    H = random_panel(rng, 60, 100, related_pairs=6)
    cm = np.cumsum(rng.uniform(0.001, 0.05, size=100))
    focal_cm = float((cm[49] + cm[50]) / 2)
    got = native(H, cm, 50, focal_cm, 7, threads=threads)
    assert_same_neighbors(got, j_native(H, cm, 50, focal_cm, 7, threads=threads))
    assert_same_neighbors(got, pbwt_ibs_neighbors(H, cm, 50, focal_cm, 7))
    for f in (0, 100):  # the edge focals
        fcm = float(cm[0] if f == 0 else cm[-1])
        assert_same_neighbors(native(H, cm, f, fcm, 4, threads=threads),
                              pbwt_ibs_neighbors(H, cm, f, fcm, 4))


@needs_gxx
def test_native_engine_refuses_a_wrong_map():
    from grid_tpu_torch.native_host.ibs import pbwt_ibs_neighbors as native

    with pytest.raises(ValueError, match="expected"):
        native(np.zeros((4, 5), np.uint8), np.arange(4.0), 2, 0.0, 1)


# ------------------------------------------------------------ the panels ---


@pytest.fixture(scope="module")
def panel(tmp_path_factory):
    """grid_tpu's and the port's synthetic panel from one seed."""
    base = tmp_path_factory.mktemp("panel")
    return (make_synthetic_phased_panel(base / "torch", n_samples=10, n_sites=60, seed=0),
            j_make_panel(base / "jax", n_samples=10, n_sites=60, seed=0))


@pytest.mark.parametrize("kwargs", [{}, {"hap_groups": np.arange(20) % 3},
                                    {"n_samples": 6, "n_sites": 30, "seed": 4, "chrom": "chr6"}])
def test_synthetic_panel_equals_grid_tpu_s(tmp_path, kwargs):
    got = make_synthetic_phased_panel(tmp_path / "torch", **{"n_samples": 10, "n_sites": 60,
                                                             **kwargs})
    want = j_make_panel(tmp_path / "jax", **{"n_samples": 10, "n_sites": 60, **kwargs})
    assert text(got["vcf"]) == text(want["vcf"])
    for key in ("sample_file", "genetic_map"):
        assert got[key].read_bytes() == want[key].read_bytes(), key
    for key in ("ids", "focal_bp", "clone_pairs", "chrom"):
        assert got[key] == want[key], key
    for key in ("H", "positions", "cm"):
        np.testing.assert_array_equal(got[key], want[key])


def test_synthetic_panel_refuses_wrong_groups(tmp_path):
    with pytest.raises(ValueError, match="hap_groups"):
        make_synthetic_phased_panel(tmp_path, n_samples=4, hap_groups=np.zeros(3))


def test_vcf_reader_equals_grid_tpu_s(panel):
    p, _ = panel
    got = phased.read_phased_vcf(p["vcf"])
    want = j_phased.read_phased_vcf(p["vcf"])
    assert got[0] == want[0] == p["ids"]
    assert_same_neighbors(got[1:], want[1:])
    np.testing.assert_array_equal(got[1], p["H"])


def test_vcf_chrom_filter_and_skips(tmp_path):
    vcf = tmp_path / "t.vcf"
    vcf.write_text(
        "##fileformat=VCFv4.2\n"
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS1\tS2\n"
        "6\t100\t.\tA\tG\t.\t.\t.\tGT\t0|1\t1|1\n"
        "7\t120\t.\tA\tG\t.\t.\t.\tGT\t0|0\t0|1\n"  # other chrom
        "6\t150\t.\tA\tG,C\t.\t.\t.\tGT\t0|1\t0|0\n"  # multi-allelic
        "6\t200\t.\tA\tG\t.\t.\t.\tGT\t0/1\t0|0\n"  # unphased
        "6\t250\t.\tA\tG\t.\t.\t.\tGT\t.|1\t0|0\n"  # missing
        "6\t300\t.\tA\t<DEL>\t.\t.\t.\tGT\t0|1\t0|0\n"  # symbolic
        "6\t400\t.\tA\tG\t.\t.\t.\tGT:DP\t1|0:12\t0|0:9\n"
    )
    for chrom in (6, None, "9"):
        got = phased.read_phased_vcf(vcf, chrom=chrom)
        want = j_phased.read_phased_vcf(vcf, chrom=chrom)
        assert got[0] == want[0] == ["S1", "S2"]
        assert_same_neighbors(got[1:], want[1:])
    assert list(phased.read_phased_vcf(vcf, chrom=6)[2]) == [100, 400]
    headless = tmp_path / "h.vcf"
    headless.write_text("6\t100\t.\tA\tG\t.\t.\t.\tGT\t0|1\n")
    with pytest.raises(ValueError, match="no #CHROM header"):
        phased.read_phased_vcf(headless)


@pytest.mark.parametrize("bits", [8, 16, 32, 11])
def test_bgen_writer_and_reader_equal_grid_tpu_s(panel, tmp_path, bits):
    p, _ = panel
    ours, theirs = tmp_path / "torch.bgen", tmp_path / "jax.bgen"
    phased.write_phased_bgen(ours, p["ids"], p["H"], p["positions"], chrom="6", bits=bits)
    j_phased.write_phased_bgen(theirs, p["ids"], p["H"], p["positions"], chrom="6", bits=bits)
    assert ours.read_bytes() == theirs.read_bytes()
    for chrom in (None, "6", "chr6", "7"):
        got = phased.read_phased_bgen(ours, chrom=chrom)
        want = j_phased.read_phased_bgen(theirs, chrom=chrom)
        assert got[0] == want[0] == p["ids"]
        assert_same_neighbors(got[1:], want[1:])
    np.testing.assert_array_equal(phased.read_phased_bgen(ours)[1], p["H"])


def without_embedded_ids(src: Path, dst: Path) -> Path:
    """The BGEN at ``src`` with its sample-identifier block taken out and
    its flag cleared: the reader must take the IDs from a .sample file."""
    raw = src.read_bytes()
    (offset,) = struct.unpack("<I", raw[:4])
    header = bytearray(raw[4:24])
    (flags,) = struct.unpack("<I", header[16:20])
    header[16:20] = struct.pack("<I", flags & ~(1 << 31))
    dst.write_bytes(struct.pack("<I", 20) + bytes(header) + raw[4 + offset:])
    return dst


def test_bgen_sample_file_fallback(panel, tmp_path):
    p, _ = panel
    full = phased.write_phased_bgen(tmp_path / "full.bgen", p["ids"], p["H"], p["positions"])
    bare = without_embedded_ids(full, tmp_path / "bare.bgen")
    got = phased.read_phased_bgen(bare, sample_file=p["sample_file"])
    want = j_phased.read_phased_bgen(bare, sample_file=p["sample_file"])
    assert got[0] == want[0] == p["ids"] == phased.read_sample_file(p["sample_file"])
    assert_same_neighbors(got[1:], want[1:])
    for reader in (phased.read_phased_bgen, j_phased.read_phased_bgen):
        with pytest.raises(ValueError, match="no embedded sample IDs"):
            reader(bare)
    short = phased.write_sample_file(tmp_path / "short.sample", p["ids"][:-1])
    with pytest.raises(ValueError, match="sample file has 9 IDs, bgen has 10"):
        phased.read_phased_bgen(bare, sample_file=short)
    bad = tmp_path / "bad.sample"
    bad.write_text("X Y\n")
    with pytest.raises(ValueError, match="missing ID_1"):
        phased.read_sample_file(bad)


def test_genetic_map_and_interpolation_equal_grid_tpu_s(panel, tmp_path):
    p, _ = panel
    got, want = phased.read_genetic_map(p["genetic_map"]), j_phased.read_genetic_map(
        p["genetic_map"])
    assert_same_neighbors(got, want)
    gz = tmp_path / "map.txt.gz"
    gz.write_bytes(gzip.compress(p["genetic_map"].read_bytes()))
    assert_same_neighbors(phased.read_genetic_map(gz), want)
    probes = np.concatenate([[0], p["positions"] + 17, [10**10]])
    np.testing.assert_array_equal(phased.interpolate_cm(probes, *got),
                                  j_phased.interpolate_cm(probes, *want))
    np.testing.assert_allclose(phased.interpolate_cm(p["positions"], *got), p["cm"], atol=5e-7)


# ------------------------------------------------------------- the file ---


@pytest.mark.parametrize("source", ["vcf", "bgen"])
@pytest.mark.parametrize("backend", ["numpy", pytest.param("native", marks=needs_gxx), "auto"])
@pytest.mark.parametrize("gmap", [True, False], ids=["map", "uniform"])
def test_neighbor_file_equals_grid_tpu_s(panel, tmp_path, source, backend, gmap):
    p, _ = panel
    kwargs = {"focal_bp": p["focal_bp"], "num_neighbors": 4, "threads": 2,
              "genetic_map": p["genetic_map"] if gmap else None}
    if source == "vcf":
        kwargs["vcf"] = p["vcf"]
    else:
        kwargs["bgen"] = phased.write_phased_bgen(tmp_path / "p.bgen", p["ids"], p["H"],
                                                  p["positions"], chrom=p["chrom"])
    console = Recorder()
    out = compute_ibs_neighbors(output=tmp_path / "torch.tsv.gz", backend=backend,
                                console=console, **kwargs)
    want = j_compute_ibs_neighbors(output=tmp_path / "jax.tsv.gz",
                                   backend="numpy" if backend == "native" else backend, **kwargs)
    assert text(out) == text(want)
    lines = text(out).splitlines()
    assert lines[0] == OUTPUT_HEADER and len(lines) == 1 + 2 * 10 * 4
    warned = [msg for msg, style in console.lines if style == "warning"]
    assert warned == ([] if gmap else ["no genetic map given; using uniform 1 cM/Mb"])


def test_vcf_and_bgen_give_one_file_and_plain_output(panel, tmp_path):
    p, _ = panel
    bgen = phased.write_phased_bgen(tmp_path / "p.bgen", p["ids"], p["H"], p["positions"],
                                    chrom=p["chrom"])
    a = compute_ibs_neighbors(output=tmp_path / "a.tsv", focal_bp=p["focal_bp"], vcf=p["vcf"],
                              num_neighbors=3, backend="numpy")
    b = compute_ibs_neighbors(output=tmp_path / "sub" / "b.tsv", focal_bp=p["focal_bp"],
                              bgen=bgen, num_neighbors=3, backend="numpy")
    assert a.read_text() == b.read_text()  # not gzipped without .gz
    want = j_compute_ibs_neighbors(output=tmp_path / "j.tsv", focal_bp=p["focal_bp"],
                                   vcf=p["vcf"], num_neighbors=3, backend="numpy")
    assert a.read_bytes() == want.read_bytes()


def test_neighbor_file_refusals(panel, tmp_path):
    p, _ = panel
    out = tmp_path / "x.tsv"
    with pytest.raises(ValueError, match="exactly one of vcf= or bgen="):
        compute_ibs_neighbors(output=out, focal_bp=1)
    with pytest.raises(ValueError, match="no usable phased biallelic sites"):
        compute_ibs_neighbors(output=out, focal_bp=1, vcf=p["vcf"], chrom="9")
    with pytest.raises(ValueError, match="unknown backend"):
        compute_ibs_neighbors(output=out, focal_bp=p["focal_bp"], vcf=p["vcf"], backend="gpu")
    one = tmp_path / "one.vcf"
    one.write_text("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS1\n"
                   "6\t100\t.\tA\tG\t.\t.\t.\tGT\t0|1\n")
    with pytest.raises(ValueError, match="panel too small"):
        compute_ibs_neighbors(output=out, focal_bp=100, vcf=one)


def test_a_failed_native_engine_falls_back_and_is_counted(panel, tmp_path, monkeypatch):
    """Under ``auto`` a failing native engine gives way to numpy with
    grid_tpu's warning, and ``native_host.fallbacks["ibs"]`` counts it;
    ``native`` lets the failure through."""
    import grid_tpu_torch.native_host.ibs as native_ibs

    p, _ = panel

    def fails(*args, **kwargs):
        raise RuntimeError("the host library is not loaded: refused by the test")

    monkeypatch.setattr(native_ibs, "pbwt_ibs_neighbors", fails)
    monkeypatch.setattr(native_host, "fallbacks", native_host.fallbacks.__class__())
    console = Recorder()
    kwargs = {"focal_bp": p["focal_bp"], "vcf": p["vcf"], "genetic_map": p["genetic_map"],
              "num_neighbors": 4}
    out = compute_ibs_neighbors(output=tmp_path / "a.tsv.gz", console=console, **kwargs)
    want = j_compute_ibs_neighbors(output=tmp_path / "j.tsv.gz", backend="numpy", **kwargs)
    assert text(out) == text(want)
    assert native_host.fallbacks == {"ibs": 1}
    assert [msg for msg, style in console.lines if style == "warning"] == [
        "native IBS core unavailable (the host library is not loaded: refused by the test); "
        "using numpy"]
    with pytest.raises(RuntimeError, match="refused by the test"):
        compute_ibs_neighbors(output=tmp_path / "b.tsv.gz", backend="native", **kwargs)
    assert native_host.fallbacks == {"ibs": 1}


def test_config_step_points_step_7_at_its_file(panel, tmp_path):
    p, _ = panel
    section = {"focal_bp": p["focal_bp"], "vcf": str(p["vcf"]), "num_neighbors": 3,
               "output_file_prefix": "nbrs"}
    cfg = {"output_dir": str(tmp_path), "compute_ibs": section}
    out = ibs_step.compute_ibs(cfg)
    assert out == tmp_path / "nbrs.tsv.gz" == ibs_step.default_ibs_output(cfg)
    assert cfg["compute_haploid_genotypes"]["ibs_output"] == str(out)
    cfg["compute_haploid_genotypes"]["ibs_output"] = "given.tsv.gz"
    ibs_step.compute_ibs(cfg)
    assert cfg["compute_haploid_genotypes"]["ibs_output"] == "given.tsv.gz"


# --------------------------------------------------------- the pipeline ---


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A 14-sample cohort and a panel of the same samples."""
    base = tmp_path_factory.mktemp("ibs_world")
    cohort = make_synthetic_cohort(base / "cohort", n_samples=14, seed=6)
    panel = make_synthetic_phased_panel(base / "panel", n_samples=14, n_sites=80, seed=6)
    return cohort, panel


def ibs_config(world, out, device, **ibs):
    cohort, panel = world
    cfg = copy.deepcopy(cohort["config"])
    out.mkdir(parents=True, exist_ok=True)
    cfg["output_dir"] = str(out)
    cfg["device"] = dict(device)
    (out / "read_counts.tsv").write_bytes(cohort["counts_file"].read_bytes())
    cfg["compute_ibs"] = {"run": True, "vcf": str(panel["vcf"]), "focal_bp": panel["focal_bp"],
                          "genetic_map": str(panel["genetic_map"]), "num_neighbors": 4, **ibs}
    del cfg["compute_haploid_genotypes"]["ibs_output"]  # the step must supply it
    return cfg


def failures(console) -> list:
    """Logged failures and fallbacks (not validation's notes on defaults)."""
    return [m for m, style in console.lines if style == "danger" or (
        style == "warning" and "Defaulting to" not in m and "config warning(s)" not in m)]


def haploid_rows(path):
    lines = Path(path).read_text().splitlines()
    return lines[0], [[ln.split("\t")[0]] + [float(v) for v in ln.split("\t")[1:]]
                      for ln in lines[1:]]


MODES = {"fused": {"fused": True}, "file": {}, "file_exact": {"exact_phasing": True}}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_pipeline_with_compute_ibs_equals_grid_tpu_s(world, tmp_path, mode):
    """The IBS file byte-equal after decompression; the haploid table
    byte-identical in float64 (the fused step and the exact file mode), and
    within one %.2f step in the default file mode."""
    device = MODES[mode]
    t_jax = jax_pipeline.run_wgs_pipeline(console=None,
                                          config=ibs_config(world, tmp_path / "jax", device))
    console = Recorder()
    t_torch = run_wgs_pipeline(console=console, config=ibs_config(
        world, tmp_path / "torch", {**device, "platform": "cpu"}))
    assert "compute_ibs" in t_jax and "compute_ibs" in t_torch
    assert ("fused_steps_4_7" in t_torch) == (mode == "fused")
    assert not failures(console)
    name = "ibs_neighbors.tsv.gz"
    assert text(tmp_path / "torch" / name) == text(tmp_path / "jax" / name)
    got = tmp_path / "torch" / "haploid_genotypes.tsv"
    want = tmp_path / "jax" / "haploid_genotypes.tsv"
    if mode in ("fused", "file_exact"):
        assert got.read_bytes() == want.read_bytes()
    else:
        (head, rows), (want_head, want_rows) = haploid_rows(got), haploid_rows(want)
        assert head == want_head and [r[0] for r in rows] == [r[0] for r in want_rows]
        np.testing.assert_allclose(np.array([r[1:] for r in rows]),
                                   np.array([r[1:] for r in want_rows]), rtol=0, atol=0.01001)
    vals = np.array([r[1:] for r in haploid_rows(got)[1]])
    assert len(vals) == 14 and np.isfinite(vals).all()


def test_resumed_run_skips_compute_ibs_and_still_feeds_step_7(world, tmp_path):
    cfg = ibs_config(world, tmp_path, {"platform": "cpu"})
    first = run_wgs_pipeline(console=None, config=copy.deepcopy(cfg))
    assert "compute_ibs" in first and "compute_haploid_genotypes" in first
    haploid = tmp_path / "haploid_genotypes.tsv"
    before = haploid.read_bytes()
    haploid.unlink()
    cfg["resume"] = True
    console = Recorder()
    again = run_wgs_pipeline(console=console, config=cfg)
    assert "compute_ibs" not in again and "compute_haploid_genotypes" in again
    assert "[compute_ibs] up-to-date, skipped (resume)" in [m for m, _ in console.lines]
    assert haploid.read_bytes() == before


def test_grouped_panel_recovers_haplotype_allocation(tmp_path):
    """tests/test_ibs.py's criterion on the port: haplotypes grouped by
    quantiles of the true haplotype CN share the panel around the focus, and
    the port's haplotype allocation correlates with the truth at rho > 0.5."""
    n = 24
    cohort = make_synthetic_cohort(tmp_path / "cohort", n_samples=n, seed=11)
    hap_cn = cohort["hap_cn"].reshape(-1)
    groups = np.searchsorted(np.quantile(hap_cn, [0.2, 0.4, 0.6, 0.8]), hap_cn)
    panel = make_synthetic_phased_panel(tmp_path / "panel", n_samples=n, n_sites=200, seed=11,
                                        hap_groups=groups)
    cfg = copy.deepcopy(cohort["config"])
    cfg["device"] = {"fused": True, "platform": "cpu"}
    cfg["compute_ibs"] = {"run": True, "vcf": str(panel["vcf"]), "focal_bp": panel["focal_bp"],
                          "genetic_map": str(panel["genetic_map"]), "num_neighbors": 6}
    del cfg["compute_haploid_genotypes"]["ibs_output"]
    run_wgs_pipeline(console=None, config=cfg)
    est = {r[0]: (r[2], r[3]) for r in haploid_rows(
        Path(cfg["output_dir"]) / "haploid_genotypes.tsv")[1]}
    e, t = [], []
    for i, sid in enumerate(cohort["ids"]):
        h1, h2 = est[sid]
        tru1, tru2 = cohort["hap_cn"][i]
        if h1 + h2 > 0:
            e.append(h1 / (h1 + h2))
            t.append(tru1 / (tru1 + tru2))
    rho = np.corrcoef(e, t)[0, 1]
    assert rho > 0.5, f"haplotype allocation correlation too low: {rho}"


GENES = ("GENEA", "GENEB", "GENEC")
CATALOG = (
    "CHR\tBP_START_HG38\tBP_END_HG38\tSAMTOOLS_START_HG38\tSAMTOOLS_END_HG38\tIBD2R\tGENE\n"
    "6\t160605000\t160610000\t160605000\t160610000\t0.9\tGENEA\n"
    "6\t160607000\t160612000\t160607000\t160612000\t0.8\tGENEB\n"
    "6\t160610000\t160615000\t160610000\t160615000\t0.7\tGENEC\n"
)


def test_sweep_makes_grid_tpu_s_ibs_file_per_locus(world, tmp_path):
    """``run_multi_locus`` with ``compute_ibs`` on 3 loci: each locus's IBS
    file (focus at its window's midpoint, on a panel spanning the windows)
    and haploid table equal grid_tpu's sweep's."""
    from grid_tpu.steps.multilocus import run_multi_locus as j_run_multi_locus
    from grid_tpu_torch.steps.multilocus import run_multi_locus

    cohort, _ = world
    catalog = tmp_path / "catalog.txt"
    catalog.write_text(CATALOG)
    panel = make_synthetic_phased_panel(tmp_path / "panel", n_samples=14, n_sites=60,
                                        start_bp=160_600_000, site_spacing=300, seed=2)
    outs = {}
    for name, sweep, device in (("jax", j_run_multi_locus, {}),
                                ("torch", run_multi_locus, {"platform": "cpu"})):
        cfg = ibs_config(world, tmp_path / name, device, vcf=str(panel["vcf"]),
                         genetic_map=str(panel["genetic_map"]))
        lines = cohort["counts_file"].read_text()
        for gene in GENES:
            (tmp_path / name / f"read_counts.{gene}.tsv").write_text(lines)
        console = Recorder()
        sweep(cfg, list(GENES), console, catalog)
        outs[name] = tmp_path / name
        if name == "torch":
            assert not failures(console)
    for gene in GENES:
        ibs_name = f"ibs_neighbors.{gene}.tsv.gz"
        assert text(outs["torch"] / ibs_name) == text(outs["jax"] / ibs_name), gene
        hap = f"haploid_genotypes.{gene}.tsv"
        (head, rows), (want_head, want_rows) = (haploid_rows(outs[n] / hap)
                                                for n in ("torch", "jax"))
        assert head == want_head and [r[0] for r in rows] == [r[0] for r in want_rows]
        np.testing.assert_allclose(np.array([r[1:] for r in rows]),
                                   np.array([r[1:] for r in want_rows]), rtol=0, atol=1e-9)
    focal = {gene: text(outs["torch"] / f"ibs_neighbors.{gene}.tsv.gz") for gene in GENES}
    assert len(set(focal.values())) == 3  # one focus per locus
    assert not (outs["torch"] / "ibs_neighbors.tsv.gz").exists()


# ----------------------------------------------------------- the command ---


def test_ibs_command_equals_grid_tpu_s(panel, tmp_path):
    from click.testing import CliRunner

    from grid_tpu.cli import cli as j_cli
    from grid_tpu_torch.cli import cli

    p, _ = panel
    bgen = phased.write_phased_bgen(tmp_path / "p.bgen", p["ids"], p["H"], p["positions"],
                                    chrom=p["chrom"])
    for args in (["--vcf", str(p["vcf"]), "--genetic-map", str(p["genetic_map"]), "-k", "3"],
                 ["--bgen", str(bgen), "-c", p["chrom"], "-k", "5", "-t", "2",
                  "--backend", "numpy", "--max-scan", "40"]):
        outs = []
        for tag, group in (("torch", cli), ("jax", j_cli)):
            out = tmp_path / f"{tag}.tsv.gz"
            res = CliRunner().invoke(group, ["ibs", *args, "--focal-bp", str(p["focal_bp"]),
                                             "-o", str(out)])
            assert res.exit_code == 0, res.output
            outs.append(text(out))
        assert outs[0] == outs[1]
    for bad in (["ibs", "--focal-bp", "1", "-o", str(tmp_path / "x")],
                ["ibs", "--vcf", str(p["vcf"]), "--bgen", str(bgen), "--focal-bp", "1",
                 "-o", str(tmp_path / "x")]):
        got, want = CliRunner().invoke(cli, bad), CliRunner().invoke(j_cli, bad)
        assert got.exit_code == want.exit_code != 0
        assert "pass exactly one of --vcf / --bgen" in got.output
