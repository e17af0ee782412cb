"""The port's host library (grid_tpu_torch.native_host) against the JAX
package on the CPU: the copied C++ files equal grid_tpu's, the native
bed.gz readers equal grid_tpu's Python and native readers, the stager stages
the same arrays on any number of threads, and the native writers give the
decompressed bytes of grid_tpu's Python writers. Gzipped files are compared
decompressed: the native writers emit level-1 BGZF blocks, Python's gzip
another stream of the same content."""

import ctypes
import gzip
import shutil
import struct
import subprocess
import sys
import warnings
import zlib
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import grid_tpu.io.bed as jax_bed
import grid_tpu.io.formats as jax_formats
import grid_tpu.io.staging as jax_staging
import grid_tpu_torch.io.bed as torch_bed
import grid_tpu_torch.io.formats as torch_formats
import grid_tpu_torch.io.staging as torch_staging
from grid_tpu_torch import native_host
from grid_tpu_torch.synth import make_synthetic_cohort

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ toolchain")

REPO = Path(__file__).resolve().parent.parent


def content(path) -> bytes:
    return gzip.open(path).read()


def is_bgzf(path) -> bool:
    head = Path(path).read_bytes()[:18]
    return head[:4] == b"\x1f\x8b\x08\x04" and head[12:14] == b"BC"


@pytest.fixture(scope="module")
def jax_native():
    """grid_tpu's own native reader, built by its Makefile."""
    from grid_tpu.native import bedgz

    try:
        from grid_tpu import native

        native.lib()
    except Exception as e:  # pragma: no cover - a failed make
        pytest.skip(f"grid_tpu's native build failed: {e}")
    # the functions themselves: jax_python patches the module's
    return SimpleNamespace(read_regions_bed_gz=bedgz.read_regions_bed_gz,
                           read_regions_bed_gz_grouped=bedgz.read_regions_bed_gz_grouped)


@pytest.fixture
def jax_python(monkeypatch):
    """grid_tpu's readers forced onto their Python bodies."""
    import grid_tpu.native.bedgz as jax_native_bedgz

    def refuse(*args, **kwargs):
        raise OSError("native route refused by the test")

    monkeypatch.setattr(jax_bed, "_native_reader", lambda: None)
    monkeypatch.setattr(jax_native_bedgz, "read_regions_bed_gz_grouped", refuse)
    return jax_bed


def assert_same_arrays(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


# ------------------------------------------------------------- library ---


def test_sources_are_byte_copies_of_grid_tpu_s():
    for name in native_host.FILES:
        ours = (native_host.CSRC / name).read_bytes()
        assert ours == (REPO / "grid_tpu" / "native" / "src" / name).read_bytes(), name


def test_library_builds_and_loads_native():
    assert native_host.route() == "native"
    path = native_host.library_path()
    assert path.exists() and path.parent == native_host.BUILD_DIR
    assert path.name.startswith("libgridhost-")
    lib = native_host.lib()
    for fn in ("grid_bed_read", "grid_bed_read_grouped", "grid_bed_free", "grid_bed_free_grouped",
               "grid_write_neighbors", "grid_write_normalized", "grid_bam_count",
               "grid_cram_count", "grid_bam_binned_depth", "grid_cram_binned_depth",
               "grid_bam_ingest_multi", "grid_cram_ingest_multi", "grid_ingest_batch",
               "grid_bam_build_bai", "grid_bam_refs", "grid_cram_refs", "grid_cram_dump",
               "grid_bam_fetch", "grid_bam_fetch_free"):
        assert getattr(lib, fn).argtypes, fn


def test_the_library_holds_the_whole_native_layer():
    """bgzf, bam, cram and batch are built beside the bed.gz reader and the
    text writers, and so are ibs.cpp (compute_ibs) and cram_write.cpp (the
    tools' CRAM writer): every source of grid_tpu/native/src/, each typed."""
    jax_src = REPO / "grid_tpu" / "native" / "src"
    assert set(native_host.FILES) == {p.name for p in jax_src.iterdir()
                                      if p.suffix in (".cpp", ".h")}
    assert {"ibs.cpp", "cram_write.cpp"} <= set(native_host.SOURCES)
    assert sorted(p.name for p in native_host.CSRC.iterdir()) == sorted(native_host.FILES)
    lib = native_host.lib()
    for fn in ("grid_ibs_neighbors", "grid_cram_write", "grid_bam_subset"):
        assert getattr(lib, fn).argtypes and getattr(lib, fn).restype is not None, fn


def test_library_is_keyed_by_sources_and_flags(monkeypatch, tmp_path):
    first = native_host.library_path()
    assert native_host.library_path() == first
    monkeypatch.setattr(native_host, "CXX_FLAGS", native_host.CXX_FLAGS + ("-g",))
    assert native_host.library_path() != first
    monkeypatch.undo()
    for name in native_host.FILES:
        (tmp_path / name).write_bytes((native_host.CSRC / name).read_bytes())
    monkeypatch.setattr(native_host, "CSRC", tmp_path)
    assert native_host.library_path() == first
    header = tmp_path / "bedwrite.h"
    header.write_text(header.read_text() + "// edited\n")
    assert native_host.library_path() != first


_BUILD_INTO = r"""
import sys
from pathlib import Path
from grid_tpu_torch import native_host
native_host.BUILD_DIR = Path(sys.argv[1])
print(native_host.build())
"""


def test_two_processes_building_at_once_leave_one_working_library(tmp_path):
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_INTO, str(tmp_path)], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [err for _, err in outs]
    paths = {out.strip() for out, _ in outs}
    assert len(paths) == 1
    built = Path(paths.pop())
    assert built.parent == tmp_path and built.name == native_host.library_path().name
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted([built.name,
                                                                 built.with_suffix(".log").name])
    lib = ctypes.CDLL(str(built))
    assert hasattr(lib, "grid_bed_read") and hasattr(lib, "grid_write_normalized")


def test_a_failed_build_warns_and_takes_the_python_route(monkeypatch, tmp_path):
    monkeypatch.setattr(native_host, "_LOADED", {})
    monkeypatch.setattr(native_host, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_host, "CXX", str(tmp_path / "no-such-compiler"))
    with pytest.warns(RuntimeWarning, match="no-such-compiler"):
        assert native_host.lib() is None
    assert native_host.route() != "native" and "no-such-compiler" in native_host.route()
    bed = tmp_path / "s.regions.bed.gz"
    write_gzip(bed, BED_LINES)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # warned once only
        got = torch_bed.read_regions_bed_gz(bed, "chr6")
    assert_same_arrays(got, torch_bed._read_regions_bed_gz_python(bed, "chr6"))
    path = tmp_path / "nbr.tsv.gz"
    torch_formats.write_neighbors_dense(path, ["a", "b"], [1.0, 2.0], [[1], [0]], [[0.5], [0.5]])
    assert not is_bgzf(path)
    assert content(path) == b"a\t1.00\tb\t2.00\t0.50\nb\t2.00\ta\t1.00\t0.50\n"


# -------------------------------------------------------------- reader ---

BED_LINES = [
    "chr6\t1000\t2000\t30.50",
    "chr6\t2000\t3000\t0.00",        # zero depth
    "chr6\t2500\t2600\t-1.25",       # negative depth
    "chr6\t3000\t4000\t28.25",
    "chr6\t3000\t4000\t29.75",       # duplicate region
    "chr6\t5000\t6000\t31.00",       # under the repeat mask
    "chr7\t1000\t2000\t33.00",       # another chromosome
    "6\t7000\t8000\t26.125",         # no chr prefix
    "chr6\tx\t8000\t30.00",          # unparsable start
    "chr6\t8000\tend\t30.00",        # unparsable end
    "chr6\t8000\t9000\tdeep",        # unparsable depth
    "chr6\t9000",                    # short
    "chr6 9000 10000 30.00",         # not tab-separated
    "",                              # empty line
    "chr6\t9000\t10000\t27.00",
    "chr6\t9500\t9800\t1e1",         # exponent form
    "chr6\t12000\t13000\t35.00",     # outside the window
    "chr61\t3000\t4000\t40.00",      # a prefix match of chr6
    "chr6\t13000\t14000\t30.00\textra",
]


def write_gzip(path, lines):
    with gzip.open(path, "wt") as f:
        f.write("\n".join(lines) + "\n")


def bed_via_port_writer(path, lines):
    """A multi-block BGZF bed written by the port's own native writer: the
    neighbors writer puts each sample ID at the head of its line, and an ID
    may hold tabs, so the IDs carry the bed lines' first three fields and
    the scales their depths."""
    ids = ["\t".join(line.split("\t")[:3]) for line in lines]
    depths = [float(line.split("\t")[3]) for line in lines]
    n = len(ids)
    idx = (np.arange(n) + 1)[:, None] % n
    torch_formats.write_neighbors_dense(path, ids, depths, idx, np.full((n, 1), 0.25))


def many_lines(n=6000):
    rng = np.random.default_rng(5)
    starts = 1000 * np.arange(n)
    depths = np.round(rng.normal(30, 8, n), 2)
    depths[::37] = 0.0
    chroms = np.where(np.arange(n) < n // 2, "chr6", "6")
    return [f"{c}\t{s}\t{s + 1000}\t{d:.2f}" for c, s, d in zip(chroms, starts, depths)]


@pytest.fixture(scope="module")
def bed_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("beds")
    files = {"gzip": d / "plain.regions.bed.gz", "bgzf": d / "bgzf.regions.bed.gz",
             "empty": d / "empty.regions.bed.gz"}
    write_gzip(files["gzip"], BED_LINES + many_lines(800))
    bed_via_port_writer(files["bgzf"], many_lines())
    with gzip.open(files["empty"], "wt"):
        pass
    mask = d / "mask.bed"
    mask.write_text("# repeats\nchr6\t5200\t5300\n6\t700000\t701500\nchr7\t1500\t1600\nbad\n")
    return files, mask


def test_port_s_writer_makes_a_multi_block_bgzf_bed(bed_files):
    files, _ = bed_files
    raw = files["bgzf"].read_bytes()
    assert is_bgzf(files["bgzf"]) and raw.count(b"\x1f\x8b\x08\x04") > 2
    assert raw.endswith(bytes.fromhex("1f8b08040000000000ff0600424302001b0003000000000000000000"))


@pytest.mark.parametrize("window", [(None, None), (1000, 10000), (4_000_000, 5_500_000)],
                         ids=["no_window", "window", "late_window"])
@pytest.mark.parametrize("chrom", ["chr6", "6", None])
@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "mask"])
@pytest.mark.parametrize("kind", ["gzip", "bgzf", "empty"])
def test_reader_matches_grid_tpu_s_readers(bed_files, jax_native, jax_python, kind, masked,
                                           chrom, window):
    files, mask_file = bed_files
    excluded = torch_bed.load_repeat_mask(mask_file if masked else None)
    args = (files[kind], chrom, *window, excluded)
    before = torch_bed.native_fallbacks
    got = torch_bed.read_regions_bed_gz(*args)
    assert torch_bed.native_fallbacks == before
    assert_same_arrays(got, jax_python.read_regions_bed_gz(*args))
    assert_same_arrays(got, jax_native.read_regions_bed_gz(*args))
    assert_same_arrays(got, torch_bed._read_regions_bed_gz_python(*args))
    if kind != "empty" and window == (1000, 10000) and chrom:
        assert len(got[0]) > 4


def corrupt_copy(src, dst, how):
    raw = bytearray(Path(src).read_bytes())
    if how == "truncated":
        raw = raw[: len(raw) // 2]
    else:  # a flipped byte inside the first block's deflate data
        raw[40] ^= 0xFF
        raw[41] ^= 0xFF
    Path(dst).write_bytes(bytes(raw))


@pytest.mark.parametrize("how", ["truncated", "flipped"])
def test_corrupt_file_takes_the_fallback_and_is_counted(bed_files, tmp_path, jax_python,
                                                        monkeypatch, how):
    files, _ = bed_files
    bad = tmp_path / "bad.regions.bed.gz"
    corrupt_copy(files["bgzf"], bad, how)
    monkeypatch.setattr(torch_bed, "native_fallbacks", 0)
    from grid_tpu_torch.native_host.bedgz import NativeReadError

    with pytest.raises(NativeReadError) as info:
        torch_bed.native_bedgz.read_regions_bed_gz(bad)
    assert info.value.code == -2
    errors = (OSError, EOFError, zlib.error)
    with pytest.raises(errors):
        torch_bed.read_regions_bed_gz(bad, "chr6")
    assert torch_bed.native_fallbacks == 1
    with pytest.raises(errors):
        jax_python.read_regions_bed_gz(bad, "chr6")
    with pytest.raises(errors):
        torch_bed.read_regions_bed_gz_grouped(bad)
    assert torch_bed.native_fallbacks == 2
    # the stager logs the sample as unreadable and stages the others
    scanned = torch_staging.scan_cohort_regions({"bad": bad, "good": files["bgzf"]}, "chr6", None,
                                                None, {})
    assert len(scanned["bad"][0]) == 0 and len(scanned["good"][0]) > 0
    assert torch_bed.native_fallbacks == 3


def test_missing_file_raises_as_the_python_reader_does(tmp_path):
    with pytest.raises(FileNotFoundError):
        torch_bed.read_regions_bed_gz(tmp_path / "none.regions.bed.gz")


@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "mask"])
@pytest.mark.parametrize("kind", ["gzip", "bgzf", "empty"])
def test_grouped_reader_matches_grid_tpu_s(bed_files, jax_native, jax_python, kind, masked):
    files, mask_file = bed_files
    excluded = torch_bed.load_repeat_mask(mask_file if masked else None)
    got = torch_bed.read_regions_bed_gz_grouped(files[kind], excluded)
    for want in (jax_python.read_regions_bed_gz_grouped(files[kind], excluded),
                 jax_native.read_regions_bed_gz_grouped(files[kind], excluded),
                 torch_bed._read_regions_bed_gz_grouped_python(files[kind], excluded)):
        assert [seg[0] for seg in got] == [seg[0] for seg in want]
        for g, w in zip(got, want):
            assert_same_arrays(g[1:], w[1:])
    if kind == "gzip":  # the mask drops chr7's one line, so "6" joins the first segment
        want = ["chr6", "chr61", "chr6"] if masked else ["chr6", "chr7", "chr6", "chr61", "chr6"]
        assert [seg[0] for seg in got] == want


# ------------------------------------------------------------- stager ---


@pytest.fixture(scope="module")
def small_cohort(tmp_path_factory):
    return make_synthetic_cohort(tmp_path_factory.mktemp("stage"), n_samples=14, seed=8,
                                 missing_frac=0.05)


@pytest.mark.parametrize("stager", ["stage_cohort", "stage_cohort_streaming"])
def test_stager_threads_give_bitwise_equal_arrays(small_cohort, jax_python, stager):
    cfg = small_cohort["config"]
    work = cfg["mosdepth"]["work_dir"]
    samples = torch_formats.read_samples(cfg["samples_file"])
    args = (work, samples, cfg["chrom"], cfg["start_bp"], cfg["end_bp"], {}, 20, 100)
    stages = [getattr(torch_staging, stager)(*args, threads=t) for t in (1, 4)]
    want = getattr(jax_staging, stager)(*args, threads=1)  # grid_tpu's Python reader
    for got in stages:
        assert got.sample_ids == want.sample_ids and len(got.sample_ids) == 14
        for field in ("regions", "values", "mask"):
            g, w = getattr(got, field), getattr(want, field)
            assert g.dtype == w.dtype and g.shape == w.shape
            assert g.tobytes() == w.tobytes(), field


def test_bulk_alloc_mode_runs_once_and_honours_its_opt_out(monkeypatch):
    calls = []

    def mallopt(option, value):
        calls.append((option, value))
        return 1

    libc = SimpleNamespace(mallopt=mallopt)
    monkeypatch.setattr(torch_staging.ctypes, "CDLL", lambda name: libc)
    monkeypatch.setattr(torch_staging, "_BULK_ALLOC_DONE", False)
    torch_staging._bulk_alloc_mode()
    torch_staging._bulk_alloc_mode()
    assert calls == [(-1, 128 << 20), (-3, 128 << 20)]
    monkeypatch.setattr(torch_staging, "_BULK_ALLOC_DONE", False)
    monkeypatch.setenv("GRID_TPU_NO_MALLOPT", "1")
    torch_staging._bulk_alloc_mode()
    assert len(calls) == 2 and torch_staging._BULK_ALLOC_DONE


# ------------------------------------------------------------- writers ---


def fuzz_values(rng, m):
    """``m`` values: magnitudes, exact %.2f / %.3f ties, near-zero signs,
    -0.0."""
    q = max(m, 8) // 4
    vals = np.concatenate([
        rng.uniform(-100, 100, q),
        rng.integers(-10_000, 10_000, q) / 1000.0,
        rng.integers(-10_000, 10_000, q) / 200.0,
        rng.normal(0, 1e-3, max(m, 8) - 3 * q),
    ])
    vals[:4] = [-0.0, 0.005, 1.005, 2.675]
    return rng.permutation(vals)[:m]


def normalized_case(dtype, r=64, n=40):
    rng = np.random.default_rng(17)
    ids = [f"HG{i:05d}" for i in range(n - 3)] + ["NA12878é", "样本-1", "Såmple"]
    scales = fuzz_values(rng, 4 * n)[:n] * 0.5 + 30
    scales[1] = np.nan
    z = fuzz_values(rng, n * r).reshape(n, r).astype(dtype)
    z[2, 3] = np.nan  # a valid cell holding nan: "nan"
    mask = rng.random((n, r)) > 0.2
    mask[2, 3] = True
    mask[4] = False
    means = np.abs(fuzz_values(rng, r)) + 0.001
    means[5], means[6] = np.nan, 0.0  # NA mean; ratio undefined
    col_vars = np.abs(fuzz_values(rng, r))
    return ids, scales, z, mask, means, col_vars


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("selection", ["all", "some", "none"])
def test_normalized_writer_matches_grid_tpu_s_python_writer(tmp_path, monkeypatch, dtype,
                                                            selection):
    ids, scales, z, mask, means, col_vars = normalized_case(dtype)
    r = z.shape[1]
    sel = {"all": np.arange(r), "some": np.arange(0, r, 3), "none": np.arange(0)}[selection]
    args = (ids, scales, z, mask, means, col_vars, sel)
    native = tmp_path / "native.tsv.gz"
    torch_formats.write_normalized_output(native, *args)
    assert is_bgzf(native)
    monkeypatch.setenv("GRID_TPU_NATIVE_WRITERS", "0")
    jax_formats.write_normalized_output(tmp_path / "jax.tsv.gz", *args)
    torch_formats.write_normalized_output(tmp_path / "python.tsv.gz", *args)
    assert not is_bgzf(tmp_path / "python.tsv.gz")
    want = content(tmp_path / "jax.tsv.gz")
    assert content(native) == want == content(tmp_path / "python.tsv.gz")
    lines = want.decode().splitlines()
    assert len(lines) == len(ids) + 2 and lines[-2].startswith("样本-1\t")
    if selection == "none":
        assert lines[0] == f"{len(ids)}\t0\t" and lines[2].endswith("\t")


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("k", [0, 1, 7])
def test_neighbors_writer_matches_grid_tpu_s_python_writer(tmp_path, monkeypatch, dtype, k):
    rng = np.random.default_rng(k + 2)
    n = 30
    ids = [f"id_{i}" for i in range(n - 2)] + ["NA12878é", "样本-2"]
    scales = (fuzz_values(rng, 4 * n)[:n] * 0.5 + 30).astype(dtype)
    idx = np.stack([rng.permutation(n)[:k] for _ in range(n)]).reshape(n, k).astype(np.int32)
    dists = np.abs(fuzz_values(rng, n * k)).reshape(n, k).astype(dtype)
    if k:
        dists[0, 0] = np.nan
    native = tmp_path / "native.tsv.gz"
    torch_formats.write_neighbors_dense(native, ids, scales, idx, dists)
    assert is_bgzf(native) == bool(k)  # k=0 is the Python writer's, as in grid_tpu
    monkeypatch.setenv("GRID_TPU_NATIVE_WRITERS", "0")
    jax_formats.write_neighbors_dense(tmp_path / "jax.tsv.gz", ids, scales, idx, dists)
    torch_formats.write_neighbors_dense(tmp_path / "python.tsv.gz", ids, scales, idx, dists)
    want = content(tmp_path / "jax.tsv.gz")
    assert content(native) == want == content(tmp_path / "python.tsv.gz")
    assert want.decode().count("\n") == n


@pytest.mark.parametrize("level,native,xfl", [("1", True, 0), ("9", False, 2), ("01", False, 4)])
def test_gz_level_override_takes_the_python_writer(tmp_path, monkeypatch, level, native, xfl):
    monkeypatch.setenv("GRID_TPU_GZ_LEVEL", level)
    ids, scales, z, mask, means, col_vars = normalized_case(np.float64, r=8, n=6)
    sel = np.arange(8)
    path = tmp_path / "norm.tsv.gz"
    torch_formats.write_normalized_output(path, ids, scales, z, mask, means, col_vars, sel)
    nbr = tmp_path / "nbr.tsv.gz"
    idx = (np.arange(6)[:, None] + 1) % 6
    torch_formats.write_neighbors_dense(nbr, ids, scales, idx, np.ones((6, 1)))
    assert is_bgzf(path) == is_bgzf(nbr) == native
    # Python's gzip at the level asked for: 2 in the header's XFL byte for 9, 4 for 1
    assert path.read_bytes()[8] == nbr.read_bytes()[8] == xfl
    monkeypatch.setenv("GRID_TPU_NATIVE_WRITERS", "0")
    jax_formats.write_normalized_output(tmp_path / "jax.tsv.gz", ids, scales, z, mask, means,
                                        col_vars, sel)
    assert content(path) == content(tmp_path / "jax.tsv.gz")


@pytest.mark.parametrize("bad", [30, -1], ids=["past_the_end", "negative"])
def test_neighbor_index_out_of_range_raises(tmp_path, bad):
    idx = np.zeros((30, 2), np.int64)
    idx[7, 1] = bad
    with pytest.raises(OSError, match="code -3: a neighbor index is out of range"):
        torch_formats.write_neighbors_dense(tmp_path / "n.tsv.gz", [f"s{i}" for i in range(30)],
                                            np.ones(30), idx, np.ones((30, 2)))


def test_writer_that_cannot_open_raises(tmp_path):
    target = tmp_path / "a_directory.tsv.gz"
    target.mkdir()
    with pytest.raises(OSError, match="code -1: the file did not open"):
        torch_formats.write_neighbors_dense(target, ["a", "b"], [1.0, 2.0], [[1], [0]],
                                            [[0.5], [0.5]])


def test_native_writers_check_shapes(tmp_path):
    with pytest.raises(ValueError, match="write_neighbors_dense"):
        torch_formats.write_neighbors_dense(tmp_path / "n.tsv.gz", ["a", "b"], [1.0], [[1], [0]],
                                            [[0.5], [0.5]])


def test_bgzf_block_layout(tmp_path):
    """Each member of the native writers' output is a BGZF block: a gzip
    header with the BC field, at most 64 KiB, its size recorded in it."""
    n, k = 400, 50
    idx = (np.arange(n)[:, None] + np.arange(1, k + 1)) % n
    path = tmp_path / "n.tsv.gz"
    torch_formats.write_neighbors_dense(path, [f"s{i}" for i in range(n)], np.ones(n), idx,
                                        np.ones((n, k)))
    raw, off, blocks = path.read_bytes(), 0, 0
    while off < len(raw):
        assert raw[off:off + 4] == b"\x1f\x8b\x08\x04" and raw[off + 12:off + 14] == b"BC"
        bsize = struct.unpack_from("<H", raw, off + 16)[0] + 1
        assert bsize <= 65536
        off += bsize
        blocks += 1
    assert off == len(raw) and blocks > 3
