"""The multi-locus sweep of grid_tpu_torch against grid_tpu's, on the CPU.

Float64 unless a case names float32 (``docs/parity.md:23-30``): the bundled
catalog byte-equal to grid_tpu's and parsed alike; the multi-weight dipCN
(``dipcn_from_distances_multi``) and its 2-D panel form equal to grid_tpu's
(``ok`` exact, values within 1e-9; 1e-6 against float32 JAX), and to the
binary form per locus; ``run_multi_locus`` with ``platform: cpu`` writes
the same ``.GENE`` dipCN tables as grid_tpu's (1e-9) and the same haploid
tables at their written precision, batched or looped, on the resident
branch and on row panels. A kernel's failure inside a step propagates out
of the pipeline and out of the sweep; any other failure is logged and the
next step runs.
"""

import copy
import gzip
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import grid_tpu.data.loci as j_loci
from grid_tpu.ops.select import dipcn_from_distances_multi as j_dipcn_multi
from grid_tpu.ops.select import dipcn_from_distances_panels as j_dipcn_panels
from grid_tpu.steps.multilocus import locus_config as j_locus_config
from grid_tpu.steps.multilocus import run_multi_locus as j_run_multi_locus
from grid_tpu.synth import make_synthetic_cohort
from grid_tpu_torch import native
from grid_tpu_torch.data import loci
from grid_tpu_torch.io.formats import read_dipcn
from grid_tpu_torch.ops.gpu_select import dipcn_from_distances_multi_gpu, dipcn_multi_panels_gpu
from grid_tpu_torch.ops.knn import d2_matrix
from grid_tpu_torch.ops.select import (
    dipcn_from_distances,
    dipcn_from_distances_multi,
    dipcn_from_distances_panels,
)
from grid_tpu_torch.pipeline import run_wgs_pipeline
from grid_tpu_torch.steps import multilocus
from grid_tpu_torch.steps.multilocus import locus_config, run_multi_locus

GENES = ("GENEA", "GENEB", "GENEC")
SHARED = ("mosdepth_results_normalized.tsv.gz", "neighbor_coverage.zMax2.0.tsv.gz")
CATALOG = (
    "CHR\tBP_START_HG38\tBP_END_HG38\tSAMTOOLS_START_HG38\tSAMTOOLS_END_HG38\tIBD2R\tGENE\n"
    "6\t160605000\t160610000\t160605000\t160610000\t0.9\tGENEA\n"
    "6\t160607000\t160612000\t160607000\t160612000\t0.8\tGENEB\n"
    "6\t160610000\t160615000\t160610000\t160615000\t0.7\tGENEC\n"
)
DTYPES = {"f64": (np.float64, torch.float64), "f32": (np.float32, torch.float32)}


class Recorder:
    """A console that keeps what the pipeline logs."""

    def __init__(self):
        self.lines = []

    def print(self, msg, style=None):
        self.lines.append((str(msg), style))


# ---------------------------------------------------------------- catalog ---


@pytest.mark.parametrize("name", ["734_possible_coding_vntr_regions.IBD2R_gt_0.25.uniq.txt",
                                  "hardcoded_positions.txt"])
def test_bundled_tables_are_byte_copies(name):
    ours = Path(loci.__file__).parent / "files" / name
    theirs = Path(j_loci.__file__).parent / "files" / name
    assert ours.read_bytes() == theirs.read_bytes()


def test_catalog_loads_as_grid_tpu_s():
    table = loci.load_vntr_catalog()
    assert [tuple(x) for x in table] == [tuple(x) for x in j_loci.load_vntr_catalog()]
    assert len(table) == 734 and len({x.gene for x in table}) == 492
    assert loci.BUNDLED_CATALOG.name == j_loci.BUNDLED_CATALOG.name


def test_constants_equal_grid_tpu_s():
    assert tuple(loci.LPA_KIV2_HG38) == tuple(j_loci.LPA_KIV2_HG38)
    assert loci.KIV2_REPEAT_STARTS_HG38 == j_loci.KIV2_REPEAT_STARTS_HG38
    assert loci.KIV2_REPEAT_STARTS_HG19 == j_loci.KIV2_REPEAT_STARTS_HG19
    rows = [line.split() for line in
            loci.BUNDLED_HARDCODED_POSITIONS.read_text().splitlines()[1:] if line.strip()]
    assert tuple(int(r[0]) for r in rows) == loci.KIV2_REPEAT_STARTS_HG38
    assert tuple(int(r[1]) for r in rows) == loci.KIV2_REPEAT_STARTS_HG19


@pytest.mark.parametrize("gene", ["LPA", "ZNF286A", "AC005324.4,ZNF286A", "MUC1"])
def test_resolve_locus_as_grid_tpu(gene):
    got = loci.resolve_locus(gene)
    assert tuple(got) == tuple(j_loci.resolve_locus(gene))
    if gene == "LPA":
        assert tuple(got) == tuple(loci.LPA_KIV2_HG38)
    assert gene in got.gene.split(",") or got.gene == gene


@pytest.mark.parametrize("gene", ["LPa", "NOTAGENE"])
def test_resolve_unknown_raises_with_close_matches(gene):
    with pytest.raises(KeyError) as got:
        loci.resolve_locus(gene)
    with pytest.raises(KeyError) as want:
        j_loci.resolve_locus(gene)
    assert str(got.value) == str(want.value)
    assert "not in the VNTR catalog" in str(got.value)
    if gene == "LPa":
        assert "LPA" in str(got.value)


def test_resolve_from_another_catalog(tmp_path):
    path = tmp_path / "catalog.txt"
    path.write_text(CATALOG + "chr7\t1\tx\t1\t2\t0.5\tBAD\n7\t5\n")
    table = loci.load_vntr_catalog(path)
    assert [tuple(x) for x in table] == [tuple(x) for x in j_loci.load_vntr_catalog(path)]
    assert [x.gene for x in table] == list(GENES)
    assert tuple(loci.resolve_locus("GENEB", path)) == ("chr6", 160607000, 160612000, "GENEB")


# ------------------------------------------- dipcn_from_distances_multi ---


def _multi_inputs(dt, n=40, n_loci=5, seed=13):
    """Forced ties (z rounded to 1/4, one duplicated row), unusable columns,
    read-less rows that stay in the geometry, and a varying [N, L]
    sample_valid."""
    rng = np.random.default_rng(seed)
    zp = np.round(rng.normal(size=(n, 9)) * 4) / 4
    zp[7] = zp[3]
    usable = rng.random(n) > 0.25
    row_valid = usable | (rng.random(n) > 0.5)
    rnorm = rng.uniform(0.5, 2.0, (n, n_loci))
    nbr_w = rng.uniform(0.5, 2.0, (n, n_loci))
    valid = (rng.random((n, n_loci)) > 0.2) & usable[:, None]
    return [a.astype(dt) if a.dtype.kind == "f" else a
            for a in (zp, rnorm, nbr_w, usable, valid, row_valid)]


def _d2(zp, row_valid):
    ones = torch.ones(zp.shape, dtype=torch.bool)
    return d2_matrix(zp, ones, ones[0], float("inf"), row_valid=row_valid)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("k,n_nbr", [(10, 4), (20, 20), (39, 11), (12, 60)])
def test_dipcn_multi_matches_grid_tpu(dt, k, n_nbr):
    npdt, _ = DTYPES[dt]
    zp, rnorm, nbr_w, usable, valid, row_valid = _multi_inputs(npdt)
    t = [torch.from_numpy(a) for a in (zp, rnorm, nbr_w, usable, valid, row_valid)]
    d2 = _d2(t[0], t[5])
    got, gok = dipcn_from_distances_multi(d2, t[1], t[2], t[3], t[4], k=k, n_nbr=n_nbr)
    want, wok = j_dipcn_multi(jnp.asarray(d2.numpy()), jnp.asarray(rnorm), jnp.asarray(nbr_w),
                              jnp.asarray(usable), jnp.asarray(valid), k=k, n_nbr=n_nbr)
    wok = np.asarray(wok)
    np.testing.assert_array_equal(gok.numpy(), wok)
    assert wok.any() and not wok.all()
    np.testing.assert_allclose(got.numpy()[wok], np.asarray(want)[wok],
                               rtol=1e-9 if dt == "f64" else 1e-6)
    # per locus, the binary form on the same distances
    for j in range(rnorm.shape[1]):
        one, one_ok = dipcn_from_distances(d2, t[1][:, j], t[2][:, j], t[3], t[4][:, j], k=k,
                                           n_nbr=n_nbr)
        assert torch.equal(one_ok, gok[:, j])
        np.testing.assert_allclose(one.numpy()[one_ok.numpy()], got.numpy()[one_ok.numpy(), j],
                                   rtol=1e-12 if dt == "f64" else 1e-6)
    # the wrapper takes the plain version for CPU tensors, and counts nothing
    before = dipcn_from_distances_multi_gpu.launches
    again, again_ok = dipcn_from_distances_multi_gpu(d2, t[1], t[2], t[3], t[4], k=k,
                                                     n_nbr=n_nbr)
    assert torch.equal(again, got) and torch.equal(again_ok, gok)
    assert dipcn_from_distances_multi_gpu.launches == before


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("row_block", [16, 40, 512])
def test_dipcn_panels_2d_matches_grid_tpu(dt, row_block):
    """The 2-D rnorm form of the panel dipCN: 83 rows in panels of 16 (the
    last of 3) or 40 (the last of 3), row_valid wider than col_usable."""
    npdt, _ = DTYPES[dt]
    zp, rnorm, nbr_w, usable, valid, row_valid = _multi_inputs(npdt, n=83, n_loci=4, seed=3)
    assert (row_valid & ~usable).any()
    t = [torch.from_numpy(a) for a in (zp, rnorm, nbr_w, usable, valid, row_valid)]
    k, n_nbr = 20, 7
    got, gok = dipcn_from_distances_panels(t[0], t[1], t[2], t[3], t[4], k=k, n_nbr=n_nbr,
                                           row_block=row_block, row_valid=t[5])
    want, wok = j_dipcn_panels(jnp.asarray(zp), jnp.asarray(rnorm), jnp.asarray(nbr_w),
                               jnp.asarray(usable), jnp.asarray(valid), k=k, n_nbr=n_nbr,
                               row_block=row_block, row_valid=jnp.asarray(row_valid))
    wok = np.asarray(wok)
    assert got.shape == (83, 4)
    np.testing.assert_array_equal(gok.numpy(), wok)
    np.testing.assert_allclose(got.numpy()[wok], np.asarray(want)[wok],
                               rtol=1e-9 if dt == "f64" else 1e-6)
    # the card route's wrappers take their plain versions on CPU tensors
    route, route_ok = dipcn_multi_panels_gpu(t[0], t[1], t[2], t[3], t[4], k=k, n_nbr=n_nbr,
                                             row_block=row_block, row_valid=t[5])
    assert torch.equal(route, got) and torch.equal(route_ok, gok)


def test_dipcn_panels_2d_equal_the_resident_multi_core():
    """Panels of any height give the resident multi form on the same
    geometry; without row_valid the geometry is the rows valid for any
    locus."""
    zp, rnorm, nbr_w, usable, valid, row_valid = (
        torch.from_numpy(a) for a in _multi_inputs(np.float64, n=61, seed=9))
    want, wok = dipcn_from_distances_multi(_d2(zp, row_valid), rnorm, nbr_w, usable, valid,
                                           k=15, n_nbr=6)
    for row_block in (1, 7, 100):
        got, gok = dipcn_from_distances_panels(zp, rnorm, nbr_w, usable, valid, k=15, n_nbr=6,
                                               row_block=row_block, row_valid=row_valid)
        assert torch.equal(gok, wok)
        np.testing.assert_allclose(got[gok].numpy(), want[wok].numpy(), rtol=1e-12)
    any_valid = valid.any(dim=1)
    want, wok = dipcn_from_distances_multi(_d2(zp, any_valid), rnorm, nbr_w, usable, valid,
                                           k=15, n_nbr=6)
    got, gok = dipcn_from_distances_panels(zp, rnorm, nbr_w, usable, valid, k=15, n_nbr=6,
                                           row_block=16)
    assert torch.equal(gok, wok)
    np.testing.assert_allclose(got[gok].numpy(), want[wok].numpy(), rtol=1e-12)


# ------------------------------------------------------------ the sweep ---


def test_locus_config_equals_grid_tpu_s():
    base = {
        "output_dir": "out", "chrom": "chr1", "start_bp": 1, "end_bp": 2,
        "count_reads": {"run": False, "output_file_prefix": "read_counts"},
        "compute_ibs": {"run": True, "output_file_prefix": "ibs_neighbors", "focal_bp": 5},
        "compute_diploid_genotypes": {"run": True, "output_file_prefix": "diploid_genotypes"},
        "compute_haploid_genotypes": {"run": True, "output_file_prefix": "haploid_genotypes",
                                      "ibs_output": "ibs.tsv.gz"},
    }
    for gene in ("LPA", "ZNF286A"):
        locus = loci.resolve_locus(gene)
        got = locus_config(base, locus)
        assert got == j_locus_config(base, j_loci.resolve_locus(gene))
        assert got["compute_ibs"]["focal_bp"] == (locus.start + locus.end) // 2
        assert got["compute_haploid_genotypes"]["ibs_output"] is None
        assert got["compute_diploid_genotypes"]["output_file_prefix"] == (
            f"diploid_genotypes.{locus.gene.split(',')[0]}")
    assert base["compute_ibs"]["focal_bp"] == 5  # the base config is not touched
    off = copy.deepcopy(base)
    off["compute_ibs"]["run"] = False
    got = locus_config(off, loci.LPA_KIV2_HG38)
    assert got == j_locus_config(off, j_loci.LPA_KIV2_HG38)
    assert got["compute_haploid_genotypes"]["ibs_output"] == "ibs.tsv.gz"


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    base = tmp_path_factory.mktemp("multilocus")
    catalog = base / "catalog.txt"
    catalog.write_text(CATALOG)
    return make_synthetic_cohort(base / "cohort", n_samples=16, seed=5), catalog


def sweep_config(cohort, out, device):
    """The cohort's config pointed at ``out``, with one counts file per
    locus there: the cohort's counts times a per-locus factor; GENEB lacks
    one sample, so the loci fall in two usability groups."""
    cohort, _ = cohort
    cfg = copy.deepcopy(cohort["config"])
    out.mkdir(parents=True, exist_ok=True)
    cfg["output_dir"] = str(out)
    cfg["device"] = dict(device)
    lines = cohort["counts_file"].read_text().splitlines()
    for j, gene in enumerate(GENES):
        rows = [lines[0]] + [f"{sid}\t{int(float(c) * (0.7 + 0.3 * j))}"
                             for sid, c in (line.split("\t") for line in lines[1:])]
        if gene == "GENEB":
            del rows[3]
        (out / f"read_counts.{gene}.tsv").write_text("\n".join(rows) + "\n")
    return cfg


def dipcn_tables(out):
    return {gene: read_dipcn(out / f"diploid_genotypes.{gene}.tsv")[:2] for gene in GENES}


def haploid_values(path):
    lines = Path(path).read_text().splitlines()
    return lines[0], [ln.split("\t")[0] for ln in lines[1:]], np.array(
        [[float(v) for v in ln.split("\t")[1:]] for ln in lines[1:]])


def content(path) -> bytes:
    return gzip.open(path).read() if str(path).endswith(".gz") else Path(path).read_bytes()


@pytest.fixture(scope="module")
def sweeps(cohort, tmp_path_factory):
    """grid_tpu's sweep and the port's on the CPU, batched; returns the two
    output directories and the port's console."""
    base = tmp_path_factory.mktemp("sweeps")
    _, catalog = cohort
    j_run_multi_locus(sweep_config(cohort, base / "jax", {}), list(GENES), None, catalog)
    console = Recorder()
    got = run_multi_locus(sweep_config(cohort, base / "torch", {"platform": "cpu"}), list(GENES),
                          console, catalog)
    assert list(got) == list(GENES)
    return base / "jax", base / "torch", console


def test_sweep_dipcn_tables_match_grid_tpu(sweeps):
    jax_out, torch_out, console = sweeps
    want, got = dipcn_tables(jax_out), dipcn_tables(torch_out)
    for gene in GENES:
        assert got[gene][0] == want[gene][0]
        np.testing.assert_allclose(got[gene][1], want[gene][1], rtol=1e-9, atol=0)
        assert np.std(got[gene][1]) > 0
    assert len(got["GENEB"][0]) == len(got["GENEA"][0]) - 1
    msgs = [msg for msg, _ in console.lines]
    assert any(m.startswith("Batched dipCN: 3 loci in 2 device call(s) (N=16") for m in msgs)
    assert not [m for m, style in console.lines if style == "danger"]


def test_sweep_haploid_tables_and_shared_artifacts(sweeps):
    jax_out, torch_out, _ = sweeps
    for gene in GENES:
        name = f"haploid_genotypes.{gene}.tsv"
        head, ids, vals = haploid_values(torch_out / name)
        want_head, want_ids, want_vals = haploid_values(jax_out / name)
        assert head == want_head and ids == want_ids
        np.testing.assert_array_equal(np.isnan(vals), np.isnan(want_vals))
        np.testing.assert_allclose(vals, want_vals, rtol=0, atol=1e-9)  # equal at %.2f
    for name in SHARED:  # one copy each, unsuffixed
        assert (torch_out / name).exists() and (jax_out / name).exists()
        assert not list(torch_out.glob(name.replace(".tsv", ".GENE*.tsv")))
    assert content(torch_out / SHARED[0]) == content(jax_out / SHARED[0])
    assert not (torch_out / "diploid_genotypes.tsv").exists()
    assert sorted(p.name for p in torch_out.glob("*.GENE*")) == sorted(
        p.name for p in jax_out.glob("*.GENE*"))


@pytest.mark.parametrize("variant", ["looped", "panels"])
def test_sweep_variants_equal_the_batched_resident_run(cohort, sweeps, tmp_path, monkeypatch,
                                                       variant):
    """``batched=False`` (file-mode step 6 per locus) and the row-panel
    branch (the budget patched below the [N, N] matrix) write the batched
    resident run's tables."""
    _, torch_out, _ = sweeps
    _, catalog = cohort
    console = Recorder()
    cfg = sweep_config(cohort, tmp_path, {"platform": "cpu"})
    if variant == "panels":
        monkeypatch.setattr(multilocus, "D2_BUDGET_BYTES", 16 * 16 * 8 - 1)
    run_multi_locus(cfg, list(GENES), console, catalog, batched=variant == "panels")
    msgs = [msg for msg, _ in console.lines]
    batched = [m for m in msgs if m.startswith("Batched dipCN")]
    assert batched == ([] if variant == "looped" else [
        "Batched dipCN: 3 loci in 2 device call(s) (N=16, k=15, row panels)"])
    want, got = dipcn_tables(torch_out), dipcn_tables(tmp_path)
    for gene in GENES:
        assert got[gene][0] == want[gene][0]
        np.testing.assert_allclose(got[gene][1], want[gene][1], rtol=1e-9, atol=0)
        name = f"haploid_genotypes.{gene}.tsv"
        assert haploid_values(tmp_path / name)[1] == haploid_values(torch_out / name)[1]
        np.testing.assert_allclose(haploid_values(tmp_path / name)[2],
                                   haploid_values(torch_out / name)[2], rtol=0, atol=1e-9)


# ----------------------------------------- a kernel failure propagates ---


def test_device_failures_are_told_apart():
    assert native.is_device_failure(native.KernelError("launch"))
    assert native.is_device_failure(torch.cuda.OutOfMemoryError("oom"))
    assert issubclass(native.KernelError, RuntimeError)
    assert not native.is_device_failure(RuntimeError("other"))
    assert not native.is_device_failure(ValueError("input"))


@pytest.mark.parametrize("fault", [native.KernelError, ValueError])
def test_a_kernel_failure_in_a_file_mode_step_propagates(cohort, tmp_path, monkeypatch, fault):
    """A KernelError inside step 5 leaves run_wgs_pipeline; a ValueError
    there is logged and step 6 runs (and fails on the missing neighbors
    file, logged too), as in grid_tpu."""
    import grid_tpu_torch.pipeline as pipeline

    def fails(*args, **kwargs):
        raise fault("dipcn_select kernel launch failed: cudaError 719")

    monkeypatch.setattr(pipeline, "find_neighbors", fails)
    cfg = sweep_config(cohort, tmp_path, {"platform": "cpu"})
    console = Recorder()
    if fault is native.KernelError:
        with pytest.raises(native.KernelError, match="cudaError 719"):
            run_wgs_pipeline(console=console, config=cfg)
        assert not [m for m, style in console.lines if style == "danger"]
        return
    run_wgs_pipeline(console=console, config=cfg)
    failed = [m.split(":")[0] for m, style in console.lines if style == "danger"]
    assert failed[:2] == ["Failed to run neighbors", "Failed to run compute_diploid_genotypes"]


@pytest.mark.parametrize("where", ["shared", "batched", "per_locus"])
def test_a_kernel_failure_propagates_out_of_the_sweep(cohort, tmp_path, monkeypatch, where):
    import grid_tpu_torch.pipeline as pipeline

    def fails(*args, **kwargs):
        raise native.KernelError("kernel launch failed")

    if where == "shared":
        monkeypatch.setattr(pipeline, "normalize_mosdepth", fails)
    elif where == "batched":
        monkeypatch.setattr(multilocus, "dipcn_from_distances_multi_gpu", fails)
    else:
        monkeypatch.setattr(pipeline, "hi_inference", fails)
    _, catalog = cohort
    cfg = sweep_config(cohort, tmp_path, {"platform": "cpu"})
    with pytest.raises(native.KernelError):
        run_multi_locus(cfg, list(GENES), None, catalog)


# -------------------------------------------------------------- the CLI ---


def _yaml_config(cohort, out, device):
    import yaml

    cfg = sweep_config(cohort, out, device)
    path = out / "config.yaml"
    path.write_text(yaml.safe_dump(cfg, sort_keys=False))
    return path


def test_cli_loci_lists_the_catalog():
    from click.testing import CliRunner

    from grid_tpu_torch.cli import cli

    res = CliRunner().invoke(cli, ["loci", "--gene", "LPA"])
    assert res.exit_code == 0, res.output
    assert "LPA\tchr6:160605062-160647661" in res.output
    res = CliRunner().invoke(cli, ["loci", "--limit", "3"])
    assert res.exit_code == 0 and res.output.splitlines()[-1] == "... 731 more (raise --limit)"


def test_cli_multi_locus(cohort, sweeps, tmp_path):
    from click.testing import CliRunner

    from grid_tpu_torch.cli import cli

    _, catalog = cohort
    path = _yaml_config(cohort, tmp_path, {"platform": "cpu"})
    args = ["multi-locus", str(path), "--catalog", str(catalog)]
    for gene in GENES:
        args += ["--locus", gene]
    res = CliRunner().invoke(cli, args)
    assert res.exit_code == 0, res.output
    want, got = dipcn_tables(sweeps[1]), dipcn_tables(tmp_path)
    for gene in GENES:
        assert got[gene][0] == want[gene][0]
        np.testing.assert_allclose(got[gene][1], want[gene][1], rtol=1e-9, atol=0)
    res = CliRunner().invoke(cli, ["multi-locus", str(path), "--locus", "NOTAGENE"])
    assert res.exit_code != 0 and "not in the VNTR catalog" in str(res.exception)


def test_cli_wgs_locus(cohort, tmp_path):
    """``wgs --locus`` takes the window from the catalog: an unknown gene
    exits non-zero naming the catalog; LPA runs steps 4-7 on the cohort
    (its bins cover LPA's window)."""
    from click.testing import CliRunner

    from grid_tpu_torch.cli import cli

    cohort_dict, _ = cohort
    path = _yaml_config(cohort, tmp_path, {"platform": "cpu"})
    (tmp_path / "read_counts.tsv").write_bytes(cohort_dict["counts_file"].read_bytes())
    runner = CliRunner()
    res = runner.invoke(cli, ["wgs", str(path), "--locus", "NOTAGENE"])
    assert res.exit_code != 0 and "not in the VNTR catalog" in res.output
    assert not (tmp_path / "haploid_genotypes.tsv").exists()
    res = runner.invoke(cli, ["wgs", str(path), "--locus", "LPA"])
    assert res.exit_code == 0, res.output
    for name in (*SHARED, "diploid_genotypes.tsv", "haploid_genotypes.tsv"):
        assert (tmp_path / name).exists(), name
