"""The port's file-mode steps 4-7 against grid_tpu's on the same cohort files.

Both packages run ``run_wgs_pipeline`` with ``device.fused`` unset, so each
step reads the previous step's file. Gzipped artifacts are compared
decompressed. float64 on the CPU (``docs/parity.md:23-30``): the normalized
file is byte-identical; the neighbors file is byte-identical, and where it
is not, only because grid_tpu's ``lax.approx_max_k`` orders exact distance
ties otherwise on the CPU in float64 (ROADMAP queue 3): then it is held to
the tie rule of ``tests/torch_parity.py`` with tol 0; dipCN agrees to 1e-9;
the haploid table is byte-identical with ``exact_phasing`` and equal at
%.2f (1e-9) in Jacobi mode. float32 (port) against float32 (grid_tpu): z
within one %.2f quantum, neighbor lists under the tie rule, dipCN to 1e-5
on rows whose input sets agree.
"""

import copy
import gzip
import json
import shutil
import tomllib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import grid_tpu.pipeline as jax_pipeline
from grid_tpu.synth import make_synthetic_cohort
from grid_tpu_torch.io.formats import read_dipcn, read_neighbors, read_normalized_data
from grid_tpu_torch.pipeline import run_wgs_pipeline
from torch_parity import dipcn_sets_differ, neighbor_rows_differing

REPO = Path(__file__).resolve().parent.parent
ARTIFACTS = {
    "normalized": "mosdepth_results_normalized.tsv.gz",
    "neighbors": "neighbor_coverage.zMax2.0.tsv.gz",
    "dipcn": "diploid_genotypes.tsv",
    "haploid": "haploid_genotypes.tsv",
}
STEPS = ("normalize", "neighbors", "compute_diploid_genotypes", "compute_haploid_genotypes")
SPANS = ("normalize.stage", "normalize.device", "neighbors.read", "neighbors.device",
         "dipcn.read", "dipcn.stage", "dipcn.device", "haploid.phase")
QUANTUM = 0.01001  # one %.2f step, with room for the last digit of a float


def content(path) -> bytes:
    return gzip.open(path).read() if str(path).endswith(".gz") else Path(path).read_bytes()


class Recorder:
    """A console that keeps what the pipeline logs."""

    def __init__(self):
        self.lines = []

    def print(self, msg, style=None):
        self.lines.append((msg, style))

    def styled(self, *styles):
        return [msg for msg, style in self.lines if style in styles]


def run_config(cohort, out, device, counts=True, **sections):
    """The cohort's config pointed at ``out``, with a ``device`` section and
    per-section overrides; the counts file is copied in unless told not to."""
    cfg = copy.deepcopy(cohort["config"])
    out.mkdir(parents=True, exist_ok=True)
    cfg["output_dir"] = str(out)
    cfg["device"] = dict(device)
    for name, values in sections.items():
        cfg[name].update(values)
    if counts:
        (out / "read_counts.tsv").write_bytes(cohort["counts_file"].read_bytes())
    return cfg


def run_both(cohort, base, device=None, **sections):
    """grid_tpu's file-mode pipeline and the port's (on the CPU) on one
    cohort; returns the two output directories and timing dicts."""
    device = device or {}
    jax_cfg = run_config(cohort, base / "jax", device, **sections)
    t_jax = jax_pipeline.run_wgs_pipeline(console=None, config=jax_cfg)
    torch_cfg = run_config(cohort, base / "torch", {**device, "platform": "cpu"}, **sections)
    t_torch = run_wgs_pipeline(console=None, config=torch_cfg)
    return base / "jax", base / "torch", t_jax, t_torch


def neighbor_lists(out):
    """(sample IDs, [N, k] row indices, [N, k] written distances) of a
    neighbors file."""
    nbrs, _ = read_neighbors(out / ARTIFACTS["neighbors"])
    ids = list(nbrs)
    row = {s: i for i, s in enumerate(ids)}
    idx = np.array([[row[nid] for nid, _, _ in nbrs[s]] for s in ids])
    dist = np.array([[d for _, _, d in nbrs[s]] for s in ids])
    return ids, idx, dist


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    return make_synthetic_cohort(tmp_path_factory.mktemp("cohort"), n_samples=15, seed=21,
                                 missing_frac=0.02)


@pytest.fixture(scope="module")
def f64_runs(cohort, tmp_path_factory):
    return run_both(cohort, tmp_path_factory.mktemp("f64"))


@pytest.fixture(scope="module")
def f32_runs(cohort, tmp_path_factory):
    return run_both(cohort, tmp_path_factory.mktemp("f32"), device={"dtype": "float32"})


# ---------------------------------------------------------------- pipeline ---


def test_default_config_runs_file_mode_with_its_spans(f64_runs):
    """device.fused unset (the default): the four steps run one after
    another, each timed, and no fused step."""
    jax_out, torch_out, t_jax, t_torch = f64_runs
    for name in STEPS:
        assert name in t_jax and name in t_torch, name
    # index.run: false checks the (absent) alignment indexes, as grid_tpu does
    assert set(t_torch) == set(STEPS) | set(SPANS) | {"check_index"} and "check_index" in t_jax
    assert "fused_steps_4_7" not in t_torch
    assert json.loads((torch_out / "step_timings.json").read_text()) == t_torch
    state = json.loads((torch_out / ".grid_tpu_state.json").read_text())
    assert sorted(state) == sorted(STEPS)


def test_float64_normalized_is_byte_identical(f64_runs):
    jax_out, torch_out, _, _ = f64_runs
    assert content(torch_out / ARTIFACTS["normalized"]) == content(jax_out / ARTIFACTS["normalized"])


def test_float64_neighbors_identical_or_exact_ties(f64_runs):
    """Byte-identical where grid_tpu's selection keeps the column order of
    exact ties; otherwise every difference is an exact tie (tol 0) and the
    own scales and written distances per position are equal."""
    jax_out, torch_out, _, _ = f64_runs
    got, want = content(torch_out / ARTIFACTS["neighbors"]), content(jax_out / ARTIFACTS["neighbors"])
    if got == want:
        return
    ids, idx, dist = neighbor_lists(torch_out)
    j_ids, j_idx, j_dist = neighbor_lists(jax_out)
    assert ids == j_ids
    np.testing.assert_array_equal(dist, j_dist)
    neighbor_rows_differing(idx, dist, j_idx, j_dist, tol=0.0)


def test_float64_dipcn_within_1e9(f64_runs):
    jax_out, torch_out, _, _ = f64_runs
    j_ids, j_vals, _ = read_dipcn(jax_out / ARTIFACTS["dipcn"])
    t_ids, t_vals, _ = read_dipcn(torch_out / ARTIFACTS["dipcn"])
    assert t_ids == j_ids and len(t_ids) == 15
    np.testing.assert_allclose(t_vals, j_vals, rtol=1e-9, atol=0)


def haploid_cells(path):
    lines = Path(path).read_text().splitlines()
    return lines[0], [ln.split("\t")[0] for ln in lines[1:]], np.array(
        [[float(v) for v in ln.split("\t")[1:]] for ln in lines[1:]])


def test_float64_jacobi_haploid_within_1e9(f64_runs):
    jax_out, torch_out, _, _ = f64_runs
    j_head, j_ids, j_vals = haploid_cells(jax_out / ARTIFACTS["haploid"])
    t_head, t_ids, t_vals = haploid_cells(torch_out / ARTIFACTS["haploid"])
    assert (t_head, t_ids) == (j_head, j_ids)
    np.testing.assert_allclose(t_vals, j_vals, rtol=0, atol=1e-9, equal_nan=True)
    assert not np.isnan(t_vals[:, 1]).all()  # someone was phased


@pytest.mark.parametrize("method", ["ibs", "ibd"])
def test_exact_phasing_haploid_is_byte_identical(cohort, tmp_path, method):
    """``device.exact_phasing`` (which the fused path sends to the file-mode
    steps, with ``fused: true`` too) phases in the reference's order on the
    host: the haploid table is byte-identical."""
    hap = {"method": method, "ibd_output": str(cohort["ibd_file"])}
    jax_out, torch_out, _, t_torch = run_both(
        cohort, tmp_path, device={"fused": True, "exact_phasing": True},
        compute_haploid_genotypes=hap)
    assert "fused_steps_4_7" not in t_torch and "haploid.phase" in t_torch
    assert content(torch_out / ARTIFACTS["haploid"]) == content(jax_out / ARTIFACTS["haploid"])


def test_float32_within_contract(f32_runs):
    """grid_tpu's float32 file mode computes step 4 in float32 and steps
    5-7 in float64 (its steps 5-7 ignore device.dtype); the port computes
    all four in float32, as on the card."""
    jax_out, torch_out, _, _ = f32_runs
    j_ids, j_ratio, j_z, j_scales = read_normalized_data(jax_out / ARTIFACTS["normalized"])
    t_ids, t_ratio, t_z, t_scales = read_normalized_data(torch_out / ARTIFACTS["normalized"])
    assert t_ids == j_ids
    np.testing.assert_allclose(t_ratio, j_ratio, rtol=1e-5, equal_nan=True)
    np.testing.assert_array_equal(np.isnan(t_z), np.isnan(j_z))
    np.testing.assert_allclose(t_z[~np.isnan(t_z)], j_z[~np.isnan(j_z)], rtol=0, atol=QUANTUM)
    assert all(abs(t_scales[s] - j_scales[s]) <= QUANTUM for s in j_ids)

    ids, idx, dist = neighbor_lists(torch_out)
    _, j_idx, j_dist = neighbor_lists(jax_out)
    # the written distances are %.2f of d2 / (2 R_use): ties within a quantum
    neighbor_rows_differing(idx, dist, j_idx, j_dist, tol=QUANTUM)
    reads = {line.split("\t")[0] for line in (torch_out / "read_counts.tsv").read_text().splitlines()}
    usable = np.array([s in reads for s in ids])
    n_nbr = 300
    same = ~dipcn_sets_differ(idx, j_idx, usable, n_nbr)
    j_dip_ids, j_dip, _ = read_dipcn(jax_out / ARTIFACTS["dipcn"])
    t_dip_ids, t_dip, _ = read_dipcn(torch_out / ARTIFACTS["dipcn"])
    assert t_dip_ids == j_dip_ids
    keep = np.array([same[ids.index(s)] for s in t_dip_ids])
    assert keep.sum() >= len(keep) - 2
    np.testing.assert_allclose(np.array(t_dip)[keep], np.array(j_dip)[keep], rtol=1e-5)
    j_head, j_hids, j_hap = haploid_cells(jax_out / ARTIFACTS["haploid"])
    t_head, t_hids, t_hap = haploid_cells(torch_out / ARTIFACTS["haploid"])
    assert (t_head, t_hids) == (j_head, j_hids)
    np.testing.assert_allclose(t_hap, j_hap, rtol=0, atol=QUANTUM, equal_nan=True)


def test_no_platform_in_file_mode_wants_the_card(cohort, tmp_path):
    """The default config names no platform: the card, resolved before any
    step runs, so a machine without one raises instead of logging four
    failed steps."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    cfg = run_config(cohort, tmp_path, {})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_wgs_pipeline(console=None, config=cfg)
    assert not any((tmp_path / name).exists() for name in ARTIFACTS.values())


def test_float64_on_the_card_is_refused_before_any_step(cohort, tmp_path, monkeypatch):
    """The dtype is resolved on the card before any step, as the fused
    path resolves it, rather than inside a step whose failure is only
    logged. Every dtype is carried now: bfloat16 alone and with
    ``device.mesh_shape`` (the bf16 forms of the step's kernels and of the
    sharded step), and float64 with ``device.mesh_shape``, in both forms
    (the cross-mode Gram's and the multi-weight dipcn_select's float64
    forms): each resolves its dtype before any step (the multi-locus sweep
    is ``tests/test_torch_float64.py``'s)."""
    import grid_tpu_torch.pipeline as pipeline

    cuda = torch.device("cuda")
    monkeypatch.setattr(pipeline, "config_device", lambda config: cuda)

    class Resolved(Exception):
        pass

    real, seen = pipeline.compute_dtype, []

    def resolve(config, device):  # records the dtype, then stops before any step
        seen.append(real(config, device))
        raise Resolved

    monkeypatch.setattr(pipeline, "compute_dtype", resolve)
    for device in ({"dtype": "float64", "mesh_shape": [4]},
                   {"dtype": "float64", "mesh_shape": [4], "fused": True},
                   {"dtype": "bfloat16"}, {"dtype": "bfloat16", "fused": True},
                   {"dtype": "bfloat16", "mesh_shape": [2]},
                   {"dtype": "bfloat16", "mesh_shape": [2], "fused": True}):
        cfg = run_config(cohort, tmp_path, device)
        with pytest.raises(Resolved):
            run_wgs_pipeline(console=None, config=cfg)
    assert seen == [torch.float64, torch.float64] + [torch.bfloat16] * 4
    assert not any((tmp_path / name).exists() for name in ARTIFACTS.values())


# --------------------------------------------------------------------- CLI ---

STEP_COMMANDS = {  # command: (the artifact it writes, the files it reads)
    "normalize": ("normalized", []),
    "find-neighbors": ("neighbors", ["normalized"]),
    "compute-dipcn": ("dipcn", ["neighbors"]),
    "hi-inference": ("haploid", ["dipcn"]),
}


@pytest.mark.parametrize("command", sorted(STEP_COMMANDS))
def test_each_step_alone_through_its_command(cohort, f64_runs, tmp_path, command):
    """One step's command on its input files, copied from the port's
    pipeline run, writes that run's artifact again (decompressed bytes)."""
    import yaml
    from click.testing import CliRunner

    from grid_tpu_torch.cli import cli

    _, torch_out, _, _ = f64_runs
    artifact, inputs = STEP_COMMANDS[command]
    cfg = run_config(cohort, tmp_path / "out", {"platform": "cpu"})
    for name in inputs:
        shutil.copy(torch_out / ARTIFACTS[name], tmp_path / "out" / ARTIFACTS[name])
    config_file = tmp_path / "config.yaml"
    config_file.write_text(yaml.safe_dump(cfg, sort_keys=False))
    res = CliRunner().invoke(cli, [command, str(config_file)])
    assert res.exit_code == 0, res.output
    assert content(tmp_path / "out" / ARTIFACTS[artifact]) == content(torch_out / ARTIFACTS[artifact])
    written = {p.name for p in (tmp_path / "out").iterdir()} - {"read_counts.tsv"}
    assert written == {ARTIFACTS[n] for n in inputs} | {ARTIFACTS[artifact]}


def test_report_matches_grid_tpu_s(f64_runs):
    """``report`` on a finished run prints what grid_tpu's prints."""
    from click.testing import CliRunner

    from grid_tpu.cli import cli as jax_cli
    from grid_tpu_torch.cli import cli

    _, torch_out, _, _ = f64_runs
    got = CliRunner().invoke(cli, ["report", str(torch_out)])
    want = CliRunner().invoke(jax_cli, ["report", str(torch_out)])
    assert got.exit_code == want.exit_code == 0, got.output
    assert got.output == want.output
    assert "dipCN: n=15" in got.output and "haploid: n=15" in got.output
    assert "timings:" in got.output


def test_report_on_an_empty_directory(tmp_path):
    from click.testing import CliRunner

    from grid_tpu_torch.cli import cli

    res = CliRunner().invoke(cli, ["report", str(tmp_path)])
    assert res.exit_code == 0
    assert "no dipCN file" in res.output and "no haploid file" in res.output


# ----------------------------------------------------- fallback and resume ---


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "file_mode"])
def test_a_failing_step_is_logged_and_the_next_runs(cohort, tmp_path, fused):
    """No counts file: steps 4 and 5 write their files, step 6 fails and is
    logged at ``danger``, step 7 then fails on the missing dipCN file and is
    logged too; the run returns. With ``fused: true`` the fused step fails
    first, is logged at ``warning``, and the same sequential steps follow."""
    cfg = run_config(cohort, tmp_path, {"fused": fused, "platform": "cpu"}, counts=False)
    console = Recorder()
    timings = run_wgs_pipeline(console=console, config=cfg)
    assert (tmp_path / ARTIFACTS["normalized"]).exists() and (tmp_path / ARTIFACTS["neighbors"]).exists()
    assert not (tmp_path / ARTIFACTS["dipcn"]).exists()
    assert not (tmp_path / ARTIFACTS["haploid"]).exists()
    danger = console.styled("danger")
    assert [m.split(":")[0] for m in danger] == ["Failed to run compute_diploid_genotypes",
                                                  "Failed to run compute_haploid_genotypes"]
    assert "read_counts.tsv" in danger[0] and "diploid_genotypes.tsv" in danger[1]
    fell_back = [m for m in console.styled("warning") if m.startswith("Fused steps 4-7 failed")]
    assert len(fell_back) == int(fused)
    assert "normalize" in timings and "neighbors" in timings
    state = json.loads((tmp_path / ".grid_tpu_state.json").read_text())
    assert sorted(state) == ["neighbors", "normalize"]


@pytest.mark.parametrize("on_card,fault,falls_back", [
    (True, "kernel", False), (False, "kernel", True), (True, "counts", True)],
    ids=["card_kernel_raises", "cpu_kernel_falls_back", "card_input_falls_back"])
def test_fused_fallback_on_the_card_takes_input_errors_only(cohort, tmp_path, monkeypatch,
                                                            on_card, fault, falls_back):
    """With the device resolved to the card, a kernel that fails inside the
    fused step propagates out of the pipeline (the file-mode steps would
    compute its work without it); a counts file that cannot be read is an
    input error and still falls back. On the CPU any failure falls back, as
    in grid_tpu. The pipeline's device is patched; the steps run on the CPU."""
    import grid_tpu_torch.models.cohort as cohort_mod
    import grid_tpu_torch.pipeline as pipeline

    if on_card:
        monkeypatch.setattr(pipeline, "config_device", lambda config: torch.device("cuda"))
        monkeypatch.setattr(pipeline, "compute_dtype", lambda config, device: torch.float32)
    if fault == "kernel":
        def launch_fails(*args, **kwargs):
            raise RuntimeError("dipcn_select kernel launch failed")
        monkeypatch.setattr(cohort_mod, "dipcn_from_distances_gpu", launch_fails)
    cfg = run_config(cohort, tmp_path, {"fused": True, "platform": "cpu"},
                     counts=fault != "counts")
    console = Recorder()
    if not falls_back:
        with pytest.raises(RuntimeError, match="dipcn_select kernel launch failed"):
            run_wgs_pipeline(console=console, config=cfg)
        assert not [m for m in console.styled("warning", "danger") if "failed" in m.lower()]
        return
    timings = run_wgs_pipeline(console=console, config=cfg)
    fell_back = [m for m in console.styled("warning") if m.startswith("Fused steps 4-7 failed")]
    assert len(fell_back) == 1
    assert ("kernel launch failed" if fault == "kernel" else "read_counts.tsv") in fell_back[0]
    assert "normalize" in timings and "neighbors" in timings


def test_resume_across_forms(cohort, tmp_path):
    """A fused run's state lets a file-mode ``resume: true`` run skip all
    four steps; a changed read-count file makes steps 6-7 run again in
    file mode, and the whole fused step again in the fused form; a file-mode
    run's state lets a fused ``resume: true`` run skip."""
    cfg = run_config(cohort, tmp_path, {"fused": True, "platform": "cpu"})
    assert "fused_steps_4_7" in run_wgs_pipeline(console=None, config=cfg)
    stamps = {name: (tmp_path / name).stat().st_mtime_ns for name in ARTIFACTS.values()}
    file_cfg = {**cfg, "resume": True, "device": {"platform": "cpu"}}
    console = Recorder()
    # only step 1's index check runs again (it keeps no resume state)
    assert set(run_wgs_pipeline(console=console, config=file_cfg)) == {"check_index"}
    assert [m for m in console.styled("info") if "skipped (resume)" in m] == [
        f"[{name}] up-to-date, skipped (resume)" for name in STEPS]
    assert stamps == {name: (tmp_path / name).stat().st_mtime_ns for name in ARTIFACTS.values()}

    counts = tmp_path / "read_counts.tsv"
    original = counts.read_text()
    counts.write_text(original.replace("SYN00003\t", "SYN00003\t1"))
    ran = run_wgs_pipeline(console=None, config=file_cfg)
    assert set(ran) & set(STEPS) == {"compute_diploid_genotypes", "compute_haploid_genotypes"}
    # the file-mode state now skips a fused resume run ...
    assert set(run_wgs_pipeline(console=None, config={**cfg, "resume": True})) == {"check_index"}
    # ... until the counts change again
    counts.write_text(original)
    assert "fused_steps_4_7" in run_wgs_pipeline(console=None, config={**cfg, "resume": True})


# -------------------------------------------------------------------- ops ---


def _jax_select():
    from grid_tpu.ops.knn import filter_regions_by_variance
    from grid_tpu.ops.normalize import select_high_variance_indices

    return select_high_variance_indices, filter_regions_by_variance


RATIO_CASES = {
    "random": np.random.default_rng(0).uniform(0, 200, 40),
    "nan": np.where(np.arange(40) % 7 == 0, np.nan,
                    np.random.default_rng(1).uniform(0, 200, 40)),
    "all_nan": np.full(12, np.nan),
    "ties": np.repeat([5.0, 7.0, 7.0, 9.0, np.nan], 6),
    "inf": np.array([1.0, np.inf, 3.0, -np.inf, 2.0, 1500.0, np.nan, 3.0]),
    "empty": np.array([]),
}


@pytest.mark.parametrize("case", sorted(RATIO_CASES))
@pytest.mark.parametrize("frac", [0.0, 0.1, 0.5, 1.0])
def test_host_region_selection_matches_grid_tpu(case, frac):
    from grid_tpu_torch.ops.knn import filter_regions_by_variance
    from grid_tpu_torch.ops.normalize import select_high_variance_indices

    j_select, j_filter = _jax_select()
    ratios = RATIO_CASES[case]
    got = select_high_variance_indices(ratios, frac)
    np.testing.assert_array_equal(got, j_select(ratios, frac))
    got_idx, got_r = filter_regions_by_variance(ratios, frac, 1000.0)
    want_idx, want_r = j_filter(ratios, frac, 1000.0)
    np.testing.assert_array_equal(got_idx, want_idx)
    assert got_r == want_r


@pytest.mark.parametrize("r,frac_r,ranks", [(1000, 0.9, (99, 100)), (1000, 0.5, (500, 500)),
                                             (37, 0.3, (25, 25))])
def test_region_filter_ranks_of_the_two_forms(r, frac_r, ranks):
    """Each region filter matches its grid_tpu twin: the file step's takes
    the rank in float64, the fused step's mask in float32, so at R=1000,
    frac_r=0.9 the file form's bound is the 100th ratio and the fused form's
    the 101st (one region fewer), in both packages alike."""
    from grid_tpu.ops.knn import filter_regions_by_variance as j_filter
    from grid_tpu.ops.knn import region_filter_mask as j_mask
    from grid_tpu_torch.ops.knn import filter_regions_by_variance, region_filter_mask

    ratios = np.random.default_rng(r).permutation(np.arange(r, dtype=np.float64))  # rank = value
    idx, r_use = filter_regions_by_variance(ratios, frac_r, 2.0 * r)
    want_idx, want_r = j_filter(ratios, frac_r, 2.0 * r)
    np.testing.assert_array_equal(idx, want_idx)
    assert r_use == want_r == r - ranks[0]
    assert ratios[idx].min() == ranks[0]
    mask = region_filter_mask(torch.from_numpy(ratios), frac_r, 2.0 * r).numpy()
    np.testing.assert_array_equal(mask, np.asarray(j_mask(jnp.asarray(ratios), frac_r, 2.0 * r)))
    assert mask.sum() == r - ranks[1]


def test_knn_squared_on_prepared_z_matches_the_host_reference():
    """The file-mode neighbors step's route (split + Gram panels + stable
    selection) against grid_tpu's float64 host reference, with exact ties."""
    from grid_tpu.ops.knn import knn_squared_host
    from grid_tpu_torch.ops.knn import knn_squared

    z = np.round(np.random.default_rng(4).normal(size=(70, 11)) * 4) / 4
    want_d, want_i = knn_squared_host(z, 12)
    got_d, got_i = knn_squared(torch.tensor(z), 12, row_block=16)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_allclose(got_d.numpy(), want_d, rtol=0, atol=1e-12)


@pytest.mark.parametrize("n_nbr", [1, 3, 8])
def test_compute_dipcn_matches_grid_tpu(n_nbr):
    from grid_tpu.ops.dipcn import compute_dipcn as j_dipcn
    from grid_tpu_torch.ops.dipcn import compute_dipcn

    rng = np.random.default_rng(n_nbr)
    n, k = 25, 6
    rnorm = rng.uniform(0.5, 2.0, n)
    valid = rng.random(n) > 0.2
    contrib = rng.uniform(0.5, 2.0, (n, k))
    usable = rng.random((n, k)) > 0.3
    usable[3] = False  # a row with no usable neighbor
    got = compute_dipcn(*(torch.tensor(a) for a in (rnorm, valid, contrib, usable)), n_nbr=n_nbr)
    want = j_dipcn(*(jnp.asarray(a) for a in (rnorm, valid, contrib, usable)), n_nbr=n_nbr)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    ok = got[1].numpy()
    assert not ok[3]
    np.testing.assert_allclose(got[0].numpy()[ok], np.asarray(want[0])[ok], rtol=1e-12)


def _ragged(seed, n, max_nbr, max_deg=None):
    rng = np.random.default_rng(seed)
    max_deg = max_nbr if max_deg is None else max_deg
    irrs = list(rng.uniform(1.0, 6.0, n))
    hap_nbrs = [[(int(rng.integers(0, 2 * n)), float(rng.uniform(0.1, 1.0)))
                 for _ in range(int(rng.integers(0, max_deg + 1)))] for _ in range(2 * n)]
    return irrs, hap_nbrs


def test_gauss_seidel_host_is_grid_tpu_s():
    from grid_tpu.ops import phasing as jp
    from grid_tpu_torch.ops import phasing as tp

    irrs, hap_nbrs = _ragged(5, 40, 4)
    for min_nbr, n_iters in ((1, 0), (1, 30), (2, 12)):
        got = tp.phase_gauss_seidel_host(irrs, hap_nbrs, min_nbr, n_iters)
        want = jp.phase_gauss_seidel_host(irrs, hap_nbrs, min_nbr, n_iters)
        assert np.array_equal(got[0], want[0], equal_nan=True) and got[1:] == want[1:]
        for i in range(len(irrs)):
            assert tp.compute_imputed_host(i, got[0], hap_nbrs, got[1]) == \
                jp.compute_imputed_host(i, want[0], hap_nbrs, want[1])


# -------------------------------------------------------------- bootstrap ---


def _boot_inputs(max_deg=4, seed=9, n=30, max_nbr=4):
    from grid_tpu_torch.io.hap_neighbors import pad_hap_neighbors

    irrs, hap_nbrs = _ragged(seed, n, max_nbr, max_deg)
    return np.asarray(irrs), pad_hap_neighbors(hap_nbrs, max_nbr, dtype=np.float64)


def test_bootstrap_slots_lie_below_each_degree():
    from grid_tpu_torch.ops.phasing import bootstrap_slots

    _, (_, _, hv) = _boot_inputs()
    valid = torch.tensor(hv)
    slots = bootstrap_slots(valid, 400, torch.Generator().manual_seed(1))
    deg = valid.sum(dim=1)
    assert slots.shape == (400, *hv.shape) and slots.dtype == torch.int64
    assert (slots >= 0).all() and (slots < deg.clamp_min(1)[None, :, None]).all()
    # uniform over [0, deg): each slot of a degree-4 row about 1/4 of the draws
    rows = deg == 4
    share = torch.stack([(slots[:, rows] == s).double().mean() for s in range(4)])
    assert torch.allclose(share, torch.full((4,), 0.25, dtype=torch.float64), atol=0.02)
    again = bootstrap_slots(valid, 400, torch.Generator().manual_seed(1))
    assert torch.equal(slots, again)


def test_bootstrap_replicates_equal_grid_tpu_phasing_on_the_same_slots():
    """Each replicate, given the slots, is grid_tpu's phase_haplotypes on
    the resampled neighbors (float64, to 1e-12)."""
    from grid_tpu.ops.phasing import phase_haplotypes as j_phase
    from grid_tpu_torch.ops.phasing import bootstrap_slots, phase_bootstrap_slots

    irrs, (hi, hw, hv) = _boot_inputs()
    t = [torch.tensor(a) for a in (irrs, hi, hw, hv)]
    slots = bootstrap_slots(t[3], 6, torch.Generator().manual_seed(2))
    mean, std, boot = phase_bootstrap_slots(*t, slots, 1, 25)
    for b in range(6):
        s = slots[b].numpy()
        want = j_phase(jnp.asarray(irrs), jnp.asarray(np.take_along_axis(hi, s, 1)),
                       jnp.asarray(np.take_along_axis(hw, s, 1)), jnp.asarray(hv), 1, 25)
        np.testing.assert_allclose(boot[b].numpy(), np.asarray(want.hap_irrs), rtol=1e-12,
                                   equal_nan=True)
    np.testing.assert_allclose(mean.numpy(), boot.numpy().mean(axis=0), rtol=1e-12)
    np.testing.assert_allclose(std.numpy(), boot.numpy().std(axis=0), rtol=1e-9, atol=1e-15)


def test_bootstrap_with_every_degree_at_most_one_is_the_plain_phasing():
    """With at most one neighbor per haplotype every replicate is the plain
    phasing, and the two packages agree exactly."""
    from grid_tpu.ops.phasing import phase_bootstrap as j_boot
    from grid_tpu_torch.ops.phasing import phase_bootstrap, phase_haplotypes

    irrs, (hi, hw, hv) = _boot_inputs(max_deg=1)
    t = [torch.tensor(a) for a in (irrs, hi, hw, hv)]
    plain = phase_haplotypes(*t, 1, 30).hap_irrs
    mean, std, boot = phase_bootstrap(torch.Generator().manual_seed(0), *t, 1, 30, n_boot=5)
    j_mean, j_std, j_boot_reps = j_boot(jax.random.PRNGKey(0), *(jnp.asarray(a) for a in
                                                                 (irrs, hi, hw, hv)), 1, 30, 5)
    assert all(torch.equal(boot[b].nan_to_num(), plain.nan_to_num()) for b in range(5))
    np.testing.assert_array_equal(boot.numpy(), np.asarray(j_boot_reps))
    np.testing.assert_allclose(mean.numpy(), np.asarray(j_mean), rtol=1e-15, equal_nan=True)
    np.testing.assert_allclose(std.numpy(), np.asarray(j_std), rtol=0, atol=1e-15, equal_nan=True)


def test_bootstrap_file(cohort, tmp_path):
    """``bootstrap_replicates`` writes the bootstrap table beside the
    haploid one, in grid_tpu's layout; the draws differ, the table's rows
    and its NaN cells do not."""
    hap = {"bootstrap_replicates": 8, "bootstrap_seed": 3}
    jax_out, torch_out, _, t_torch = run_both(cohort, tmp_path, compute_haploid_genotypes=hap)
    assert "haploid.bootstrap" in t_torch
    name = "haploid_genotypes_bootstrap.tsv"
    j_lines = (jax_out / name).read_text().splitlines()
    t_lines = (torch_out / name).read_text().splitlines()
    assert t_lines[0] == j_lines[0] == "ID\thap1_mean\thap1_sd\thap2_mean\thap2_sd"
    assert [ln.split("\t")[0] for ln in t_lines] == [ln.split("\t")[0] for ln in j_lines]
    got = np.array([[float(v) for v in ln.split("\t")[1:]] for ln in t_lines[1:]])
    want = np.array([[float(v) for v in ln.split("\t")[1:]] for ln in j_lines[1:]])
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert (got[~np.isnan(got)] >= 0).all()
    assert content(torch_out / ARTIFACTS["haploid"]) == content(jax_out / ARTIFACTS["haploid"])
    again = tmp_path / "again"
    run_wgs_pipeline(console=None, config=run_config(cohort, again, {"platform": "cpu"},
                                                     compute_haploid_genotypes=hap))
    assert (again / name).read_bytes() == (torch_out / name).read_bytes()  # the seed decides


# ------------------------------------------------------------ dipcn lists ---


def _tie_d2(dt, seed=1, n=97, r=16):
    """Forced ties (z rounded to 1/4), with whole-number weights so that
    every order of summing a take-set gives the same float."""
    from grid_tpu.ops.knn import d2_matrix as j_d2_matrix

    rng = np.random.default_rng(seed)
    zp = (np.round(rng.normal(size=(n, r)) * 4) / 4).astype(dt)
    rnorm = rng.integers(1, 9, n).astype(dt)
    w = rng.integers(1, 17, n).astype(dt)
    usable = rng.random(n) > 0.2
    valid = rng.random(n) > 0.1
    d2 = np.array(j_d2_matrix(jnp.asarray(zp), row_valid=jnp.asarray(valid)))
    return d2, rnorm, w, usable


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("k,n_nbr", [(1, 1), (20, 7), (60, 50), (96, 300)])
def test_dipcn_from_lists_on_forced_ties(dt, k, n_nbr):
    """The same take-sets as grid_tpu's dipcn_from_lists, and bit-equal to
    the port's own dipcn_from_distances. The weights are whole numbers, so a
    take-set's sum is exact in any order, and two sets that differ differ
    by at least 1 in 4,800; XLA rewrites the last two divisions, so the
    values from grid_tpu are held to 2 ulp, which only equal sets meet."""
    from grid_tpu.ops.select import dipcn_from_lists as j_lists
    from grid_tpu_torch.ops.knn import sorted_smallest_k
    from grid_tpu_torch.ops.select import dipcn_from_distances, dipcn_from_lists

    arrays = _tie_d2(dt)
    t_d2, t_rnorm, t_w, t_usable = (torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)
    d2, rnorm, w, usable = arrays
    sq, idx = sorted_smallest_k(t_d2, k)
    got, ok = dipcn_from_lists(t_d2, sq, idx, t_rnorm, t_w, t_usable, t_usable, k=k, n_nbr=n_nbr)
    want, wok = j_lists(jnp.asarray(d2), jnp.asarray(sq.numpy()), jnp.asarray(idx.numpy()),
                        jnp.asarray(rnorm), jnp.asarray(w), jnp.asarray(usable),
                        jnp.asarray(usable), k=k, n_nbr=n_nbr)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(wok))
    assert ok.sum() > 50
    eps = np.finfo(dt).eps
    np.testing.assert_allclose(got.numpy()[ok.numpy()], np.asarray(want)[ok.numpy()],
                               rtol=2 * eps, atol=0)
    scratch, sok = dipcn_from_distances(t_d2, t_rnorm, t_w, t_usable, t_usable, k=k, n_nbr=n_nbr)
    assert torch.equal(sok, ok) and torch.equal(scratch[sok], got[sok])


def _edge_lists(dt, case):
    """_tie_d2's inputs made to reach one edge of the list form: rows whose
    k-set holds no usable column (m_eff 0), rows with no valid sample, or
    k equal to W."""
    d2, rnorm, w, usable = _tie_d2(dt)
    n = d2.shape[0]
    valid = np.ones(n, bool)
    k, n_nbr = 12, 5
    if case == "m-eff-0":  # the 12 nearest of the first rows: all unusable
        for row in range(10):
            usable[np.argsort(d2[row], kind="stable")[:k]] = False
    elif case == "no-valid-sample":
        valid[::3] = False
    else:  # k = W, n_nbr above every row's usable count
        k, n_nbr = n, n + 5
    return d2, rnorm, w, usable, valid, k, n_nbr


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("case", ["m-eff-0", "no-valid-sample", "k-equals-w"])
def test_dipcn_from_lists_list_form_on_edge_rows(dt, case):
    """The list form (a gather over [N, k], a running count, a sum over the
    columns) gives grid_tpu's dipcn_from_lists at 2 ulp with the same
    validity, and the port's dipcn_from_distances bitwise, where m_eff is
    0, where the sample is not valid and at k = W. The weights are whole
    numbers, so the two packages sum the same set to the same float."""
    from grid_tpu.ops.select import dipcn_from_lists as j_lists
    from grid_tpu_torch.ops.knn import sorted_smallest_k
    from grid_tpu_torch.ops.select import dipcn_from_distances, dipcn_from_lists

    d2, rnorm, w, usable, valid, k, n_nbr = _edge_lists(dt, case)
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (d2, rnorm, w, usable, valid)]
    sq, idx = sorted_smallest_k(t[0], k)
    before = dipcn_from_lists.launches
    got, ok = dipcn_from_lists(t[0], sq, idx, *t[1:], k=k, n_nbr=n_nbr)
    assert dipcn_from_lists.launches == before  # counted on the card only
    want, wok = j_lists(jnp.asarray(d2), jnp.asarray(sq.numpy()), jnp.asarray(idx.numpy()),
                        jnp.asarray(rnorm), jnp.asarray(w), jnp.asarray(usable),
                        jnp.asarray(valid), k=k, n_nbr=n_nbr)
    wok = np.asarray(wok)
    np.testing.assert_array_equal(ok.numpy(), wok)
    if case == "m-eff-0":
        assert not wok[:10].any() and wok[10:].sum() > 50
    elif case == "no-valid-sample":
        assert not wok[::3].any() and wok.sum() > 50
    np.testing.assert_allclose(got.numpy()[wok], np.asarray(want)[wok],
                               rtol=2 * np.finfo(dt).eps, atol=0)
    scratch, sok = dipcn_from_distances(*t, k=k, n_nbr=n_nbr)
    assert torch.equal(sok, ok) and torch.equal(scratch[sok], got[sok])


@pytest.mark.parametrize("budget", [2 << 30, 0], ids=["resident", "panels"])
def test_cohort_step_with_dipcn_lists(budget):
    """``dipcn_lists=True`` equals grid_tpu's cohort step with it on the
    resident branch, and changes nothing on the panel branch (grid_tpu
    takes the lists only where d2 is resident)."""
    from grid_tpu.io.hap_neighbors import pad_hap_neighbors
    from grid_tpu.models.cohort import CohortParams as JaxParams, cohort_step as jax_step
    from grid_tpu_torch.convert import inputs_to_torch
    from grid_tpu_torch.models.cohort import CohortParams, cohort_step
    from grid_tpu_torch.synth import make_matrix

    values, mask, reads = make_matrix(60, 40, seed=5)
    reads_valid = np.arange(60) % 9 != 4
    hap = [[((h + 2) % 120, 1.0), ((h + 5) % 120, 0.5)] for h in range(120)]
    hi, hw, hv = pad_hap_neighbors(hap, 2, dtype=np.float64)
    fields = dict(num_neighbors=20, n_nbr=12, n_iters=5, quantize=True, d2_budget_bytes=budget)
    inputs = inputs_to_torch(values, mask, reads, reads_valid, hi, hw, hv, "cpu", torch.float64)
    got = cohort_step(*inputs, CohortParams(**fields, dipcn_lists=True))
    plain = cohort_step(*inputs, CohortParams(**fields))
    np.testing.assert_array_equal(got.dipcn_valid.numpy(), plain.dipcn_valid.numpy())
    ok = got.dipcn_valid.numpy()
    np.testing.assert_array_equal(got.dipcn.numpy()[ok], plain.dipcn.numpy()[ok])
    want = jax_step(*(jnp.asarray(a) for a in (values, mask, reads, reads_valid, hi, hw, hv)),
                    JaxParams(**fields, dipcn_lists=True))
    np.testing.assert_array_equal(ok, np.asarray(want.dipcn_valid))
    np.testing.assert_allclose(got.dipcn.numpy()[ok], np.asarray(want.dipcn)[ok], rtol=1e-9)
    np.testing.assert_array_equal(got.nbr_idx.numpy(), np.asarray(want.nbr_idx))


# ---------------------------------------------------------------- repairs ---


def test_dense_neighbors_writer_gives_grid_tpu_s_list_form(tmp_path):
    """The file-mode step writes with write_neighbors_dense where grid_tpu's
    writes the list form (``write_neighbors``): the same bytes after
    decompression, native and Python routes alike."""
    from grid_tpu.io.formats import write_neighbors
    from grid_tpu_torch import native_host
    from grid_tpu_torch.io.formats import write_neighbors_dense

    rng = np.random.default_rng(6)
    ids = [f"S{i:03d}" for i in range(23)]
    scales = np.round(rng.uniform(20, 40, 23), 2)
    idx = np.argsort(rng.random((23, 22)), axis=1)[:, :7]
    dists = rng.uniform(0, 3, (23, 7)).astype(np.float32)
    write_neighbors(tmp_path / "list.gz", ids, {s: float(v) for s, v in zip(ids, scales)},
                    [[ids[j] for j in row] for row in idx],
                    [[float(scales[j]) for j in row] for row in idx], [list(r) for r in dists])
    write_neighbors_dense(tmp_path / "dense.gz", ids, scales, idx, dists)
    assert content(tmp_path / "dense.gz") == content(tmp_path / "list.gz")
    original = native_host.lib
    native_host.lib = lambda: None
    try:
        write_neighbors_dense(tmp_path / "python.gz", ids, scales, idx, dists)
    finally:
        native_host.lib = original
    assert content(tmp_path / "python.gz") == content(tmp_path / "list.gz")


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_make_matrix_is_bench_s(seed):
    import sys

    sys.path.insert(0, str(REPO))
    try:
        from bench import make_matrix as bench_make_matrix
    finally:
        sys.path.remove(str(REPO))
    from grid_tpu_torch.synth import make_matrix

    for got, want in zip(make_matrix(37, 24, seed=seed), bench_make_matrix(37, 24, seed=seed)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_package_data_ships_every_source_under_csrc():
    """An installed wheel carries every kernel and host source, so it takes
    the native routes as a checkout does."""
    from fnmatch import fnmatch

    patterns = tomllib.loads((REPO / "pyproject.toml").read_text())["tool"]["setuptools"][
        "package-data"]["grid_tpu_torch"]
    root = REPO / "grid_tpu_torch"
    files = [p.relative_to(root).as_posix() for p in (root / "csrc").rglob("*") if p.is_file()]
    assert files and any(f.startswith("csrc/host/") for f in files)
    for f in files:
        assert any(fnmatch(f, pat) and f.count("/") == pat.count("/") for pat in patterns), f


def test_chip_smoke_imports_nothing_of_bench():
    text = (REPO / "chip_smoke.py").read_text()
    assert "from bench import" not in text and "import bench" not in text
    assert text.count("from grid_tpu_torch.synth import make_matrix") == 3
