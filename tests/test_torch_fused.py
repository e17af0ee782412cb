"""The port's fused WGS pipeline against grid_tpu's on the same cohort files.

Both packages read one synthetic cohort from disk and write their four
artifacts; gzipped artifacts are compared decompressed (a gzip header holds
a time). float64 on the CPU: the normalized, neighbors and haploid files are
byte-identical and dipCN agrees to 1e-9 (the two sum a row's neighbors in
another order, so the last digit of the full float repr may differ).
float32: z within one %.2f quantum, neighbor sets equal, dipCN within rtol
1e-6 (``docs/parity.md:23-30``).
"""

import copy
import gzip
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import grid_tpu.pipeline as jax_pipeline
from grid_tpu.synth import make_synthetic_cohort
from grid_tpu_torch.io.formats import read_dipcn, read_neighbors, read_normalized_data
from grid_tpu_torch.pipeline import run_wgs_pipeline
from grid_tpu_torch.utils.device import compute_dtype, config_device

ARTIFACTS = {
    "normalized": "mosdepth_results_normalized.tsv.gz",
    "neighbors": "neighbor_coverage.zMax2.0.tsv.gz",
    "dipcn": "diploid_genotypes.tsv",
    "haploid": "haploid_genotypes.tsv",
}
SPANS = ("fused.stage", "fused.device", "fused.phase", "fused.write", "fused_steps_4_7")


def content(path) -> bytes:
    return gzip.open(path).read() if str(path).endswith(".gz") else path.read_bytes()


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
    """Run grid_tpu's fused pipeline and the port's (on the CPU) on one
    cohort; returns the two output directories and timing dicts."""
    device = {"fused": True, **(device or {})}
    jax_cfg = run_config(cohort, base / "jax", device, **sections)
    t_jax = jax_pipeline.run_wgs_pipeline(console=None, config=jax_cfg)
    torch_cfg = run_config(cohort, base / "torch", {**device, "platform": "cpu"}, **sections)
    t_torch = run_wgs_pipeline(console=None, config=torch_cfg)
    return base / "jax", base / "torch", t_jax, t_torch


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


def test_fused_spans_and_timings_file(f64_runs):
    _, torch_out, t_jax, t_torch = f64_runs
    for span in SPANS:
        assert span in t_jax and span in t_torch, span
    # index.run: false checks the (absent) alignment indexes, as grid_tpu does
    assert set(t_torch) == set(SPANS) | {"check_index"} and "check_index" in t_jax
    assert json.loads((torch_out / "step_timings.json").read_text()) == t_torch


@pytest.mark.parametrize("artifact", ["normalized", "neighbors", "haploid"])
def test_float64_artifact_is_byte_identical(f64_runs, artifact):
    jax_out, torch_out, _, _ = f64_runs
    assert content(torch_out / ARTIFACTS[artifact]) == content(jax_out / ARTIFACTS[artifact])


def test_float64_dipcn_within_1e9(f64_runs):
    jax_out, torch_out, _, _ = f64_runs
    want_lines = (jax_out / ARTIFACTS["dipcn"]).read_text().splitlines()
    got_lines = (torch_out / ARTIFACTS["dipcn"]).read_text().splitlines()
    assert got_lines[0] == want_lines[0]
    j_ids, j_vals, _ = read_dipcn(jax_out / ARTIFACTS["dipcn"])
    t_ids, t_vals, _ = read_dipcn(torch_out / ARTIFACTS["dipcn"])
    assert t_ids == j_ids and len(t_ids) == 15
    np.testing.assert_allclose(t_vals, j_vals, rtol=1e-9, atol=0)


def test_float32_artifacts_within_contract(f32_runs):
    """grid_tpu's own float32 fused step fails under x64 on the CPU (its
    phasing scan mixes float32 values with float64 weights) and its
    pipeline falls back to the file-mode steps, so this holds the port's
    float32 fused steps to grid_tpu's float32 file pipeline."""
    jax_out, torch_out, _, t_torch = f32_runs
    assert "fused_steps_4_7" in t_torch
    j_ids, j_ratio, j_z, j_scales = read_normalized_data(jax_out / ARTIFACTS["normalized"])
    t_ids, t_ratio, t_z, t_scales = read_normalized_data(torch_out / ARTIFACTS["normalized"])
    assert t_ids == j_ids
    first_lines = [content(d / ARTIFACTS["normalized"]).split(b"\n")[0] for d in (jax_out, torch_out)]
    assert first_lines[0].split(b"\t")[:2] == first_lines[1].split(b"\t")[:2]
    np.testing.assert_allclose(t_ratio, j_ratio, rtol=1e-5, equal_nan=True)
    np.testing.assert_array_equal(np.isnan(t_z), np.isnan(j_z))
    np.testing.assert_allclose(t_z[~np.isnan(t_z)], j_z[~np.isnan(j_z)], rtol=0, atol=0.01001)
    for sid in j_ids:
        assert abs(t_scales[sid] - j_scales[sid]) <= 0.01001
    j_nbrs, _ = read_neighbors(jax_out / ARTIFACTS["neighbors"])
    t_nbrs, _ = read_neighbors(torch_out / ARTIFACTS["neighbors"])
    assert list(t_nbrs) == list(j_nbrs)
    for sid in j_nbrs:
        assert {n for n, _, _ in t_nbrs[sid]} == {n for n, _, _ in j_nbrs[sid]}
    j_dip = read_dipcn(jax_out / ARTIFACTS["dipcn"])
    t_dip = read_dipcn(torch_out / ARTIFACTS["dipcn"])
    assert t_dip[0] == j_dip[0]
    np.testing.assert_allclose(t_dip[1], j_dip[1], rtol=1e-6, atol=0)
    j_hap = (jax_out / ARTIFACTS["haploid"]).read_text().splitlines()
    t_hap = (torch_out / ARTIFACTS["haploid"]).read_text().splitlines()
    assert t_hap[0] == j_hap[0] and len(t_hap) == len(j_hap)
    for j_line, t_line in zip(j_hap[1:], t_hap[1:]):
        jp, tp = j_line.split("\t"), t_line.split("\t")
        assert jp[0] == tp[0]
        for a, b in zip(jp[1:], tp[1:]):
            assert (a == b) if "nan" in (a, b) else abs(float(a) - float(b)) <= 0.01001


@pytest.mark.parametrize("weighted", [False, True])
def test_ibd_method_matches(cohort, tmp_path, weighted):
    hap = {"method": "ibd", "ibd_output": str(cohort["ibd_file"]), "weighted": weighted}
    jax_out, torch_out, t_jax, _ = run_both(cohort, tmp_path, compute_haploid_genotypes=hap)
    assert "fused.phase" in t_jax
    assert content(torch_out / ARTIFACTS["haploid"]) == content(jax_out / ARTIFACTS["haploid"])
    phased = [line.split("\t")[2] for line in
              (torch_out / ARTIFACTS["haploid"]).read_text().splitlines()[1:]]
    assert any(v != "nan" for v in phased)


def test_sample_without_read_count(cohort, tmp_path):
    """A sample the counts file lacks has no dipCN row and no haploid row,
    but still appears in the normalized matrix and as a neighbor."""
    lines = cohort["counts_file"].read_text().splitlines(keepends=True)
    dropped = lines[4].split("\t")[0]
    device = {"fused": True}
    cfgs = {"jax": run_config(cohort, tmp_path / "jax", device),
            "torch": run_config(cohort, tmp_path / "torch", {**device, "platform": "cpu"})}
    for name in cfgs:
        (tmp_path / name / "read_counts.tsv").write_text("".join(lines[:4] + lines[5:]))
    jax_pipeline.run_wgs_pipeline(console=None, config=cfgs["jax"])
    run_wgs_pipeline(console=None, config=cfgs["torch"])
    for artifact in ("normalized", "neighbors", "haploid"):
        assert (content(tmp_path / "torch" / ARTIFACTS[artifact])
                == content(tmp_path / "jax" / ARTIFACTS[artifact])), artifact
    j_ids, j_vals, _ = read_dipcn(tmp_path / "jax" / ARTIFACTS["dipcn"])
    t_ids, t_vals, _ = read_dipcn(tmp_path / "torch" / ARTIFACTS["dipcn"])
    assert t_ids == j_ids and dropped not in t_ids and len(t_ids) == 14
    np.testing.assert_allclose(t_vals, j_vals, rtol=1e-9, atol=0)
    assert dropped in read_normalized_data(tmp_path / "torch" / ARTIFACTS["normalized"])[0]


def test_no_read_counts_at_all(cohort, tmp_path):
    """An empty dipCN-valid universe: phasing over zero samples writes the
    two headers and nothing else, in both packages."""
    device = {"fused": True}
    cfgs = {"jax": run_config(cohort, tmp_path / "jax", device),
            "torch": run_config(cohort, tmp_path / "torch", {**device, "platform": "cpu"})}
    for name in cfgs:
        (tmp_path / name / "read_counts.tsv").write_text("Sample\tchr6:1-2\n")
    jax_pipeline.run_wgs_pipeline(console=None, config=cfgs["jax"])
    run_wgs_pipeline(console=None, config=cfgs["torch"])
    for name in ARTIFACTS.values():
        assert content(tmp_path / "torch" / name) == content(tmp_path / "jax" / name), name
    assert (tmp_path / "torch" / ARTIFACTS["dipcn"]).read_text() == "Sample\tNorm_Reads\n"


@pytest.mark.parametrize("device", [{"use_pallas": True}, {"streaming_stage": "true"}],
                         ids=["use_pallas", "streaming_stage"])
def test_device_keys_that_change_no_artifact(cohort, f64_runs, tmp_path, device):
    """``use_pallas`` is accepted and ignored (the hand kernels are always
    the path on the card); the streaming stager stages the same arrays."""
    _, base_out, _, _ = f64_runs
    cfg = run_config(cohort, tmp_path, {"fused": True, "platform": "cpu", **device})
    run_wgs_pipeline(console=None, config=cfg)
    for name in ARTIFACTS.values():
        assert content(tmp_path / name) == content(base_out / name), name


def test_fused_failure_raises(cohort, tmp_path):
    """No counts file: the fused step raises inside the pipeline, which logs
    it at ``warning`` and falls back to the file-mode steps, as grid_tpu
    does; steps 4-5 write their files, steps 6-7 fail and are logged at
    ``danger``, and nothing is written in the fused form."""
    cfg = run_config(cohort, tmp_path, {"fused": True, "platform": "cpu"}, counts=False)
    console = Recorder()
    timings = run_wgs_pipeline(console=console, config=cfg)
    warned = [msg for msg, style in console.lines if style == "warning"
              and msg.startswith("Fused steps 4-7 failed")]
    assert len(warned) == 1 and "read_counts.tsv" in warned[0]
    assert warned[0].endswith("falling back to sequential steps")
    failed = [msg.split(":")[0] for msg, style in console.lines if style == "danger"]
    assert failed == ["Failed to run compute_diploid_genotypes",
                      "Failed to run compute_haploid_genotypes"]
    assert "fused.device" not in timings and "normalize" in timings and "neighbors" in timings
    assert [name for name in ARTIFACTS.values() if (tmp_path / name).exists()] == [
        ARTIFACTS["normalized"], ARTIFACTS["neighbors"]]


RING = {"fused": True, "mesh_shape": [4], "dispatch": "ring"}


@pytest.fixture(scope="module")
def ring_runs(cohort, tmp_path_factory):
    """grid_tpu's pipeline on its virtual devices and the port's on four
    gloo ranks on the CPU, with the ring config."""
    return run_both(cohort, tmp_path_factory.mktemp("ring"), device=RING)


@pytest.mark.parametrize("artifact", ["normalized", "neighbors", "haploid"])
def test_ring_config_artifact_is_grid_tpu_s(ring_runs, artifact):
    """``mesh_shape: [4]`` with ``dispatch: ring`` runs the sharded step on
    four ranks and writes grid_tpu's ring artifacts, byte for byte."""
    jax_out, torch_out, _, t_torch = ring_runs
    assert "fused.device" in t_torch and "fused_steps_4_7" in t_torch
    assert content(torch_out / ARTIFACTS[artifact]) == content(jax_out / ARTIFACTS[artifact])


def test_ring_config_dipcn_within_1e9_of_grid_tpu_s_and_the_flat_run_s(ring_runs, f64_runs):
    jax_out, torch_out, _, _ = ring_runs
    flat_out = f64_runs[1]
    j_ids, j_vals, _ = read_dipcn(jax_out / ARTIFACTS["dipcn"])
    for out in (torch_out, flat_out):
        t_ids, t_vals, _ = read_dipcn(out / ARTIFACTS["dipcn"])
        assert t_ids == j_ids and len(t_ids) == 15
        np.testing.assert_allclose(t_vals, j_vals, rtol=1e-9, atol=0)


def test_auto_at_the_crossover_runs_the_ring_in_both_packages(cohort, f64_runs, tmp_path,
                                                              monkeypatch):
    """Under ``auto``, with the crossover patched down to the cohort's 15
    samples, both packages take the ring (no flat-branch log line) on a
    two-device mesh and write the same artifacts, which equal the flat
    run's."""
    import grid_tpu.parallel.policy as jax_policy
    import grid_tpu_torch.pipeline as pipeline
    import grid_tpu_torch.steps.fused as fused

    def crossover_15(n, n_devices, dispatch="auto"):
        return "ring" if n_devices > 1 and dispatch != "flat" and n >= 15 else "flat"

    for module in (pipeline, fused, jax_policy):
        monkeypatch.setattr(module, "choose_cohort_execution", crossover_15)
    consoles = {"jax": Recorder(), "torch": Recorder()}
    device = {"fused": True, "mesh_shape": [2]}
    jax_pipeline.run_wgs_pipeline(console=consoles["jax"],
                                  config=run_config(cohort, tmp_path / "jax", device))
    run_wgs_pipeline(console=consoles["torch"],
                     config=run_config(cohort, tmp_path / "torch", {**device, "platform": "cpu"}))
    for c in consoles.values():
        assert not [msg for msg, _ in c.lines if msg.startswith("dispatch policy:")]
    assert "sharded step: 2 rank(s) on the CPU, transport gloo" in [
        msg for msg, _ in consoles["torch"].lines]
    for artifact in ("normalized", "neighbors", "haploid"):
        name = ARTIFACTS[artifact]
        assert content(tmp_path / "torch" / name) == content(tmp_path / "jax" / name), artifact
        assert content(tmp_path / "torch" / name) == content(f64_runs[1] / name), artifact


def test_a_failing_rank_raises_and_writes_no_artifact(cohort, tmp_path, monkeypatch):
    """A rank that raises makes the parent raise RankFailure with the
    rank's error; the pipeline does not hand the ring's failure to the
    file-mode steps, and nothing is written."""
    import grid_tpu_torch.parallel.pcohort as pcohort
    import torch_ranks
    from grid_tpu_torch.parallel import RankFailure

    monkeypatch.setattr(pcohort, "_rank_step", torch_ranks.rank_step_failing_on_rank_1)
    cfg = run_config(cohort, tmp_path, {**RING, "platform": "cpu"})
    with pytest.raises(RankFailure, match="rank 1 fails on purpose"):
        run_wgs_pipeline(console=None, config=cfg)
    assert not any((tmp_path / name).exists() for name in ARTIFACTS.values())


POLICY_CASES = [  # tests/test_parallel.py's TestDispatchPolicy cases
    ((8_192, 8), "flat"), ((32_768, 8), "ring"), ((1_000_000, 1), "flat"),
    ((100, 8, "ring"), "ring"), ((100_000, 8, "flat"), "flat"),
    ((100, 8, "fastest"), ValueError), ((100, 1, "ring"), ValueError),
    ((16_383, 8), "flat"), ((16_384, 8), "ring"),
]


@pytest.mark.parametrize("args,want", POLICY_CASES)
def test_dispatch_policy_equals_grid_tpu_s(args, want):
    from grid_tpu.parallel.policy import RING_CROSSOVER_N as JAX_CROSSOVER
    from grid_tpu.parallel.policy import choose_cohort_execution as jax_choose
    from grid_tpu_torch.parallel.policy import RING_CROSSOVER_N, choose_cohort_execution

    assert RING_CROSSOVER_N == JAX_CROSSOVER
    if want is ValueError:
        with pytest.raises(ValueError) as jax_err:
            jax_choose(*args)
        with pytest.raises(ValueError) as torch_err:
            choose_cohort_execution(*args)
        assert str(torch_err.value) == str(jax_err.value)
    else:
        assert choose_cohort_execution(*args) == jax_choose(*args) == want


@pytest.mark.parametrize("mesh_shape", [[1], [8]])
def test_mesh_below_the_crossover_runs_flat_as_grid_tpu(cohort, f64_runs, tmp_path, mesh_shape):
    """A configured mesh with N below the crossover (or a one-device mesh)
    runs the single-card step under ``dispatch: auto``, logs grid_tpu's
    line word for word, and writes grid_tpu's artifacts."""
    jax_out, _, _, _ = f64_runs
    consoles = {"jax": Recorder(), "torch": Recorder()}
    for name, run in (("jax", jax_pipeline.run_wgs_pipeline), ("torch", run_wgs_pipeline)):
        device = {"fused": True, "mesh_shape": mesh_shape}
        if name == "torch":
            device["platform"] = "cpu"
        timings = run(console=consoles[name],
                      config=run_config(cohort, tmp_path / name, device))
        assert "fused_steps_4_7" in timings and "fused.device" in timings
    said = {name: [msg for msg, style in c.lines if msg.startswith("dispatch policy:")]
            for name, c in consoles.items()}
    assert said["torch"] == said["jax"] == [
        f"dispatch policy: N=15 below ring crossover — running the single-device step despite "
        f"mesh_shape={mesh_shape}"]
    for artifact in ("normalized", "neighbors", "haploid"):
        name = ARTIFACTS[artifact]
        assert content(tmp_path / "torch" / name) == content(tmp_path / "jax" / name), artifact
        assert content(tmp_path / "torch" / name) == content(jax_out / name), artifact


def test_one_device_mesh_with_ring_raises_grid_tpu_s_value_error(cohort, tmp_path):
    from grid_tpu.parallel.policy import choose_cohort_execution as jax_choose

    with pytest.raises(ValueError) as want:
        jax_choose(15, 1, "ring")
    cfg = run_config(cohort, tmp_path, {"fused": True, "mesh_shape": [1], "dispatch": "ring",
                                        "platform": "cpu"})
    with pytest.raises(ValueError, match=str(want.value)):
        run_wgs_pipeline(console=None, config=cfg)
    assert not any((tmp_path / name).exists() for name in ARTIFACTS.values())


def apply_defaults_port(cfg):
    from grid_tpu_torch.config import apply_defaults

    return apply_defaults(copy.deepcopy(cfg))


FILE_MODE = {  # configs that raised before the file-mode steps were ported
    "file_mode": ({}, {"platform": "cpu"}),
    "exact_phasing": ({}, {"fused": True, "exact_phasing": True, "platform": "cpu"}),
    "one_step_off": ({"compute_haploid_genotypes": {"run": False}},
                     {"fused": True, "platform": "cpu"}),
}


@pytest.mark.parametrize("case", sorted(FILE_MODE))
def test_file_mode_configs_run_and_match_grid_tpu(cohort, tmp_path, case):
    """Without the fused path (no ``fused``, ``exact_phasing``, or a step
    switched off) the file-mode steps run, as in grid_tpu, and write its
    normalized file and dipCN table (dipCN to 1e-9) and, where step 7 runs,
    its haploid table (byte-identical in the exact mode)."""
    updates, device = FILE_MODE[case]
    outs = {}
    for name, run in (("jax", jax_pipeline.run_wgs_pipeline), ("torch", run_wgs_pipeline)):
        dev = dict(device) if name == "torch" else {k: v for k, v in device.items()
                                                     if k != "platform"}
        timings = run(console=None, config=run_config(cohort, tmp_path / name, dev, **updates))
        assert "fused_steps_4_7" not in timings and "compute_diploid_genotypes" in timings
        outs[name] = tmp_path / name
    assert (content(outs["torch"] / ARTIFACTS["normalized"])
            == content(outs["jax"] / ARTIFACTS["normalized"]))
    j_ids, j_vals, _ = read_dipcn(outs["jax"] / ARTIFACTS["dipcn"])
    t_ids, t_vals, _ = read_dipcn(outs["torch"] / ARTIFACTS["dipcn"])
    assert t_ids == j_ids and len(t_ids) == 15
    np.testing.assert_allclose(t_vals, j_vals, rtol=1e-9, atol=0)
    hap = [(outs[name] / ARTIFACTS["haploid"]) for name in ("torch", "jax")]
    if case == "one_step_off":
        assert not any(path.exists() for path in hap)
    elif case == "exact_phasing":
        assert content(hap[0]) == content(hap[1])
    else:
        assert hap[0].read_text().splitlines()[0] == hap[1].read_text().splitlines()[0]


def test_resume_skips_an_up_to_date_run(cohort, tmp_path):
    cfg = run_config(cohort, tmp_path, {"fused": True, "platform": "cpu"})
    first = run_wgs_pipeline(console=None, config=cfg)
    assert "fused_steps_4_7" in first
    stamps = {name: (tmp_path / name).stat().st_mtime_ns for name in ARTIFACTS.values()}
    cfg["resume"] = True
    # only step 1's index check runs again (it keeps no resume state)
    assert set(run_wgs_pipeline(console=None, config=cfg)) == {"check_index"}
    assert stamps == {name: (tmp_path / name).stat().st_mtime_ns for name in ARTIFACTS.values()}
    # a changed input invalidates the skip
    counts = tmp_path / "read_counts.tsv"
    counts.write_text(counts.read_text().replace("SYN00003\t", "SYN00003\t1"))
    assert "fused_steps_4_7" in run_wgs_pipeline(console=None, config=cfg)
    # and so does a missing artifact
    (tmp_path / ARTIFACTS["haploid"]).unlink()
    assert "fused_steps_4_7" in run_wgs_pipeline(console=None, config=cfg)
    assert (tmp_path / ARTIFACTS["haploid"]).exists()


def test_resume_state_is_grid_tpu_s(cohort, tmp_path):
    """The fused step records the four classic step names with grid_tpu's
    fingerprints, so either package can resume the other's outputs."""
    cfg = run_config(cohort, tmp_path, {"fused": True, "platform": "cpu"})
    run_wgs_pipeline(console=None, config=cfg)
    cfg["resume"] = True
    from grid_tpu.config import apply_defaults

    resume = jax_pipeline._Resume(apply_defaults(cfg))
    for name in ("normalize", "neighbors", "compute_diploid_genotypes",
                 "compute_haploid_genotypes"):
        assert resume.should_skip(name, apply_defaults(cfg)), name


def test_device_and_dtype_policy():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert config_device({"device": {"platform": "cpu"}}) == cpu
    with pytest.raises(ValueError, match="unknown device.platform"):
        config_device({"device": {"platform": "tpu"}})
    assert compute_dtype(None, cpu) is torch.float64
    assert compute_dtype({"device": {"dtype": "float32"}}, cpu) is torch.float32
    assert compute_dtype({"device": {"dtype": "auto"}}, cuda) is torch.float32
    assert compute_dtype({"device": {"dtype": "f32"}}, cuda) is torch.float32
    # float64 and bfloat16 run on the card, bfloat16 with mesh_shape as well
    assert compute_dtype({"device": {"dtype": "float64"}}, cuda) is torch.float64
    assert compute_dtype({"device": {"dtype": "bfloat16"}}, cuda) is torch.bfloat16
    assert compute_dtype({"device": {"dtype": "bfloat16", "mesh_shape": [2]}},
                         cuda) is torch.bfloat16


@pytest.mark.parametrize("platform", [None, "auto", "default", "cuda"])
def test_no_platform_means_the_card(platform):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    device = {} if platform is None else {"platform": platform}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        config_device({"device": device})


def test_cohort_step_on_grid_tpu_s_staged_arrays(cohort):
    """grid_tpu's CohortStage carried into the port: the fused steps' inputs
    from it give the same cohort step as grid_tpu's fused steps' inputs."""
    import jax.numpy as jnp

    from grid_tpu.io.formats import read_counts_tsv, read_samples
    from grid_tpu.io.hap_neighbors import pad_hap_neighbors
    from grid_tpu.io.staging import stage_cohort
    from grid_tpu.models.cohort import CohortParams as JaxParams, cohort_step as jax_step
    from grid_tpu_torch.convert import (
        fused_inputs, outputs_to_numpy, params_from_reference, stage_from_reference,
    )
    from grid_tpu_torch.models.cohort import cohort_step

    cfg = cohort["config"]
    stage = stage_cohort(cfg["mosdepth"]["work_dir"], read_samples(cfg["samples_file"]),
                         cfg["chrom"], cfg["start_bp"], cfg["end_bp"], {}, 10, 100)
    reads_map = read_counts_tsv(cohort["counts_file"])
    del reads_map["SYN00007"]
    n = len(stage.sample_ids)
    params = JaxParams(num_neighbors=n - 1, n_nbr=n - 1, n_iters=0, quantize=True)
    reads = np.array([reads_map.get(s, np.nan) for s in stage.sample_ids])
    reads_valid = np.array([s in reads_map for s in stage.sample_ids])
    hi, hw, hv = pad_hap_neighbors([[] for _ in range(2 * n)], 10, dtype=np.float64)
    want = jax_step(jnp.asarray(stage.values), jnp.asarray(stage.mask), jnp.asarray(reads),
                    jnp.asarray(reads_valid), jnp.asarray(hi), jnp.asarray(hw), jnp.asarray(hv),
                    params)
    inputs = fused_inputs(stage_from_reference(stage), reads_map, 10, "cpu", torch.float64)
    assert inputs[0].dtype == inputs[2].dtype == inputs[5].dtype == torch.float64
    assert inputs[5].shape == (2 * n, 10) and not inputs[6].any()
    got = outputs_to_numpy(cohort_step(*inputs, params_from_reference(params._asdict())))
    # both quantize to 2 decimals; the last bit of x/100 may differ
    np.testing.assert_allclose(got.z, np.asarray(want.z), rtol=1e-14, atol=0)
    np.testing.assert_allclose(got.scales, np.asarray(want.scales), rtol=1e-14, atol=0)
    np.testing.assert_array_equal(got.nbr_idx, np.asarray(want.nbr_idx))
    np.testing.assert_array_equal(got.dipcn_valid, np.asarray(want.dipcn_valid))
    assert not got.dipcn_valid[stage.sample_ids.index("SYN00007")]
    np.testing.assert_allclose(got.dipcn[got.dipcn_valid],
                               np.asarray(want.dipcn)[got.dipcn_valid], rtol=1e-9)
    assert np.isnan(got.hap_irrs).all() and not got.phased.any()  # zero sweeps, no neighbors


def test_cli_synth_validate_wgs_devices(tmp_path):
    """The port's CLI end to end on the CPU: synth, validate, wgs (with
    ``device.platform: cpu`` written into the config), devices."""
    import yaml
    from click.testing import CliRunner

    from grid_tpu_torch.cli import cli

    runner = CliRunner()
    res = runner.invoke(cli, ["synth", "--out", str(tmp_path / "c"), "-n", "8", "--seed", "4"])
    assert res.exit_code == 0, res.output
    config_file = tmp_path / "c" / "config.yaml"
    assert runner.invoke(cli, ["validate", str(config_file)]).exit_code == 0
    cfg = yaml.safe_load(config_file.read_text())
    # no platform named: the card, which this machine may not have
    if not torch.cuda.is_available():
        cfg["device"] = {"fused": True}
        config_file.write_text(yaml.safe_dump(cfg, sort_keys=False))
        res = runner.invoke(cli, ["wgs", str(config_file)])
        assert isinstance(res.exception, RuntimeError) and "CUDA" in str(res.exception)
    cfg["device"] = {"fused": True, "platform": "cpu"}
    config_file.write_text(yaml.safe_dump(cfg, sort_keys=False))
    res = runner.invoke(cli, ["wgs", str(config_file)])
    assert res.exit_code == 0, res.output
    for name in ARTIFACTS.values():
        assert (tmp_path / "c" / "results" / name).exists(), name
    cfg["threads"] = "two"
    config_file.write_text(yaml.safe_dump(cfg, sort_keys=False))
    assert runner.invoke(cli, ["validate", str(config_file)]).exit_code != 0
    res = runner.invoke(cli, ["devices"])
    assert res.exit_code == 0 and "backend: torch" in res.output


class Recorder:
    """A console that keeps what the pipeline logs."""

    def __init__(self):
        self.lines = []

    def print(self, msg, style=None):
        self.lines.append((msg, style))


def test_timings_file_that_cannot_be_written(cohort, tmp_path, monkeypatch):
    """A step_timings.json that cannot be written costs a warning, not the
    run, as in grid_tpu: the artifacts stay and the timings are returned."""
    from grid_tpu_torch.utils.timing import StepTimer

    def refuse(self, path):
        raise PermissionError(f"{path}: read-only")

    monkeypatch.setattr(StepTimer, "dump", refuse)
    cfg = run_config(cohort, tmp_path, {"fused": True, "platform": "cpu"})
    console = Recorder()
    timings = run_wgs_pipeline(console=console, config=cfg)
    assert set(timings) == set(SPANS) | {"check_index"}
    assert all((tmp_path / name).exists() for name in ARTIFACTS.values())
    assert not (tmp_path / "step_timings.json").exists()
    warned = [(msg, style) for msg, style in console.lines if "step_timings.json" in msg]
    assert len(warned) == 1 and warned[0][1] == "warning"
    assert warned[0][0].startswith("step_timings.json was not written")
    assert "read-only" in warned[0][0]


@pytest.mark.parametrize("use_pallas", [True, False])
def test_use_pallas_logs_that_it_has_no_effect(cohort, tmp_path, use_pallas):
    cfg = run_config(cohort, tmp_path, {"fused": True, "platform": "cpu", "use_pallas": use_pallas})
    console = Recorder()
    run_wgs_pipeline(console=console, config=cfg)
    said = [msg for msg, _ in console.lines if "device.use_pallas" in msg]
    assert said == (["device.use_pallas has no effect: the hand kernels are always the path on "
                     "the card"] if use_pallas else [])
