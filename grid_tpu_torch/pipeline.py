"""WGS pipeline orchestrator (twin of ``grid_tpu/pipeline.py``).

The config is validated and its defaults resolved once, per-step wall-clock
is recorded and dumped next to the artifacts (``step_timings.json``), and a
step whose outputs exist and whose config and inputs are unchanged is
skipped with ``resume: true`` (content-addressed,
``<output_dir>/.grid_tpu_state.json``).

Steps 1-3 run on the host as in the JAX package: the index check
(``index.run: false``) or the creation of missing indexes (``run: true``),
then steps 2-3 as one native pass per alignment file
(:mod:`grid_tpu_torch.steps.ingest`), whose staged window bins go to steps
4-7 in the process under the private ``_ingest_staged`` key, or, where that
pass is off or fails (a warning, and one in
``native_host.fallbacks["sequential_steps"]``), ``count_reads`` and
``mosdepth`` one after the other. A config with only steps 1-3 on needs no
card.

Steps 4-7 run as in the JAX package, on the card unless
``device.platform: cpu``: with ``device: {fused: true}`` as one fused step
(:mod:`grid_tpu_torch.steps.fused`), otherwise (the default) in file mode,
each step gated by its section's ``run: true`` and reading the previous
step's file. A failure of the fused step is logged and the file-mode steps
run in its place, on the same device (the reference's semantics); on the
card only a failure to read its inputs does so, and a kernel or device
failure propagates. A failing file-mode step is logged and the next one
runs, unless a kernel or the card failed (``native.KernelError``, CUDA's
own errors): that propagates on every device.

Between steps 1-3 and 4-7, ``compute_ibs`` (the JAX package's addition)
makes step 7's IBS neighbor file from a phased panel on the host
(:mod:`grid_tpu_torch.steps.ibs`); ``compute_haploid_genotypes.ibs_output``
is pointed at that file before the step runs, so a resume-skipped step
still feeds step 7.

``device.mesh_shape`` with the fused path asks the dispatch policy
(:mod:`grid_tpu_torch.parallel.policy`): where it chooses the single-device
step, that step runs on one card; where it chooses the sharded ring
(``dispatch: ring`` on more than one device, or N at or above the
crossover under ``auto``), the fused step runs over prod(mesh_shape) ranks
(:mod:`grid_tpu_torch.parallel`), in ``device.dtype`` (float32, float64
or bfloat16 on the card, as the single-device step; in bfloat16 the depths
alone, the reads and step 7 in ``step_dtype``). In file mode
``mesh_shape`` changes nothing, as in the JAX package, whose file steps do
not read it. A one-device mesh with ``dispatch: ring``
raises the policy's ``ValueError`` before anything runs, and a failed rank
(:class:`grid_tpu_torch.parallel.RankFailure`) propagates on every device:
the file-mode steps do not take over from it.

:func:`run_wes_pipeline`, the exome path (realign → per-exon dipCN →
KIV-2 estimate), has the JAX package's gating and log-and-continue
semantics too; its Smith-Waterman scores run on the card unless
``device.platform: cpu``, and a kernel or card failure propagates there as
well.

One addition: the JAX orchestrator keeps resume state for the sequential
steps only; here the fused step records its four artifacts under the four
classic step names, and is skipped when all four are up to date, so either
form can resume the other's outputs.
"""

from __future__ import annotations

import hashlib
import json
import math
import zlib
from pathlib import Path

from grid_tpu_torch import native_host
from grid_tpu_torch.config import WES_SCHEMA, apply_defaults, error_check_config, load_config
from grid_tpu_torch.io.formats import read_samples
from grid_tpu_torch.native import is_device_failure
from grid_tpu_torch.parallel.mesh import RankFailure
from grid_tpu_torch.parallel.policy import choose_cohort_execution
from grid_tpu_torch.steps.count_reads import count_reads
from grid_tpu_torch.steps.coverage import compute_mosdepth
from grid_tpu_torch.steps.dipcn import compute_diploid_genotypes
from grid_tpu_torch.steps.fused import (
    FusedInputError,
    fused_steps_enabled,
    run_fused_steps,
)
from grid_tpu_torch.steps.haploid import hi_inference
from grid_tpu_torch.steps.ibs import compute_ibs, default_ibs_output
from grid_tpu_torch.steps.index import check_index, create_index
from grid_tpu_torch.steps.ingest import fused_ingest_enabled, run_fused_ingest
from grid_tpu_torch.steps.neighbors import find_neighbors
from grid_tpu_torch.steps.normalize import normalize_mosdepth, stage_would_stream
from grid_tpu_torch.utils.device import compute_dtype, config_device, enable_compilation_cache
from grid_tpu_torch.utils.logging import log
from grid_tpu_torch.utils.timing import StepTimer, step_timer

# the four steps the fused path replaces, in the order of its returned paths
FUSED_STEP_NAMES = ("normalize", "neighbors", "compute_diploid_genotypes",
                    "compute_haploid_genotypes")


def _file_stat(path) -> tuple:
    """(size, crc32(head), crc32(tail)) of a file, or ("missing",).

    Content-based (64 KiB head + tail), NOT mtime-based: a regenerated but
    identical upstream file stays valid, and an rsync/git-checkout that
    preserves mtimes but changes bytes invalidates."""
    try:
        p = Path(path)
        size = p.stat().st_size
        chunk = 65536
        with open(p, "rb") as f:
            head = zlib.crc32(f.read(chunk))
            if size > chunk:
                f.seek(max(size - chunk, 0))
                tail = zlib.crc32(f.read(chunk))
            else:
                tail = head
        return (size, head, tail)
    except OSError:
        return ("missing",)


def _step_inputs(name: str, config: dict) -> list:
    """The on-disk inputs whose change must invalidate a cached step."""
    out_dir = Path(config.get("output_dir", "."))
    ft = config.get("output_file_type", "tsv")
    m = config.get("mosdepth", {})

    def prefix(section, key="output_file_prefix"):
        return section.get(key) if isinstance(section, dict) else None

    if name == "normalize":
        work = m.get("work_dir")
        if work and Path(work).is_dir():
            return sorted(str(p) for p in Path(work).glob("*.regions.bed.gz"))
        return []
    if name == "neighbors":
        return [out_dir / f"{prefix(m.get('normalize', {}))}.{ft}.gz"]
    if name == "compute_diploid_genotypes":
        zmax = m.get("neighbors", {}).get("zmax", 2.0)
        return [
            out_dir / f"{prefix(config.get('count_reads', {}))}.{ft}",
            out_dir / f"{prefix(m.get('neighbors', {}))}.zMax{zmax:.1f}.{ft}.gz",
        ]
    if name == "compute_haploid_genotypes":
        h = config.get("compute_haploid_genotypes", {})
        inputs = [out_dir / f"{prefix(config.get('compute_diploid_genotypes', {}))}.{ft}"]
        for key in ("ibs_output", "ibd_output"):
            if h.get(key):
                inputs.append(h[key])
        return inputs
    return []


def _step_fingerprint(name: str, config: dict) -> str:
    """Hash of the step-relevant config AND the stat signature of the step's
    input files, so regenerated upstream artifacts (or parameter changes in
    upstream sections that determine input filenames) invalidate the skip."""
    relevant = {
        "global": {
            k: config.get(k)
            for k in ("samples_file", "chrom", "start_bp", "end_bp", "output_dir", "min_mapq")
        },
        "step": config.get(name, {}),
        "mosdepth": config.get("mosdepth", {})
        if name in ("normalize", "neighbors", "compute_diploid_genotypes")
        else None,
        "inputs": [(str(p), _file_stat(p)) for p in _step_inputs(name, config)],
    }
    return hashlib.sha256(json.dumps(relevant, sort_keys=True, default=str).encode()).hexdigest()


class _Resume:
    """Step-level resume bookkeeping (``<output_dir>/.grid_tpu_state.json``)."""

    def __init__(self, config):
        self.enabled = bool(config.get("resume", False))
        self.path = Path(config.get("output_dir", ".")) / ".grid_tpu_state.json"
        self.state = {}
        if self.path.exists():
            try:
                self.state = json.loads(self.path.read_text())
            except (OSError, ValueError):
                self.state = {}  # an unreadable state file only costs a re-run

    def should_skip(self, name, config) -> bool:
        if not self.enabled:
            return False
        rec = self.state.get(name)
        return bool(rec) and rec.get("fingerprint") == _step_fingerprint(name, config) and all(
            Path(p).exists() for p in rec.get("outputs", [])
        )

    def mark(self, name, config, outputs):
        # always record (cheap), so the FIRST `resume: true` run benefits
        # from state written by earlier non-resume runs
        self.state[name] = {
            "fingerprint": _step_fingerprint(name, config),
            "outputs": [str(p) for p in outputs if p],
        }
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.path.write_text(json.dumps(self.state, indent=2))


def _check_dispatch(config: dict) -> None:
    """Raise the dispatch policy's ``ValueError`` (``ring`` on a one-device
    mesh, an unknown ``dispatch``) before any step runs, as the fused step
    would raise it only after steps 1-3; the fused step asks the policy
    again with the staged N."""
    mesh_shape = config.get("device", {}).get("mesh_shape")
    if not mesh_shape or not fused_steps_enabled(config):
        return
    dispatch = str(config.get("device", {}).get("dispatch", "auto"))
    try:
        n = len(read_samples(config["samples_file"]))
    except (KeyError, OSError):
        n = 0
    choose_cohort_execution(n, int(math.prod(mesh_shape)), dispatch)


def _steps_4_7(config: dict) -> list:
    """(section, step name, step function) of file-mode steps 4-7, in order."""
    m = config.get("mosdepth", {})
    return [
        (m.get("normalize", {}), "normalize", normalize_mosdepth),
        (m.get("neighbors", {}), "neighbors", find_neighbors),
        (config.get("compute_diploid_genotypes", {}), "compute_diploid_genotypes",
         compute_diploid_genotypes),
        (config.get("compute_haploid_genotypes", {}), "compute_haploid_genotypes", hi_inference),
    ]


def _steps_2_3(config_data, console, timer, resume, gated) -> None:
    """Steps 2-3 as one native pass per file where it is on, with resume
    marks under ``count_reads`` and ``mosdepth`` (either form resumes the
    other's files) and its staged bins under ``_ingest_staged``; else, or
    where it fails, the two steps one after the other."""
    if fused_ingest_enabled(config_data):
        cr_on = config_data.get("count_reads", {}).get("run") is True
        skip_cr = (not cr_on) or resume.should_skip("count_reads", config_data)
        skip_md = resume.should_skip("mosdepth", config_data)
        if skip_cr and skip_md:
            log(console, "[count_reads+mosdepth] up-to-date, skipped (resume)" if cr_on
                else "[mosdepth] up-to-date, skipped (resume)", style="info")
            return
        if cr_on and (skip_cr or skip_md):
            # exactly one step is up to date: the one pass would rewrite
            # (and on a crash truncate) its valid file; the sequential
            # steps keep the finer resume
            log(console, "one of steps 2/3 is up-to-date; running them sequentially to "
                "preserve resume state", style="info")
        else:
            try:
                # a streaming normalize stage holds no per-sample arrays
                collect = not stage_would_stream(config_data)
                with step_timer("fused_ingest_2_3", timer, console):
                    counts_path, coverage_path, staged = run_fused_ingest(
                        config_data, console, collect_staged=collect)
                if staged is not None:
                    config_data["_ingest_staged"] = staged
                if counts_path is not None:
                    resume.mark("count_reads", config_data, [counts_path])
                resume.mark("mosdepth", config_data, [coverage_path])
                return
            except Exception as e:
                native_host.count_fallback("sequential_steps")
                log(console, f"One-pass ingest failed ({e}); falling back to sequential steps "
                    "2-3", style="warning")
    gated(config_data.get("count_reads", {}), "count_reads", count_reads)
    gated(config_data.get("mosdepth", {}), "mosdepth", compute_mosdepth)


def run_wgs_pipeline(console=None, config=None, validate: bool = True):
    """Run the WGS pipeline from a YAML config path or dict; returns the
    step timings (also written to ``<output_dir>/step_timings.json``).

    It runs on the card unless ``device.platform: cpu`` asks for the host,
    and raises without a card otherwise."""
    if not config:
        raise ValueError("Config file is required for running the WGS pipeline.")

    if isinstance(config, (str, Path)):
        try:
            config_data = load_config(config)
        except Exception as e:
            raise ValueError(f"Failed to read the config file: {e}") from e
    else:
        config_data = config

    if validate:
        error_check_config(config_data, console)
    config_data = apply_defaults(config_data)
    enable_compilation_cache(config_data.get("device", {}).get("compilation_cache"), console)
    _check_dispatch(config_data)
    device = None
    if any(section.get("run") is True for section, _, _ in _steps_4_7(config_data)):
        # the device and dtype are resolved before any step runs: a missing
        # card raises here, not inside a step whose failure is only logged
        device = config_device(config_data)
        compute_dtype(config_data, device)

    Path(config_data.get("output_dir", ".")).mkdir(parents=True, exist_ok=True)

    timer = StepTimer()
    resume = _Resume(config_data)

    if config_data.get("device", {}).get("use_pallas"):
        log(console, "device.use_pallas has no effect: the hand kernels are always the path on "
            "the card", style="info")

    def gated(section, name, fn):
        """Run one step with the reference's failure semantics (log and go
        on), but for a kernel or device failure, which propagates."""
        if section.get("run") is not True:
            return
        if resume.should_skip(name, config_data):
            log(console, f"[{name}] up-to-date, skipped (resume)", style="info")
            return
        try:
            with step_timer(name, timer, console):
                out = fn(config_data, console, timer)
            resume.mark(name, config_data, [out])
        except Exception as e:
            # a kernel's or the card's own failure is never logged away: the
            # later steps would run on without the work it did not do
            if is_device_failure(e):
                raise
            log(console, f"Failed to run {name}: {e}", style="danger")

    # Step 1 (ref: pipeline.py:24-43): check the indexes when run is false,
    # create the missing ones when it is true
    index_run = config_data.get("index", {}).get("run")
    if index_run is True or index_run is False:
        name, fn = ("create_index", create_index) if index_run else ("check_index", check_index)
        try:
            with step_timer(name, timer, console):
                fn(config_data, console)
        except Exception as e:
            log(console, f"Failed to {name.replace('_', ' ')}: {e}", style="danger")

    _steps_2_3(config_data, console, timer, resume, gated)

    # the JAX package's addition: step 7's IBS neighbor file from a phased
    # panel, made before steps 4-7 (fused or in file mode) read it
    if config_data.get("compute_ibs", {}).get("run") is True:
        # ibs_output is derived before the gated call: a resume-skipped
        # compute_ibs must still point step 7 at the existing file
        hap_cfg = config_data.setdefault("compute_haploid_genotypes", {})
        if not hap_cfg.get("ibs_output"):
            hap_cfg["ibs_output"] = str(default_ibs_output(config_data))
        gated(config_data["compute_ibs"], "compute_ibs",
              lambda cfg, con, _timer: compute_ibs(cfg, con))

    fused_done = False
    if fused_steps_enabled(config_data):
        # steps 4-7 as one staged ingest + one fused device step
        if all(resume.should_skip(name, config_data) for name in FUSED_STEP_NAMES):
            log(console, "[fused_steps_4_7] up-to-date, skipped (resume)", style="info")
            fused_done = True
        else:
            try:
                with step_timer("fused_steps_4_7", timer, console):
                    outputs = run_fused_steps(config_data, console, timer)
                for name, path in zip(FUSED_STEP_NAMES, outputs):
                    resume.mark(name, config_data, [path])
                fused_done = True
            except Exception as e:
                # on the card only an unreadable input falls back: a kernel or
                # device failure is not handed to the file-mode steps
                if isinstance(e, RankFailure) or (
                        device.type == "cuda" and not isinstance(e, FusedInputError)):
                    raise
                log(console, f"Fused steps 4-7 failed ({e}); falling back to sequential steps",
                    style="warning")
    if not fused_done:
        for section, name, fn in _steps_4_7(config_data):
            gated(section, name, fn)

    # the artifacts are written: a timings file that cannot be written
    # costs a warning, not the run (as in grid_tpu/pipeline.py)
    try:
        timer.dump(Path(config_data.get("output_dir", ".")) / "step_timings.json")
    except OSError as e:
        log(console, f"step_timings.json was not written: {e}", style="warning")
    return timer.report()


def run_wes_pipeline(console=None, config=None, validate: bool = True):
    """Run the exome (WES) pipeline: realign -> per-exon dipCN -> KIV-2
    estimate (twin of ``grid_tpu/pipeline.py:run_wes_pipeline``).

    Smith-Waterman realignment of window reads against the exon references
    (models/realign.py), the legacy per-exon dipCN semantics (models/kiv.py)
    and the KIV-2 linear estimate. Steps are gated by ``run: true`` and a
    failing step is logged and the next runs, as in the WGS orchestrator,
    but for a kernel's or the card's own failure, which propagates. The
    realignment runs on the card unless ``device.platform: cpu`` (read
    outside ``WES_SCHEMA``, which stays the JAX package's); the device is
    resolved before any step, so without a card it raises first.
    """
    if not config:
        raise ValueError("Config file is required for running the WES pipeline.")
    if isinstance(config, (str, Path)):
        try:
            config_data = load_config(config)
        except Exception as e:
            raise ValueError(f"Failed to read the config file: {e}") from e
    else:
        config_data = config

    if validate:
        error_check_config(config_data, console, schema=WES_SCHEMA)
    config_data = apply_defaults(config_data, schema=WES_SCHEMA)
    enable_compilation_cache(config_data.get("device", {}).get("compilation_cache"), console)
    device = None
    if config_data.get("realign", {}).get("run") is True:
        device = config_device(config_data)
    out_dir = Path(config_data.get("output_dir", "."))
    out_dir.mkdir(parents=True, exist_ok=True)
    ft = config_data.get("output_file_type", "tsv")
    timer = StepTimer()

    def gated(name, fn):
        section = config_data.get(name, {})
        if section.get("run") is not True:
            return
        try:
            with step_timer(name, timer, console):
                fn(section)
        except Exception as e:
            if is_device_failure(e):
                raise
            log(console, f"Failed to run {name}: {e}", style="danger")

    if config_data.get("index", {}).get("run") is True:
        try:
            with step_timer("create_index", timer, console):
                create_index(config_data, console)
        except Exception as e:
            log(console, f"Failed to create index: {e}", style="danger")

    counts_prefix = config_data.get("realign", {}).get("output_file_prefix", "exon_counts")
    counts_file = out_dir / f"{counts_prefix}.{ft}"

    def _realign(section):
        from grid_tpu_torch.models.realign import run_realignment

        run_realignment(
            config_data["directory_loc"],
            section["exon_fasta"],
            config_data["chrom"],
            config_data["start_bp"],
            config_data["end_bp"],
            counts_file,
            min_score=section.get("min_score", 30),
            margin=section.get("margin", 3),
            threads=config_data.get("threads", 1),
            console=console,
            device=device,
        )

    dipcn_prefix = out_dir / config_data.get("exon_dipcn", {}).get("output_file_prefix",
                                                                  "exon_dipcn")

    def _exon_dipcn(section):
        from grid_tpu_torch.models.kiv import compute_dipcn_for_exon
        from grid_tpu_torch.models.kiv_io import (
            load_count_results,
            load_neighbor_results,
            validate_sample_overlap,
            write_dipcn_output,
        )

        counts = load_count_results(counts_file)
        nbrs = load_neighbor_results(section["neighbors_file"])
        n_overlap, _ = validate_sample_overlap(counts, nbrs, console)
        if n_overlap == 0:
            raise ValueError("No overlapping samples between exon counts and neighbors")
        for exon_type in section.get("exon_types", ["1A", "1B"]):
            res = compute_dipcn_for_exon(
                counts, nbrs, exon_type, section.get("n_neighbors", 200)
            )
            out = Path(f"{dipcn_prefix}.{exon_type}.{ft}")
            write_dipcn_output(res, out)
            log(console, f"{exon_type} dipCN for {len(res)} samples → {out}", style="success")

    def _estimate(section):
        from grid_tpu_torch.models.kiv import estimate_kiv_files

        out = out_dir / f"{section.get('output_file_prefix', 'kiv2_estimates')}.{ft}"
        n = estimate_kiv_files(
            Path(f"{dipcn_prefix}.1A.{ft}"), Path(f"{dipcn_prefix}.1B.{ft}"), out
        )
        log(console, f"KIV2 estimates for {n} samples → {out}", style="success")

    gated("realign", _realign)
    gated("exon_dipcn", _exon_dipcn)
    gated("estimate_kiv", _estimate)

    try:
        timer.dump(out_dir / "step_timings.json")
    except OSError as e:
        log(console, f"step_timings.json was not written: {e}", style="warning")
    return timer.report()
