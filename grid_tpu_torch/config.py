"""YAML config schema, validation and defaults (twin of
``grid_tpu/config.py``: the same schemas, errors, warnings and defaults, so
a config file valid there is valid here and means the same).

Schema-compatible with the reference config surface
(``grid/config.py:6-132`` and ``grid/example_config.yaml``): the same
top-level fields, the same per-step sections each gated by ``run:``, and the
same defaults. Unlike the reference — whose validator exists but is never
invoked by the pipeline (quirk Q1, ``grid/pipeline.py:20-21``) — the config
is validated before running.

Quirk parity (SURVEY §7):

- Q3: ``count_reads`` reads ``min_mapq`` from the config **top level**
  (``grid/utils/count_reads.py:24``); ``count_reads.min_mapq`` is accepted in
  the schema but ignored by the step, exactly like the reference. Validation
  emits a warning when the two disagree, since that silently changes results.
- The hidden ``frac_r`` knob (``grid/utils/find_neighbors.py:34``) is made an
  explicit schema field with the same default (1.0).

The ``device`` section (all optional, defaulted) controls dtype, fused
execution and placement. What the port reads differently:
``device.platform`` absent, ``auto``, ``default`` or ``cuda`` is the card
and ``cpu`` the host (``utils/device.py:config_device``); ``device.dtype:
auto`` is float32 on the card; ``device.use_pallas`` is accepted and has no
effect (the hand kernels are always the path on the card).
"""

from __future__ import annotations

from pathlib import Path

from grid_tpu_torch.utils.logging import log

# --- Top-level required fields (ref: grid/config.py:6-17) ---
REQUIRED_TOP_LEVEL = {
    "samples_file": str,
    "directory_loc": str,
    "reference_genome": str,
    "output_dir": str,
    "threads": int,
    "file_type": str,
    "chrom": str,
    "start_bp": int,
    "end_bp": int,
    "output_file_type": str,
}

REQUIRED_FILES_TOP_LEVEL = ["samples_file", "reference_genome"]

# Per-step schema: (path, gate, default, required, is_file).
# Mirrors grid/config.py:21-132, plus explicit neighbors.frac_r / n_nbr /
# the grid_tpu "device" section.
STEP_SCHEMA = [
    # index
    {"path": ("index", "output_file_prefix"), "default": "output"},
    # count_reads
    {"path": ("count_reads", "min_mapq"), "gate": ("count_reads",), "default": 1},
    {"path": ("count_reads", "output_file_prefix"), "gate": ("count_reads",), "default": "output"},
    {"path": ("count_reads", "flags"), "gate": ("count_reads",), "required": True},
    # mosdepth
    {"path": ("mosdepth", "output_file_prefix"), "gate": ("mosdepth",), "default": "output"},
    {"path": ("mosdepth", "bin_size"), "gate": ("mosdepth",), "default": 1000},
    {"path": ("mosdepth", "mode"), "gate": ("mosdepth",), "default": "fast"},
    {"path": ("mosdepth", "work_dir"), "gate": ("mosdepth",), "default": "output_dir/mosdepth_workdir"},
    # used in the per-sample bed.gz prefix ({sample}_{region_name}); read by
    # both the reference (grid/utils/mosdepth.py:32) and grid_tpu steps but
    # absent from the reference schema — surfaced here (docs drift check)
    {"path": ("mosdepth", "region_name"), "gate": ("mosdepth",), "default": "region"},
    # built-in binners only: omit zero-depth bins from the bed.gz. Every
    # downstream reader filters depth > 0 (ref normalize_mosdepth.py:262-285),
    # so results are identical; for locus-subset cohorts the zero bins are
    # ~99% of the file. Ignored when the mosdepth binary runs.
    {"path": ("mosdepth", "sparse_bed"), "gate": ("mosdepth",), "default": False},
    {"path": ("mosdepth", "remove_intermediate"), "gate": ("mosdepth",), "default": True},
    # mosdepth.normalize
    {"path": ("mosdepth", "normalize", "min_depth"), "gate": ("mosdepth", "normalize"), "default": 20},
    {"path": ("mosdepth", "normalize", "max_depth"), "gate": ("mosdepth", "normalize"), "default": 100},
    {"path": ("mosdepth", "normalize", "top_frac"), "gate": ("mosdepth", "normalize"), "default": 0.1},
    {
        "path": ("mosdepth", "normalize", "output_file_prefix"),
        "gate": ("mosdepth", "normalize"),
        "default": "output",
    },
    {
        "path": ("mosdepth", "normalize", "repeat_mask_file"),
        "gate": ("mosdepth", "normalize"),
        "required": True,
        "is_file": True,
    },
    # mosdepth.neighbors
    {
        "path": ("mosdepth", "neighbors", "output_file_prefix"),
        "gate": ("mosdepth", "neighbors"),
        "default": "output",
    },
    # reference schema documents 5, but its validator is never invoked (Q1)
    # and the step behaviorally defaults to 500 (find_neighbors.py:33);
    # activating the dead 5 would silently change results
    {"path": ("mosdepth", "neighbors", "num_neighbors"), "gate": ("mosdepth", "neighbors"), "default": 500},
    {"path": ("mosdepth", "neighbors", "zmax"), "gate": ("mosdepth", "neighbors"), "default": 2.0},
    {"path": ("mosdepth", "neighbors", "sigma2_max"), "gate": ("mosdepth", "neighbors"), "default": 1000},
    {"path": ("mosdepth", "neighbors", "frac_r"), "gate": ("mosdepth", "neighbors"), "default": 1.0},
    # compute_diploid_genotypes
    {
        "path": ("compute_diploid_genotypes", "output_file_prefix"),
        "gate": ("compute_diploid_genotypes",),
        "default": "output",
    },
    {"path": ("compute_diploid_genotypes", "n_nbr"), "gate": ("compute_diploid_genotypes",), "default": 300},
    # compute_ibs (grid_tpu addition: native PBWT IBS engine as a pipeline
    # step, replacing the reference's external computeIBSpbwt input prep;
    # its output feeds compute_haploid_genotypes.ibs_output automatically)
    {"path": ("compute_ibs", "vcf"), "gate": ("compute_ibs",), "default": None},
    {"path": ("compute_ibs", "bgen"), "gate": ("compute_ibs",), "default": None},
    {"path": ("compute_ibs", "sample_file"), "gate": ("compute_ibs",), "default": None},
    {"path": ("compute_ibs", "focal_bp"), "gate": ("compute_ibs",), "required": True},
    {"path": ("compute_ibs", "genetic_map"), "gate": ("compute_ibs",), "default": None},
    {"path": ("compute_ibs", "num_neighbors"), "gate": ("compute_ibs",), "default": 200},
    {"path": ("compute_ibs", "panel_chrom"), "gate": ("compute_ibs",), "default": None},
    {"path": ("compute_ibs", "backend"), "gate": ("compute_ibs",), "default": "auto"},
    # per-side PBWT expansion cap; None => max(4k, k+64). Raise when the
    # numpy engine logs that the cap terminated expansion before the Fagin
    # threshold (result then best-effort rather than exact top-k).
    {"path": ("compute_ibs", "max_scan"), "gate": ("compute_ibs",), "default": None},
    {"path": ("compute_ibs", "output_file_prefix"), "gate": ("compute_ibs",), "default": "ibs_neighbors"},
    # compute_haploid_genotypes
    {"path": ("compute_haploid_genotypes", "method"), "gate": ("compute_haploid_genotypes",), "default": "ibs"},
    {"path": ("compute_haploid_genotypes", "ibs_output"), "gate": ("compute_haploid_genotypes",), "default": None},
    {"path": ("compute_haploid_genotypes", "ibd_output"), "gate": ("compute_haploid_genotypes",), "default": None},
    {
        "path": ("compute_haploid_genotypes", "output_file_prefix"),
        "gate": ("compute_haploid_genotypes",),
        "default": "output",
    },
    {"path": ("compute_haploid_genotypes", "min_neighbors"), "gate": ("compute_haploid_genotypes",), "default": 1},
    {"path": ("compute_haploid_genotypes", "max_neighbors"), "gate": ("compute_haploid_genotypes",), "default": 10},
    {"path": ("compute_haploid_genotypes", "n_iters"), "gate": ("compute_haploid_genotypes",), "default": 100},
    {"path": ("compute_haploid_genotypes", "weighted"), "gate": ("compute_haploid_genotypes",), "default": False},
    {"path": ("compute_haploid_genotypes", "weight_scale"), "gate": ("compute_haploid_genotypes",), "default": 1_000_000},
    {"path": ("compute_haploid_genotypes", "min_length"), "gate": ("compute_haploid_genotypes",), "default": 0.5},
    {"path": ("compute_haploid_genotypes", "min_match"), "gate": ("compute_haploid_genotypes",), "default": 0.70},
    # grid_tpu addition: neighbor-resampling bootstrap (0 = off)
    {"path": ("compute_haploid_genotypes", "bootstrap_replicates"), "gate": ("compute_haploid_genotypes",), "default": 0},
]

# grid_tpu device/runtime section (new; all optional).
DEVICE_SCHEMA = [
    {"path": ("device", "dtype"), "default": "auto"},  # auto|float32|float64|bfloat16
    {"path": ("device", "mesh_shape"), "default": None},  # e.g. [8] or [4, 2]
    {"path": ("device", "fused"), "default": False},  # steps 4-7 as one device program
    {"path": ("device", "exact_phasing"), "default": False},  # host Gauss-Seidel parity mode
    {"path": ("device", "streaming_stage"), "default": "auto"},  # auto|true|false
    {"path": ("device", "dispatch"), "default": "auto"},  # auto|flat|ring (parallel/policy.py)
    {"path": ("device", "fused_ingest"), "default": "auto"},  # auto|true|false (steps/ingest.py)
]


# WES (exome) pipeline schema — the reference's commented-out `WES(config)`
# stub (grid/cli.py:94-113) names a run_wes_pipeline that never existed;
# grid_tpu implements it over the working exon-realignment path
# (realign -> per-exon dipCN -> KIV-2 estimate). Both packages validate the
# same files with it; the port's run_wes_pipeline reads device.platform
# outside it.
WES_SCHEMA = [
    {"path": ("index", "output_file_prefix"), "default": "index_file_results"},
    {"path": ("realign", "exon_fasta"), "gate": ("realign",), "required": True, "is_file": True},
    {"path": ("realign", "output_file_prefix"), "gate": ("realign",), "default": "exon_counts"},
    {"path": ("realign", "min_score"), "gate": ("realign",), "default": 30},
    {"path": ("realign", "margin"), "gate": ("realign",), "default": 3},
    {"path": ("exon_dipcn", "neighbors_file"), "gate": ("exon_dipcn",), "required": True, "is_file": True},
    {"path": ("exon_dipcn", "n_neighbors"), "gate": ("exon_dipcn",), "default": 200},
    {"path": ("exon_dipcn", "exon_types"), "gate": ("exon_dipcn",), "default": ["1A", "1B"]},
    {"path": ("exon_dipcn", "output_file_prefix"), "gate": ("exon_dipcn",), "default": "exon_dipcn"},
    {"path": ("estimate_kiv", "output_file_prefix"), "gate": ("estimate_kiv",), "default": "kiv2_estimates"},
]


def load_config(path) -> dict:
    """Load a YAML config file into a dict (needs ``pyyaml``, imported here
    only: a config given as a dict needs none)."""
    import yaml

    with open(path, "r") as f:
        return yaml.safe_load(f)


def _get_nested(config, *keys):
    node = config
    for key in keys:
        if not isinstance(node, dict):
            return None
        node = node.get(key)
    return node


def _is_enabled(config, gate) -> bool:
    """True if the section at ``gate`` has ``run: True`` (ref: grid/config.py:145-148)."""
    section = _get_nested(config, *gate)
    return isinstance(section, dict) and section.get("run") is True


def validate_top_level(config, errors, warnings):
    for key, expected_type in REQUIRED_TOP_LEVEL.items():
        if key not in config:
            errors.append(f"Missing required field: '{key}'")
        elif not isinstance(config[key], expected_type) or (
            expected_type is int and isinstance(config[key], bool)
        ):
            # bool is an int subclass; reject it for int fields explicitly
            errors.append(f"'{key}' must be {expected_type.__name__}")

    for key in REQUIRED_FILES_TOP_LEVEL:
        val = config.get(key)
        if val and not Path(val).exists():
            errors.append(f"File not found: {key} = {val}")


def validate_steps(config, errors, warnings, schema=None):
    for entry in (STEP_SCHEMA if schema is None else schema) + DEVICE_SCHEMA:
        gate = entry.get("gate")
        if gate and not _is_enabled(config, gate):
            continue
        value = _get_nested(config, *entry["path"])
        field_name = ".".join(entry["path"])
        if value is None:
            if entry.get("required"):
                errors.append(f"{field_name} not set.")
            elif "default" in entry and entry["default"] is not None:
                warnings.append(f"{field_name} not set. Defaulting to {entry['default']!r}.")
        elif entry.get("is_file") and not Path(value).exists():
            errors.append(f"File not found: {field_name} = {value}")

    # Q3 parity warning: count_reads.min_mapq is silently ignored by the step
    # (top-level min_mapq is used, ref grid/utils/count_reads.py:24).
    if schema is None and _is_enabled(config, ("count_reads",)):
        step_mapq = _get_nested(config, "count_reads", "min_mapq")
        top_mapq = config.get("min_mapq", 1)
        if step_mapq is not None and step_mapq != top_mapq:
            warnings.append(
                f"count_reads.min_mapq={step_mapq} is ignored (reference-parity quirk Q3); "
                f"the top-level min_mapq={top_mapq} is used. Set a top-level 'min_mapq' key."
            )


def error_check_config(config, console=None, schema=None):
    """Validate a config dict; raise ValueError on errors, warn on defaults.

    Same contract as the reference validator (grid/config.py:182-201) —
    but actually invoked by :mod:`grid_tpu_torch.pipeline` (fixing quirk Q1).
    """
    errors: list[str] = []
    warnings: list[str] = []

    validate_top_level(config, errors, warnings)
    validate_steps(config, errors, warnings, schema)

    if errors:
        for e in errors:
            log(console, e, style="danger")
        raise ValueError(f"{len(errors)} config error(s) found. Aborting.")

    if warnings:
        for w in warnings:
            log(console, w, style="warning")
        log(
            console,
            f"{len(warnings)} config warning(s) found. Please review. This may affect the results.",
            style="warning",
        )


def apply_defaults(config: dict, schema=None) -> dict:
    """Return a deep-copied config with schema defaults filled in.

    The reference surfaces defaults as warnings but each step re-implements
    its own ``.get(..., default)`` chain; grid_tpu resolves them once so steps
    read a fully-populated config.
    """
    import copy

    cfg = copy.deepcopy(config)
    for entry in (STEP_SCHEMA if schema is None else schema) + DEVICE_SCHEMA:
        gate = entry.get("gate")
        if gate and not _is_enabled(cfg, gate):
            continue
        if _get_nested(cfg, *entry["path"]) is None and "default" in entry:
            default = entry["default"]
            if default == "output_dir/mosdepth_workdir":
                default = str(Path(cfg.get("output_dir", ".")) / "mosdepth_workdir")
            node = cfg
            for key in entry["path"][:-1]:
                node = node.setdefault(key, {})
            if default is not None:
                node[entry["path"][-1]] = default
    return cfg
