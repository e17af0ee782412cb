"""Multi-locus sweep: one cohort, many VNTR windows (twin of
``grid_tpu/steps/multilocus.py``).

The cohort-level work of steps 4-5 (normalize, then the neighbor
geometry) does not depend on the locus, so it runs once; only the
window-indexed steps (dipCN, phasing) repeat per locus. Per-locus artifacts
carry a ``.{GENE}`` suffix on their prefix, so a sweep over the bundled
catalog writes one dipCN and one haploid table per gene beside the shared
normalized matrix and neighbors file.

Step 6 of all loci runs batched (:func:`run_batched_dipcn`): the geometry is
read once from the written normalized matrix, and each group of loci that
share a usability pattern is one launch of ``dipcn_select``'s multi-weight
form on the resident [N, N] distances (one ``zprep_gram``), or, past
:data:`D2_BUDGET_BYTES`, one ``zprep_split`` and one Gram panel and one
multi-weight launch per 512 rows. On the card only the kernels run.

With ``count_reads.run: true`` each locus's reads are counted into
``<output_dir>/<prefix>.<GENE>.<type>``: inside the shared one-pass ingest
(every locus window a count-only window of the same scan,
``_extra_count_windows``) where that pass runs, else per locus through the
``count_reads`` step; with it off the sweep reads those files as they are.
With ``compute_ibs.run: true`` each locus makes its own IBS neighbor file
in its per-locus pass, from the panel around the window's midpoint
(:func:`locus_config`), as in the JAX package. The device is the config's
(``device.platform``), whatever the cohort's size.
"""

from __future__ import annotations

import copy
import math
from pathlib import Path

import numpy as np
import torch

from grid_tpu_torch.config import apply_defaults, error_check_config, load_config
from grid_tpu_torch.data.loci import Locus, resolve_locus
from grid_tpu_torch.io.formats import read_counts_tsv, write_dipcn
from grid_tpu_torch.ops.gpu_select import dipcn_from_distances_multi_gpu, dipcn_multi_panels_gpu
from grid_tpu_torch.ops.knn import d2_matrix
from grid_tpu_torch.pipeline import _steps_4_7, run_wgs_pipeline
from grid_tpu_torch.steps.ingest import fused_ingest_enabled
from grid_tpu_torch.steps.neighbors import load_neighbor_geometry
from grid_tpu_torch.utils.device import compute_dtype, config_device, enable_compilation_cache
from grid_tpu_torch.utils.logging import log
from grid_tpu_torch.utils.timing import step_timer

# the resident [N, N] distances while they fit this many bytes, else row
# panels (grid_tpu's constant; no config key)
D2_BUDGET_BYTES = 2 << 30

# steps whose artifacts depend on the locus window: their output prefixes
# get the .GENE suffix
_PER_LOCUS_PREFIXES = (
    ("count_reads", "output_file_prefix"),
    ("compute_diploid_genotypes", "output_file_prefix"),
    ("compute_haploid_genotypes", "output_file_prefix"),
    ("compute_ibs", "output_file_prefix"),
)
_PER_LOCUS_STEPS = ("count_reads", "compute_ibs", "compute_diploid_genotypes",
                    "compute_haploid_genotypes")


def locus_config(config: dict, locus: Locus) -> dict:
    """A deep-copied config re-targeted at ``locus``: its window
    coordinates, per-locus output prefixes suffixed ``.{gene}``, and the
    IBS focal position at the window's midpoint."""
    cfg = copy.deepcopy(config)
    cfg["chrom"] = locus.chrom
    cfg["start_bp"] = locus.start
    cfg["end_bp"] = locus.end
    tag = locus.gene.split(",")[0] or f"{locus.chrom}_{locus.start}"
    for section, key in _PER_LOCUS_PREFIXES:
        sec = cfg.get(section)
        if isinstance(sec, dict) and sec.get(key):
            sec[key] = f"{sec[key]}.{tag}"
    ibs = cfg.get("compute_ibs")
    if isinstance(ibs, dict) and ibs.get("run") is True:
        ibs["focal_bp"] = (locus.start + locus.end) // 2
        hap = cfg.get("compute_haploid_genotypes")
        if isinstance(hap, dict) and hap.get("ibs_output"):
            # one shared IBS file cannot serve every locus: the per-locus
            # file follows from the suffixed compute_ibs prefix
            hap["ibs_output"] = None
    return cfg


def _counts_file(cfg) -> Path:
    out_type = cfg.get("output_file_type", "tsv")
    prefix = cfg.get("count_reads", {}).get("output_file_prefix")
    return Path(f"{cfg.get('output_dir', '.')}/{prefix}.{out_type}")


def _dipcn_file(cfg) -> Path:
    out_type = cfg.get("output_file_type", "tsv")
    prefix = cfg.get("compute_diploid_genotypes", {}).get("output_file_prefix")
    return Path(f"{cfg.get('output_dir', '.')}/{prefix}.{out_type}")


def usability_groups(sample_ids, scales: dict, reads_per_gene: dict) -> list:
    """The loci grouped by which samples have a count, in first-seen order:
    [(usable [N] bool, genes, w [N, L] float64)], w[:, j] = reads / scale
    of the j-th gene where usable, else 0."""
    scale_vec = np.array([scales[sid] for sid in sample_ids], dtype=np.float64)
    groups: dict[bytes, tuple] = {}
    for g, reads in reads_per_gene.items():
        usable = np.array([sid in reads for sid in sample_ids], dtype=bool)
        vals = np.array([reads.get(sid, 0.0) for sid in sample_ids], dtype=np.float64)
        _, genes, cols = groups.setdefault(usable.tobytes(), (usable, [], []))
        genes.append(g)
        cols.append(np.where(usable, vals / scale_vec, 0.0))
    return [(usable, genes, np.stack(cols, axis=1)) for usable, genes, cols in groups.values()]


def run_batched_dipcn(shared_config, locus_cfgs, console=None, timer=None):
    """Step 6 for many loci in one device call per usability group.

    The distance geometry (the written normalized matrix, prepared) does not
    depend on the locus; per locus only the read-count weights differ. Loci
    are grouped by which samples have a count, and each group is one launch
    of the multi-weight ``dipcn_select`` (per row panel past the budget).
    Per locus the result is file-mode step 6's up to summation order.

    Args:
        shared_config: the base config (its normalize and neighbors sections
            locate the shared artifacts).
        locus_cfgs: {gene: per-locus config} from :func:`locus_config`.
        timer: optional ``StepTimer`` for the spans ``neighbors.read``,
            ``batched.read`` (the counts files), ``batched.device`` and
            ``batched.write``.

    Returns {gene: dipcn_path} for the loci written.
    """
    dcfg = shared_config.get("compute_diploid_genotypes", {})
    n_nbr = dcfg.get("n_nbr", 300)

    sample_ids, zp, scales, _r_use, k = load_neighbor_geometry(shared_config, console, timer)
    n = len(sample_ids)
    written: dict[str, Path] = {}
    if n == 0:
        for gene, cfg in locus_cfgs.items():
            path = _dipcn_file(cfg)
            write_dipcn(path, [], [])
            written[gene] = path
        return written

    with step_timer("batched.read", timer):
        reads_per_gene = {g: read_counts_tsv(_counts_file(cfg)) for g, cfg in locus_cfgs.items()}
    # loci that share a usability pattern share one launch
    groups = usability_groups(sample_ids, scales, reads_per_gene)

    resident = n * n * zp.element_size() <= D2_BUDGET_BYTES
    log(console,
        f"Batched dipCN: {len(locus_cfgs)} loci in {len(groups)} device call(s) "
        f"(N={n}, k={k}, {'resident d2' if resident else 'row panels'})",
        style="info")

    zp = zp.contiguous()
    for usable, group, w in groups:
        with step_timer("batched.device", timer):
            w_t = torch.as_tensor(w, dtype=zp.dtype, device=zp.device)
            usable_t = torch.as_tensor(usable, device=zp.device)
            valid_t = usable_t[:, None].expand(w_t.shape).contiguous()
            if resident:
                ones = torch.ones(zp.shape, dtype=torch.bool, device=zp.device)
                d2 = d2_matrix(zp, ones, ones[0], math.inf)
                dip, ok = dipcn_from_distances_multi_gpu(d2, w_t, w_t, usable_t, valid_t, k=k,
                                                         n_nbr=n_nbr)
                del d2
            else:
                dip, ok = dipcn_multi_panels_gpu(
                    zp, w_t, w_t, usable_t, valid_t, k=k, n_nbr=n_nbr,
                    row_valid=torch.ones(n, dtype=torch.bool, device=zp.device))
            dip, ok = dip.cpu().numpy(), ok.cpu().numpy()  # waits for the device

        with step_timer("batched.write", timer):
            for j, g in enumerate(group):
                sel = ok[:, j]
                out_ids = [sid for i, sid in enumerate(sample_ids) if sel[i]]
                out_vals = [float(v) for v in dip[sel, j]]
                path = _dipcn_file(locus_cfgs[g])
                write_dipcn(path, out_ids, out_vals)
                log(console, f"[{g}] saved {len(out_ids)} samples → {path}", style="success")
                written[g] = path
    return written


def _shared_steps_off(cfg: dict) -> None:
    """Turn the locus-independent steps 3-5 and the fused form off in a
    per-locus config."""
    for path in (("mosdepth",), ("mosdepth", "normalize"), ("mosdepth", "neighbors")):
        sec = cfg
        for key in path:
            sec = sec.setdefault(key, {})
        sec["run"] = False
    cfg.setdefault("device", {})["fused"] = False


def run_multi_locus(config, genes, console=None, catalog=None, batched="auto", timer=None):
    """Run the WGS pipeline across many catalog loci, sharing the
    locus-independent steps.

    Phase 1 (once): steps 1-5 of the base config (index, coverage, with
    every locus's read count in the same one-pass scan where it runs,
    normalize, neighbors). Per-locus counting where that scan did not count
    (once per locus). Batched step 6 (once): dipCN of all loci, one device
    call per usability group (:func:`run_batched_dipcn`). Phase 2 (per
    locus): what remains, dipCN when batching is off and phasing, through
    ``run_wgs_pipeline`` with the shared steps off.

    Args:
        config: dict or YAML path (the base config; its chrom/start/end are
            replaced per locus).
        genes: gene names resolved against the VNTR catalog.
        catalog: optional catalog path (default: the bundled table).
        batched: True/False/"auto" — batch step 6 across loci ("auto":
            whenever dipCN is on and there is more than one locus).
        timer: optional ``StepTimer`` for the spans ``multi_locus.shared``,
            ``multi_locus.count_reads`` (where loci are counted one by one),
            ``batched_dipcn`` (with :func:`run_batched_dipcn`'s spans) and
            ``multi_locus.per_locus``.

    Returns {gene: locus} for the loci that ran.
    """
    if isinstance(config, (str, Path)):
        config = load_config(config)
    error_check_config(config, console)
    config = apply_defaults(config)
    enable_compilation_cache(config.get("device", {}).get("compilation_cache"), console)

    if any(section.get("run") is True for section, _, _ in _steps_4_7(config)):
        # the dtype is resolved before any step runs: what the card does not
        # take (float64 past the float64 knn_select's k) raises here, not inside a step. Under bfloat16 the
        # shared normalize runs in bf16 and the batched dipCN, like
        # grid_tpu's, reads the written matrix in step_dtype
        compute_dtype(config, config_device(config))
    loci = {g: resolve_locus(g, catalog) for g in genes}
    cfgs = {g: locus_config(config, locus) for g, locus in loci.items()}

    counts_on = config.get("count_reads", {}).get("run") is True
    dipcn_on = config.get("compute_diploid_genotypes", {}).get("run") is True
    if batched == "auto":
        batched = dipcn_on and len(loci) > 1

    # ---- phase 1: the locus-independent cohort steps, once ---------------
    shared = copy.deepcopy(config)
    for section in _PER_LOCUS_STEPS:
        shared.setdefault(section, {})["run"] = False
    shared.setdefault("device", {})["fused"] = False  # the fused step needs all of 4-7
    if counts_on and fused_ingest_enabled(shared):
        # every locus window counted inside the one scan
        shared["_extra_count_windows"] = [
            {"chrom": loci[g].chrom, "start": loci[g].start, "end": loci[g].end,
             "counts_path": _counts_file(cfgs[g])}
            for g in loci
        ]
    log(console, f"Multi-locus sweep: shared steps (coverage/normalize/kNN) "
                 f"for {len(loci)} loci", style="info")
    with step_timer("multi_locus.shared", timer):
        run_wgs_pipeline(console, shared, validate=False)
    counted = "_extra_count_windows" in shared
    counts_done = {g: counted and _counts_file(cfgs[g]).exists() for g in loci}

    # ---- per-locus counting, where the shared scan did not count ---------
    for gene, locus in loci.items():
        if not counts_on or counts_done[gene]:
            continue
        log(console, f"[{gene}] count_reads {locus.chrom}:{locus.start:,}-{locus.end:,}",
            style="info")
        cfg = copy.deepcopy(cfgs[gene])
        cfg.setdefault("index", {})["run"] = None
        for section in _PER_LOCUS_STEPS[1:]:
            cfg.setdefault(section, {})["run"] = False
        _shared_steps_off(cfg)
        with step_timer("multi_locus.count_reads", timer):
            run_wgs_pipeline(console, cfg, validate=False)
        counts_done[gene] = True

    # ---- batched step 6 --------------------------------------------------
    dipcn_done = set()
    if batched and dipcn_on:
        with step_timer("batched_dipcn", timer):
            dipcn_done = set(run_batched_dipcn(config, cfgs, console, timer))

    # ---- phase 2: the remaining per-locus steps --------------------------
    with step_timer("multi_locus.per_locus", timer):
        for gene, locus in loci.items():
            cfg = cfgs[gene]
            # the shared steps are done; off in the per-locus pass
            cfg.setdefault("index", {})["run"] = None
            _shared_steps_off(cfg)
            if counts_done[gene]:
                cfg.setdefault("count_reads", {})["run"] = False
            if gene in dipcn_done:
                cfg.setdefault("compute_diploid_genotypes", {})["run"] = False
            remaining = [s for s in _PER_LOCUS_STEPS if cfg.get(s, {}).get("run") is True]
            if not remaining:
                continue
            log(console, f"[{gene}] {locus.chrom}:{locus.start:,}-{locus.end:,} "
                         f"({', '.join(remaining)})", style="info")
            run_wgs_pipeline(console, cfg, validate=False)
    return loci
