"""Native IBS haplotype-neighbor step, the computeIBSpbwt replacement (twin
of ``grid_tpu/steps/ibs.py``).

The reference pipeline needs an IBS neighbor file made by an external C++
tool that users download and build themselves (ref
docs/source/ibs_ibd.rst:14-19; its 8-argument interface at :96-140 and
output format at :203-233). The JAX package makes that file itself with a
PBWT engine, and so does the port: the host library's C++ engine
(``csrc/host/ibs.cpp``, :mod:`grid_tpu_torch.native_host.ibs`) or its numpy
twin (:mod:`grid_tpu_torch.ops.pbwt`), writing the exact format
``hi_inference``'s IBS loader reads (grid/utils/hi_inference.py:34-74), so
the pipeline goes from phased genotypes to haploid copy numbers.

Input panels: phased VCF (read directly) or phased BGEN v1.2 (the reference
tool's format). cM positions come from an Eagle genetic-map table, or a
uniform 1 cM/Mb fallback when no map is given. The step runs on the host,
as in the JAX package: no kernel.

Under ``backend: auto`` a native engine that fails (no compiler, a failed
build) gives way to the numpy engine with the JAX package's warning, and
adds one to ``native_host.fallbacks["ibs"]``.
"""

from __future__ import annotations

import gzip
from pathlib import Path

import numpy as np

from grid_tpu_torch import native_host
from grid_tpu_torch.io import phased
from grid_tpu_torch.utils.logging import log

OUTPUT_HEADER = "ID\thap\tnbrInd\tcMlen\tcMedge\tIDnbr\thapNbr"


def compute_ibs_neighbors(
    output,
    focal_bp,
    vcf=None,
    bgen=None,
    sample_file=None,
    chrom=None,
    genetic_map=None,
    num_neighbors=200,
    threads=1,
    max_scan=None,
    backend="auto",
    console=None,
):
    """Find the top IBS neighbors of every haplotype around ``focal_bp``
    and write the computeIBSpbwt-format neighbor file.

    Args:
      output: output path (gzip-compressed when it ends in ``.gz``).
      focal_bp: focal base-pair position (same build as the panel).
      vcf / bgen: exactly one phased input panel.
      sample_file: Oxford .sample file (BGEN without embedded IDs).
      chrom: restrict the panel to one chromosome (VCF/BGEN may be
        multi-chrom; the reference tool is per-chromosome by design).
      genetic_map: Eagle genetic-map table for cM interpolation; when
        absent a uniform 1 cM/Mb scaling is used (logged).
      num_neighbors: neighbors per haplotype (reference recommends 200).
      threads: native-core threads.
      max_scan: per-side PBWT expansion cap (default ``max(4k, k+64)``).
      backend: ``auto`` (native C++, numpy on failure), ``native``, or
        ``numpy``.

    Returns the output Path.
    """
    if (vcf is None) == (bgen is None):
        raise ValueError("pass exactly one of vcf= or bgen=")
    if vcf is not None:
        sample_ids, H, pos = phased.read_phased_vcf(vcf, chrom=chrom)
        src = vcf
    else:
        sample_ids, H, pos = phased.read_phased_bgen(
            bgen, sample_file=sample_file, chrom=chrom
        )
        src = bgen
    n_hap, m = H.shape
    if m == 0:
        raise ValueError(f"{src}: no usable phased biallelic sites")
    log(
        console,
        f"IBS panel: {len(sample_ids)} samples x {m} sites from {Path(src).name}",
    )

    if genetic_map is not None:
        gpos, gcm = phased.read_genetic_map(genetic_map)
        cm = phased.interpolate_cm(pos, gpos, gcm)
        focal_cm = float(np.interp(float(focal_bp), gpos, gcm))
    else:
        log(console, "no genetic map given; using uniform 1 cM/Mb", style="warning")
        cm = pos.astype(np.float64) * 1e-6
        focal_cm = float(focal_bp) * 1e-6
        focal_cm = min(max(focal_cm, float(cm[0])), float(cm[-1]))
    focal = int(np.searchsorted(pos, int(focal_bp)))

    k = min(int(num_neighbors), max(n_hap - 2, 0))
    if k == 0:
        raise ValueError("panel too small: need at least two samples")

    idx, cmlen, cmedge, count = _run_engine(
        H, cm, focal, focal_cm, k, max_scan, threads, backend, console
    )

    out = Path(output)
    out.parent.mkdir(parents=True, exist_ok=True)
    opener = gzip.open if str(out).endswith(".gz") else open
    with opener(out, "wt") as f:
        f.write(OUTPUT_HEADER + "\n")
        for h in range(n_hap):
            sid = sample_ids[h // 2]
            hap = h % 2 + 1
            for r in range(int(count[h])):
                j = int(idx[h, r])
                f.write(
                    f"{sid}\t{hap}\t{r + 1}\t{cmlen[h, r]:.4f}\t"
                    f"{cmedge[h, r]:.4f}\t{sample_ids[j // 2]}\t{j % 2 + 1}\n"
                )
    log(
        console,
        f"IBS neighbors ({k} per haplotype, focal {focal_bp:,}) → {out}",
        style="success",
    )
    return out


def default_ibs_output(config) -> Path:
    """The path ``compute_ibs`` writes for a given config — derived by the
    orchestrator too, so a resume-skipped step still feeds hi_inference."""
    section = config.get("compute_ibs", {})
    out_dir = Path(config.get("output_dir", "."))
    return out_dir / f"{section.get('output_file_prefix', 'ibs_neighbors')}.tsv.gz"


def compute_ibs(config, console=None):
    """Config-driven pipeline step (the JAX package's addition: the reference
    treats IBS neighbors as externally-prepared input). Writes
    ``{output_dir}/{output_file_prefix}.tsv.gz`` and, when
    ``compute_haploid_genotypes.ibs_output`` is unset, points it at the
    result so a single ``wgs`` run goes from phased panel to haploid CNs.
    """
    section = config.get("compute_ibs", {})
    out = default_ibs_output(config)
    compute_ibs_neighbors(
        output=out,
        focal_bp=section["focal_bp"],
        vcf=section.get("vcf"),
        bgen=section.get("bgen"),
        sample_file=section.get("sample_file"),
        chrom=section.get("panel_chrom"),
        genetic_map=section.get("genetic_map"),
        num_neighbors=section.get("num_neighbors", 200),
        threads=config.get("threads", 1),
        max_scan=section.get("max_scan"),
        backend=section.get("backend", "auto"),
        console=console,
    )
    hap_cfg = config.setdefault("compute_haploid_genotypes", {})
    if not hap_cfg.get("ibs_output"):
        hap_cfg["ibs_output"] = str(out)
    return out


def _run_engine(H, cm, focal, focal_cm, k, max_scan, threads, backend, console):
    if backend not in ("auto", "native", "numpy"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend in ("auto", "native"):
        try:
            from grid_tpu_torch.native_host.ibs import pbwt_ibs_neighbors as native_engine

            return native_engine(
                H, cm, focal, focal_cm, k, max_scan=max_scan, threads=threads
            )
        except Exception as e:  # no compiler / build failure
            if backend == "native":
                raise
            native_host.count_fallback("ibs")
            log(console, f"native IBS core unavailable ({e}); using numpy", style="warning")
    from grid_tpu_torch.ops.pbwt import pbwt_ibs_neighbors as numpy_engine

    return numpy_engine(H, cm, focal, focal_cm, k, max_scan=max_scan)
