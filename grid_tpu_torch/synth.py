"""Synthetic cohort generator (twin of ``grid_tpu/synth.py``'s
``make_synthetic_cohort`` and ``make_synthetic_cohort_with_alignments``).

Generates per-sample ``regions.bed.gz`` binned depths with planted CN
structure, a counts TSV consistent with the planted copy numbers, a repeat
mask, IBS/IBD haplotype-neighbor files, and a ready-to-run config (as a dict,
and as ``config.yaml`` where ``pyyaml`` is installed). Ground-truth haplotype
CNs are returned (and written) so concordance can be scored end-to-end.

:func:`make_matrix` is the dense synthetic depth matrix of the JAX
package's ``bench.py``, for driving the cohort step without files.

:func:`make_synthetic_cohort_with_alignments` also writes a BAM or CRAM per
sample (the port's :mod:`~grid_tpu_torch.io.bamlite` and
:mod:`~grid_tpu_torch.io.cramlite` writers), so steps 1-3 run end to end on
the built-in readers; one seed gives the JAX package's bytes.

:func:`make_synthetic_phased_panel` writes a phased haplotype panel (VCF,
Oxford .sample file, Eagle genetic map) for the IBS step; one seed gives
the JAX package's panel.
"""

from __future__ import annotations

import gzip
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from contextlib import nullcontext
from pathlib import Path

import numpy as np

# alignment files a writer process takes (encoding ~3,000 reads in Python
# costs ~0.1 s a file; a spawned process ~1 s to start)
SAMPLES_PER_WRITER = 64
# bed.gz files a writer process takes (formatting and compressing 2,049
# bins costs ~25 ms a file)
BEDS_PER_WRITER = 256


def make_matrix(n, r, seed=0):
    """A synthetic [n, r] depth matrix (a copy of ``bench.py``'s, numpy
    only): per-sample base depths of 25-35x, dosage noise on the first r/8
    bins, 3% multiplicative noise, 2% of the cells masked to 0. Returns
    (values [n, r] float64, mask [n, r] bool, reads [n] float64)."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(25.0, 35.0, size=(n, 1))
    dose = np.ones((n, r))
    dose[:, : r // 8] = rng.normal(1.0, 0.15, size=(n, r // 8)).clip(0.3, 2.0)
    values = (base * dose * rng.normal(1.0, 0.03, size=(n, r))).clip(0.5, None)
    mask = rng.random((n, r)) > 0.02
    reads = rng.integers(500, 3000, size=n).astype(np.float64)
    return values * mask, mask, reads


def make_synthetic_cohort(
    out_dir,
    n_samples: int = 12,
    chrom: str = "chr6",
    window_start: int = 160_605_000,
    window_end: int = 160_648_000,
    flank_bins: int = 40,
    bin_size: int = 1000,
    mean_depth: float = 30.0,
    depth_sd: float = 1.5,
    reads_per_copy: float = 500.0,
    seed: int = 0,
    missing_frac: float = 0.0,
):
    """Build a synthetic cohort on disk.

    Depth model: each sample s has a base autosomal depth D_s ~ N(mean, sd).
    Bins inside the VNTR window get depth D_s * (CN_s / 2) where CN_s =
    hap1_s + hap2_s (haplotype copy numbers drawn near 1.0 with variation),
    so normalization must recover the CN signal. Window read counts are
    CN_s/2 * coverage-proportional, making dipCN ≈ CN_s / mean(CN_nbrs).

    Returns a dict with ids, truth arrays and all file paths.
    """
    return _make_cohort(
        out_dir, n_samples, chrom, window_start, window_end, flank_bins, bin_size,
        mean_depth, depth_sd, reads_per_copy, seed, missing_frac,
        make_alignments=False, read_len=100,
    )


def make_synthetic_cohort_with_alignments(
    out_dir,
    n_samples: int = 6,
    chrom: str = "chr6",
    window_start: int = 160_605_000,
    window_end: int = 160_615_000,
    flank_bins: int = 10,
    bin_size: int = 1000,
    mean_depth: float = 8.0,
    depth_sd: float = 0.8,
    reads_per_copy: float = 200.0,
    seed: int = 0,
    read_len: int = 100,
    file_type: str = "bam",
    indel_frac: float = 0.0,
):
    """Variant producing real alignment files so the index / count_reads /
    coverage steps run end-to-end on the built-in ingestion paths — no
    pysam, htslib or mosdepth binary required. ``file_type`` selects BAM
    (grid_tpu_torch.io.bamlite) or CRAM (grid_tpu_torch.io.cramlite).

    ``indel_frac``: fraction of reads carrying a non-trivial CIGAR
    (soft-clips, insertions, deletions, a splice) instead of all-M. The
    indel CIGARs keep the read length at ``read_len`` but change the
    reference span, so the fast-mode binners' CIGAR-derived ref-span
    accounting is exercised identically across BAM and CRAM (same rng
    stream => bit-identical alignments modulo container format).

    A cohort of at least 2 × ``SAMPLES_PER_WRITER`` samples is encoded and
    written by one spawned process per ``SAMPLES_PER_WRITER`` samples, up
    to the machine's cores; the draws stay in the calling process, so the
    files are the same bytes as from one process."""
    return _make_cohort(
        out_dir, n_samples, chrom, window_start, window_end, flank_bins, bin_size,
        mean_depth, depth_sd, reads_per_copy, seed, 0.0,
        make_alignments=True, read_len=read_len, file_type=file_type,
        indel_frac=indel_frac,
    )


def make_synthetic_phased_panel(
    out_dir,
    n_samples: int = 24,
    n_sites: int = 400,
    chrom: str = "6",
    start_bp: int = 160_000_000,
    site_spacing: int = 1_000,
    n_founders: int = 8,
    switch_rate: float = 0.01,
    mutation_rate: float = 0.002,
    n_clone_pairs: int = 3,
    clone_span_sites: int = 200,
    seed: int = 0,
    hap_groups=None,
):
    """Fabricate a phased haplotype panel with realistic IBS structure for
    the native IBS engine (tests, examples, and the ``ibs`` CLI).

    Model: a pool of founder haplotypes; each cohort haplotype is a mosaic
    of founders (switches at rate ``switch_rate`` per site) with rare
    mutations, so haplotypes copying the same founder locally share long
    IBS segments. ``n_clone_pairs`` haplotype pairs (across different
    samples) additionally copy each other exactly over ``clone_span_sites``
    sites centred on the panel midpoint — planted mutual best matches.

    ``hap_groups`` (optional int array ``[2*n_samples]``, hap index
    ``2*i + h``): haplotypes in the same group copy a shared group founder
    over the focal window — the biological premise of the pipeline (shared
    haplotype around the VNTR => shared repeat allele). Pass a quantile
    binning of the true haplotype CNs to make IBS-based phasing
    informative end-to-end. Disables the clone-pair planting.

    Writes ``panel.vcf.gz``, ``panel.sample``, ``genetic_map.txt`` and
    returns ids, the haplotype matrix, positions, the focal bp (panel
    midpoint) and the planted clone pairs (haplotype-index tuples).
    """
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    ids = [f"SYN{i:05d}" for i in range(n_samples)]
    n_hap = 2 * n_samples

    founders = rng.integers(0, 2, size=(n_founders, n_sites), dtype=np.uint8)
    source = np.empty((n_hap, n_sites), dtype=np.int64)
    source[:, 0] = rng.integers(0, n_founders, size=n_hap)
    switches = rng.random(size=(n_hap, n_sites)) < switch_rate
    for j in range(1, n_sites):
        new = rng.integers(0, n_founders, size=n_hap)
        source[:, j] = np.where(switches[:, j], new, source[:, j - 1])
    H = founders[source, np.arange(n_sites)]
    H ^= (rng.random(size=H.shape) < mutation_rate).astype(np.uint8)

    mid = n_sites // 2
    lo = max(0, mid - clone_span_sites // 2)
    hi = min(n_sites, mid + clone_span_sites // 2)
    clone_pairs = []
    if hap_groups is not None:
        hap_groups = np.asarray(hap_groups)
        if hap_groups.shape != (n_hap,):
            raise ValueError(f"hap_groups must have shape ({n_hap},)")
        for g in np.unique(hap_groups):
            members = np.flatnonzero(hap_groups == g)
            founder = rng.integers(0, 2, size=hi - lo, dtype=np.uint8)
            for h in members:
                H[h, lo:hi] = founder
        # rare mutations so matches have realistic ragged ends
        window = H[:, lo:hi]
        window ^= (rng.random(size=window.shape) < mutation_rate).astype(np.uint8)
    else:
        used: set[int] = set()
        for _ in range(n_clone_pairs):
            while True:
                x, y = rng.choice(n_hap, size=2, replace=False)
                if x // 2 != y // 2 and x not in used and y not in used:
                    break
            H[y, lo:hi] = H[x, lo:hi]
            used.update((int(x), int(y)))
            clone_pairs.append((int(x), int(y)))

    positions = start_bp + np.arange(n_sites, dtype=np.int64) * site_spacing
    focal_bp = int(positions[mid]) - site_spacing // 2

    vcf_path = out / "panel.vcf.gz"
    with gzip.open(vcf_path, "wt") as f:
        f.write("##fileformat=VCFv4.2\n")
        f.write(f"##contig=<ID={chrom}>\n")
        f.write('##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n')
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t")
        f.write("\t".join(ids) + "\n")
        for j in range(n_sites):
            gts = "\t".join(
                f"{H[2 * i, j]}|{H[2 * i + 1, j]}" for i in range(n_samples)
            )
            f.write(
                f"{chrom}\t{positions[j]}\tvar{j + 1}\tA\tG\t.\tPASS\t.\tGT\t{gts}\n"
            )

    from grid_tpu_torch.io.phased import write_sample_file

    sample_path = write_sample_file(out / "panel.sample", ids)

    # Eagle-format genetic map with mildly varying recombination rate.
    rates = rng.uniform(0.5, 2.0, size=n_sites)  # cM/Mb
    cm = np.concatenate([[0.0], np.cumsum(rates[1:] * np.diff(positions) * 1e-6)])
    map_path = out / "genetic_map.txt"
    with open(map_path, "w") as f:
        f.write("chr position COMBINED_rate Genetic_Map(cM)\n")
        for j in range(n_sites):
            f.write(f"{chrom} {positions[j]} {rates[j]:.4f} {cm[j]:.6f}\n")

    return {
        "ids": ids,
        "H": H,
        "positions": positions,
        "cm": cm,
        "focal_bp": focal_bp,
        "clone_pairs": clone_pairs,
        "vcf": vcf_path,
        "sample_file": sample_path,
        "genetic_map": map_path,
        "chrom": chrom,
    }


def _indel_cigars(read_len):
    """Non-trivial CIGARs, all with read length == read_len ([(op, n)])."""
    l = read_len
    return [
        [("M", l - 10), ("D", 4), ("M", 10)],           # deletion
        [("S", 4), ("M", l - 8), ("S", 4)],             # soft clips
        [("M", l // 2), ("I", 5), ("M", l - l // 2 - 5)],  # insertion
        [("M", l // 3), ("N", 60), ("M", l - l // 3)],  # splice gap
    ]


def _write_bed(path, chrom, bins, depths):
    """One sample's binned depths as the JAX package writes them: a line a
    bin, depth at %.2f."""
    with gzip.open(path, "wt") as f:
        for (bs, be), depth in zip(bins.tolist(), depths.tolist()):
            f.write(f"{chrom}\t{bs}\t{be}\t{depth:.2f}\n")


def _write_alignments(aln_dir, file_type, chrom, chrom_len, sid, positions, cigs, read_len):
    """Encode one sample's reads and write its BAM or CRAM (no index)."""
    if file_type == "cram":
        from grid_tpu_torch.io.cramlite import CramRecord, write_cram

        recs = [
            CramRecord(
                name=f"{sid}r{j}", flag=83 if j % 2 == 0 else 147,
                ref_id=0, pos=pos, mapq=60, rl=read_len,
                seq="A" * read_len, qual=b"I" * read_len,
                mate_ref_id=0, mate_pos=pos + 150, tlen=250,
                cigar=cig,
            )
            for j, (pos, cig) in enumerate(zip(positions, cigs))
        ]
        # no .crai: the pipeline's index step exercises build_crai
        write_cram(aln_dir / f"{sid}.cram", [(chrom, chrom_len)], recs,
                   build_index=False)
    else:
        from grid_tpu_torch.io.bamlite import encode_record, write_bam

        recs = [
            encode_record(
                0, pos, 83 if j % 2 == 0 else 147, mapq=60,
                read_name=f"{sid}r{j}", seq_len=read_len,
                cigar=[(int(n), op) for op, n in cig] if cig else None,
                next_pos=pos + 150,
            )
            for j, (pos, cig) in enumerate(zip(positions, cigs))
        ]
        write_bam(aln_dir / f"{sid}.bam", [(chrom, chrom_len)], recs)


def _make_cohort(
    out_dir, n_samples, chrom, window_start, window_end, flank_bins, bin_size,
    mean_depth, depth_sd, reads_per_copy, seed, missing_frac,
    make_alignments, read_len, file_type="bam", indel_frac=0.0,
):
    """The JAX package's generator, with every draw made from the same
    generator in the same order, so one seed gives the same files."""
    out = Path(out_dir)
    work = out / "mosdepth_workdir"
    work.mkdir(parents=True, exist_ok=True)
    results = out / "results"
    results.mkdir(parents=True, exist_ok=True)

    rng = np.random.default_rng(seed)
    ids = [f"SYN{i:05d}" for i in range(n_samples)]

    # haplotype copy numbers (in units of "1.0 = reference haplotype dose")
    hap_cn = rng.normal(1.0, 0.18, size=(n_samples, 2)).clip(0.4, 2.0)
    dip_cn = hap_cn.sum(axis=1)

    base_depth = rng.normal(mean_depth, depth_sd, size=n_samples).clip(10, None)

    # genome bins: a window of VNTR bins plus flanking normal bins each side
    w_bins = [(window_start + i * bin_size, min(window_start + (i + 1) * bin_size, window_end))
              for i in range((window_end - window_start + bin_size - 1) // bin_size)]
    left = [(window_start - (flank_bins - i) * bin_size, window_start - (flank_bins - i - 1) * bin_size)
            for i in range(flank_bins)]
    right_start = w_bins[-1][1]
    right = [(right_start + i * bin_size, right_start + (i + 1) * bin_size) for i in range(flank_bins)]
    all_bins = left + w_bins + right

    samples_file = out / "samples.txt"
    samples_file.write_text("".join(f"{s}\n" for s in ids))

    # the draws stay in this process, in the JAX package's order; from 2 x
    # BEDS_PER_WRITER samples on, spawned processes format and compress the
    # files (the same bytes, the same calls to the writer)
    bins = np.array(all_bins, dtype=np.int64)
    workers = min(os.cpu_count() or 1, n_samples // BEDS_PER_WRITER)
    with (ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn"))
          if workers > 1 else nullcontext()) as pool:
        written = []
        for i, sid in enumerate(ids):
            depths = np.empty(len(all_bins))
            kept = np.ones(len(all_bins), dtype=bool)
            for b, (bs, be) in enumerate(all_bins):
                in_window = bs >= window_start and be <= window_end
                dose = dip_cn[i] / 2 if in_window else 1.0
                noise = rng.normal(1.0, 0.02)
                depths[b] = max(base_depth[i] * dose * noise, 0.01)
                if missing_frac and rng.random() < missing_frac:
                    kept[b] = False
            args = (work / f"{sid}_SYN.regions.bed.gz", chrom, bins[kept], depths[kept])
            if pool is None:
                _write_bed(*args)
            else:
                written.append(pool.submit(_write_bed, *args))
        for done in written:
            done.result()

    # read counts: proportional to depth * CN dose over the window
    counts_file = results / "read_counts.tsv"
    with open(counts_file, "w") as f:
        f.write(f"Sample\t{chrom}:{window_start}-{window_end}\n")
        for i, sid in enumerate(ids):
            lam = reads_per_copy * dip_cn[i] * base_depth[i] / mean_depth
            f.write(f"{sid}\t{int(rng.poisson(lam))}\n")

    # optional: real BAM/CRAM alignments matching the depth model
    aln_dir = out / "alignments"
    if make_alignments:
        aln_dir.mkdir(parents=True, exist_ok=True)
        chrom_len = all_bins[-1][1] + 10_000
        # the draws stay in this process, in the JAX package's order; only
        # the encoding and writing of each file goes to the workers
        workers = min(os.cpu_count() or 1, n_samples // SAMPLES_PER_WRITER)
        spawn = multiprocessing.get_context("spawn")
        written = []
        with (ProcessPoolExecutor(workers, mp_context=spawn) if workers > 1
              else nullcontext()) as pool:
            for i, sid in enumerate(ids):
                positions = []
                for (bs, be) in all_bins:
                    in_window = bs >= window_start and be <= window_end
                    dose = dip_cn[i] / 2 if in_window else 1.0
                    depth = base_depth[i] * dose
                    n_reads = max(int(round(depth * (be - bs) / read_len)), 0)
                    positions.extend(
                        int(p) for p in rng.integers(bs, max(be - read_len, bs + 1), size=n_reads)
                    )
                positions.sort()
                # cigar choices drawn AFTER sorting so the rng stream (and the
                # resulting alignments) are identical across file types
                cigs = [None] * len(positions)
                if indel_frac:
                    cig_set = _indel_cigars(read_len)
                    take = rng.random(size=len(positions)) < indel_frac
                    pick = rng.integers(0, len(cig_set), size=len(positions))
                    cigs = [cig_set[k] if t else None for t, k in zip(take, pick)]
                args = (aln_dir, file_type, chrom, chrom_len, sid, positions, cigs, read_len)
                if pool is None:
                    _write_alignments(*args)
                else:
                    written.append(pool.submit(_write_alignments, *args))
            for done in written:
                done.result()

    # repeat mask: a region far away (exercises the path without masking bins)
    mask_file = out / "repeat_mask.bed"
    mask_file.write_text(f"{chrom}\t1000000\t1002000\n")

    # IBS neighbors: each haplotype is matched to the haplotypes (of OTHER
    # samples) with the closest true copy number — the structure real IBS
    # sharing implies (shared haplotype => shared repeat allele). This makes
    # end-to-end haploid-CN recovery a measurable property of the cohort.
    flat_cn = hap_cn.reshape(-1)  # index h = 2*i + hap0
    ibs_file = out / "ibs_neighbors.tsv.gz"
    with gzip.open(ibs_file, "wt") as f:
        f.write("ID\thap\tnbrInd\tcMlen\tcMedge\tIDnbr\thapNbr\n")
        for i, sid in enumerate(ids):
            for hap0 in (0, 1):
                h = 2 * i + hap0
                order = np.argsort(np.abs(flat_cn - flat_cn[h]))
                picked = 0
                for g in order:
                    if g // 2 == i:
                        continue  # never own haplotypes
                    j, nbr_hap0 = int(g // 2), int(g % 2)
                    f.write(
                        f"{sid}\t{hap0 + 1}\t{j}\t2.5\t0.1\t{ids[j]}\t{nbr_hap0 + 1}\n"
                    )
                    picked += 1
                    if picked == 3:
                        break

    # iLASH-format IBD segments between consecutive samples
    ibd_file = out / "ibd_segments.tsv"
    with open(ibd_file, "w") as f:
        for i in range(n_samples):
            j = (i + 1) % n_samples
            f.write(
                f"{ids[i]}\t{ids[i]}_0\t{ids[j]}\t{ids[j]}_1\t{chrom.lstrip('chr')}\t"
                f"{window_start - 50_000}\t{window_end + 50_000}\t0\t0\t3.2\t0.95\n"
            )

    truth_file = results / "truth_hap_cn.tsv"
    with open(truth_file, "w") as f:
        f.write("ID\thap1\thap2\tdip\n")
        for i, sid in enumerate(ids):
            f.write(f"{sid}\t{hap_cn[i,0]:.4f}\t{hap_cn[i,1]:.4f}\t{dip_cn[i]:.4f}\n")

    # The config window spans the WHOLE covered region (window + flanks):
    # normalization must see bins beyond the VNTR so the per-sample scale
    # reflects baseline depth, not the CN signal itself (the genome-wide
    # normalization design; a window-only matrix makes scale ∝ CN and the
    # dipCN signal cancels).
    span_start = all_bins[0][0]
    span_end = all_bins[-1][1]
    config = {
        "samples_file": str(samples_file),
        "directory_loc": str(aln_dir),
        "reference_genome": str(samples_file),  # placeholder existing file
        "output_dir": str(results),
        "threads": 2,
        "file_type": file_type,
        "chrom": chrom,
        "start_bp": span_start,
        "end_bp": span_end,
        "output_file_type": "tsv",
        "index": {"run": make_alignments, "output_file_prefix": "index_file_results"},
        "count_reads": {
            "run": make_alignments,
            "output_file_prefix": "read_counts",
            "flags": [83, 147, 81, 145],
        },
        "mosdepth": {
            "run": make_alignments,
            "output_file_prefix": "mosdepth_results",
            "bin_size": bin_size,
            "mode": "fast",
            "region_name": "SYN",
            "work_dir": str(work),
            "remove_intermediate": False,
            "normalize": {
                "run": True,
                "min_depth": 10 if not make_alignments else 2,
                "max_depth": 100,
                "top_frac": 0.1,
                "output_file_prefix": "mosdepth_results_normalized",
                "repeat_mask_file": str(mask_file),
            },
            # num_neighbors = N-1: with small synthetic cohorts the neighbor
            # mean must approximate the cohort mean, otherwise depth-profile
            # matching pairs samples of similar CN and divides the signal out
            # (the real pipeline relies on zmax clipping + k=500 for this).
            "neighbors": {
                "run": True,
                "output_file_prefix": "neighbor_coverage",
                "num_neighbors": n_samples - 1,
                "zmax": 2.0,
                "sigma2_max": 1000,
            },
        },
        "compute_diploid_genotypes": {
            "run": True,
            "output_file_prefix": "diploid_genotypes",
            "n_nbr": min(300, n_samples - 1),
        },
        "compute_haploid_genotypes": {
            "run": True,
            "output_file_prefix": "haploid_genotypes",
            "method": "ibs",
            "ibs_output": str(ibs_file),
            "min_neighbors": 1,
            "max_neighbors": 10,
            "n_iters": 100,
        },
    }
    # config.yaml needs pyyaml; without it the returned dict carries the config
    try:
        import yaml
    except ImportError:
        config_file = None
    else:
        config_file = out / "config.yaml"
        with open(config_file, "w") as f:
            yaml.safe_dump(config, f, sort_keys=False)

    return {
        "ids": ids,
        "hap_cn": hap_cn,
        "dip_cn": dip_cn,
        "base_depth": base_depth,
        "config": config,
        "config_file": config_file,
        "samples_file": samples_file,
        "counts_file": counts_file,
        "work_dir": work,
        "results_dir": results,
        "ibs_file": ibs_file,
        "ibd_file": ibd_file,
        "mask_file": mask_file,
    }
