"""Reference-compatible on-disk formats (twin of ``grid_tpu/io/formats.py``,
numpy only).

Data flow between pipeline steps is file-based, so these formats ARE the
public step API. Each reader/writer documents the reference producer/consumer
it is exchange-compatible with:

1.  samples file — one ID per line              (grid/utils/utils.py:76-78)
2.  read-counts TSV                             (grid/utils/count_reads.py:158-160)
6.  normalized matrix .tsv.gz                   (grid/utils/normalize_mosdepth.py:515-554)
7.  neighbors .tsv.gz                           (grid/utils/find_neighbors.py:242-267)
8.  dipCN TSV                                   (grid/utils/compute_dipcn.py:99-100)
11. haploid output TSV                          (grid/utils/hi_inference.py:329-337)

(4/5 bed.gz + repeat mask live in :mod:`grid_tpu_torch.io.bed`; 9/10 IBS/IBD
inputs in :mod:`grid_tpu_torch.io.hap_neighbors`.)

The two large writers, the normalized matrix and the neighbors file, take
the native route first, as in ``grid_tpu/io/formats.py``: the host
library's C++ writers (:mod:`grid_tpu_torch.native_host`, copies of the
JAX package's) format the cells and write level-1 BGZF blocks. They are
skipped for ``GRID_TPU_NATIVE_WRITERS=0``, for ``GRID_TPU_GZ_LEVEL`` other
than 1 and where the library is not loaded (warned once); then the Python
writers below run. A native writer that fails raises. Every route gives the
decompressed bytes of the JAX package's Python writers.
"""

from __future__ import annotations

import ctypes
import gzip
import os
from pathlib import Path

import numpy as np

from grid_tpu_torch import native_host


def _gz_level() -> int:
    """Output gzip level of the large writers: 1 unless ``GRID_TPU_GZ_LEVEL``
    says otherwise (the decompressed content, which is the parity contract,
    is the same at every level). Read at call time."""
    return int(os.environ.get("GRID_TPU_GZ_LEVEL", "1"))


def open_maybe_gz(path, mode="rt"):
    """Open plain or gzipped text transparently (ref: grid/utils/utils.py:250-253)."""
    if str(path).endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


# ---------------------------------------------------------------- samples ---


def read_samples(samples_file) -> list[str]:
    """One sample ID per line, blanks skipped (ref: grid/utils/utils.py:76-78)."""
    with open(samples_file) as f:
        return [line.strip() for line in f if line.strip()]


def write_samples(samples_file, sample_ids) -> None:
    with open(samples_file, "w") as f:
        for s in sample_ids:
            f.write(f"{s}\n")


# ------------------------------------------------- per-sample value TSVs ---


def setup_output_file(output_file, chrom, start, end) -> Path:
    """Create a TSV with header ``Sample\\t{chrom}:{start}-{end}``
    (ref: grid/utils/utils.py:92-111)."""
    output_path = Path(output_file).expanduser()
    output_path.parent.mkdir(parents=True, exist_ok=True)
    with open(output_path, "w") as f:
        f.write(f"Sample\t{chrom}:{start}-{end}\n")
    return output_path


def read_counts_tsv(path) -> dict[str, float]:
    """Read a counts/coverage TSV into {sample: value}, skipping the header
    and non-numeric rows (matches pandas + to_numeric/dropna semantics of
    grid/utils/compute_dipcn.py:46-49)."""
    out: dict[str, float] = {}
    with open_maybe_gz(path) as f:
        first = True
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 2:
                continue
            if first:
                first = False
                # header row "Sample\tchrom:start-end" — always skipped
                if parts[0] == "Sample":
                    continue
            try:
                out[parts[0]] = float(parts[1])
            except ValueError:
                continue
    return out


# ------------------------------------------------ normalized matrix .gz ---


def write_normalized_output(
    path,
    sample_ids,
    sample_scales,
    z_matrix,
    z_mask,
    col_means,
    col_vars,
    selected_indices,
    ratio_mult: float = 100.0,
) -> None:
    """Write the 2-header normalized matrix format
    (ref: grid/utils/normalize_mosdepth.py:502-554).

    Line 0 : N  Rwant  mu_1 ... mu_Rwant           (%.3f, NA for NaN)
    Line 1 : N  Rwant  varRatio_1 ... varRatio_R   (%.3f, NA for NaN)
    Line 2+: ID  scale(%.2f)  z_1 ... z_Rwant      (%.2f, NA for NaN)

    Args:
        sample_ids: N sample IDs (row order).
        sample_scales: per-sample raw mean depth (the ``scale`` column,
            written in 1x units — quirk Q4: this is NOT the 100x coverage
            integer of the coverage TSV).
        z_matrix / z_mask: [N, R] values and validity mask (mask False -> NA).
        col_means / col_vars: per-region stats over ALL R columns.
        selected_indices: column indices to keep, ascending.
    """
    sel = np.asarray(selected_indices, dtype=int)
    n = len(sample_ids)
    r_want = len(sel)
    sel_means = np.asarray(col_means)[sel]
    sel_vars = np.asarray(col_vars)[sel]
    with np.errstate(invalid="ignore", divide="ignore"):
        sel_ratios = np.where(sel_means > 0, ratio_mult * sel_vars / sel_means, np.nan)

    z_sel = np.asarray(z_matrix)[:, sel]
    m_sel = np.asarray(z_mask)[:, sel]

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)

    if _native_write_normalized(path, sample_ids, sample_scales, z_sel, m_sel, sel_means,
                                sel_ratios):
        return

    def _fmt_row(vals, valid, fmt):
        # vectorized %-formatting (np.char.mod uses the same C printf as
        # f-strings, so output is byte-identical to a per-cell loop)
        safe = np.where(valid, vals, 0.0)
        cells = np.char.mod(fmt, safe)
        return "\t".join(np.where(valid, cells, "NA").tolist())

    with gzip.open(path, "wt", compresslevel=_gz_level()) as out:
        out.write(f"{n}\t{r_want}\t" + _fmt_row(sel_means, ~np.isnan(sel_means), "%.3f") + "\n")
        out.write(f"{n}\t{r_want}\t" + _fmt_row(sel_ratios, ~np.isnan(sel_ratios), "%.3f") + "\n")
        for i, sid in enumerate(sample_ids):
            out.write(
                f"{sid}\t{sample_scales[i]:.2f}\t"
                + _fmt_row(z_sel[i], m_sel[i], "%.2f")
                + "\n"
            )


def read_normalized_data(path):
    """Parse the normalized matrix file
    (ref: grid/utils/find_neighbors.py:81-124).

    Returns:
        sample_ids   : list[str] length N
        sigma2ratios : np.ndarray [Rwant] (NaN for NA)
        data_matrix  : np.ndarray [N, Rwant] float64 (NaN for NA)
        scales       : dict {sample_id: scale}
    """
    sample_ids: list[str] = []
    scales: dict[str, float] = {}
    rows = []
    with gzip.open(path, "rt") as f:
        _ = f.readline()  # header row 0: means (read to advance, unused)
        parts = f.readline().strip().split("\t")
        sigma2ratios = np.array(
            [np.nan if v in ("NA", "nan") else float(v) for v in parts[2:]], dtype=float
        )
        for line in f:
            parts = line.strip().split("\t")
            if len(parts) < 2:
                continue
            sid = parts[0]
            scale = float(parts[1])
            zvals = [np.nan if v in ("NA", "nan") else float(v) for v in parts[2:]]
            sample_ids.append(sid)
            scales[sid] = scale
            rows.append(zvals)
    data_matrix = np.array(rows, dtype=float)
    return sample_ids, sigma2ratios, data_matrix, scales


# ----------------------------------------------------- neighbors .tsv.gz ---


def neighbors_filename(output_dir, prefix, zmax, file_type="tsv") -> Path:
    """``{prefix}.zMax{zmax:.1f}.{type}.gz`` (ref: grid/utils/find_neighbors.py:45)."""
    return Path(output_dir) / f"{prefix}.zMax{zmax:.1f}.{file_type}.gz"


def write_neighbors_dense(path, sample_ids, scales, nbr_idx, nbr_norm_dists) -> None:
    """Neighbors writer for the dense ``[N, k]`` outputs of the fused step
    (ref format: grid/utils/find_neighbors.py:231-267). Per line:
    ``ID  scale(%.2f)  [nbrID  nbrScale(%.2f)  normDist(%.2f)]*`` where
    normDist is squared Euclidean distance / (2 * R_use) — quirk Q5. Whole
    columns are formatted with ``np.char.mod``.

    Args:
        sample_ids: N IDs (row order).
        scales: ``[N]`` per-sample scales.
        nbr_idx: int ``[N, k]`` neighbor ROW indices into ``sample_ids``.
        nbr_norm_dists: ``[N, k]`` already-normalized distances (sq/(2*R_use));
            pass in the array's native dtype — formatting converts per-element.
    """
    ids = np.asarray(sample_ids, dtype=object)
    scales = np.asarray(scales)
    nbr_idx = np.asarray(nbr_idx)
    n, k = nbr_idx.shape
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)

    # k=0 lines are the IDs and scales alone: the Python writer's, as in grid_tpu
    if k and _native_write_neighbors(path, sample_ids, scales, nbr_idx, nbr_norm_dists):
        return

    own = np.char.mod("%.2f", scales.astype(float))
    cells = np.empty((n, 2 + 3 * k), dtype=object)
    cells[:, 0] = ids
    cells[:, 1] = own
    if k:
        cells[:, 2::3] = ids[nbr_idx]
        cells[:, 3::3] = np.char.mod("%.2f", scales[nbr_idx])
        cells[:, 4::3] = np.char.mod("%.2f", np.asarray(nbr_norm_dists))
    with gzip.open(path, "wt", compresslevel=_gz_level()) as out:
        for row in cells:
            out.write("\t".join(row))
            out.write("\n")


# ------------------------------------------------------ native writers ---

# what grid_write_normalized / grid_write_neighbors return (textgz.cpp)
_WRITE_ERRORS = {-1: "the file did not open", -2: "a write or the close failed",
                 -3: "a neighbor index is out of range"}


def _native_writer_lib():
    """The host library when the native writers apply, else None."""
    if os.environ.get("GRID_TPU_NATIVE_WRITERS", "1") == "0":
        return None
    if os.environ.get("GRID_TPU_GZ_LEVEL", "1") != "1":
        return None  # the native sink writes level 1 only
    return native_host.lib()


def _ids_buffer(sample_ids) -> bytes:
    """The IDs as the C writers take them: UTF-8, each ended by a NUL."""
    return b"".join(str(s).encode() + b"\0" for s in sample_ids)


def _f64(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.float64))


def _check_write(function: str, path, rc: int) -> None:
    if rc != 0:
        raise OSError(f"{function}({path}) failed with code {rc}: "
                      f"{_WRITE_ERRORS.get(rc, 'unknown code')}")


def _native_write_normalized(path, sample_ids, scales, z_sel, m_sel, sel_means, sel_ratios) -> bool:
    """grid_write_normalized; False when the native writers do not apply."""
    lib = _native_writer_lib()
    if lib is None:
        return False
    pd = ctypes.POINTER(ctypes.c_double)
    n = len(sample_ids)
    r = z_sel.shape[1]
    z64, s64, mu64, ra64 = _f64(z_sel), _f64(scales), _f64(sel_means), _f64(sel_ratios)
    if z64.shape != (n, r) or m_sel.shape != (n, r) or s64.shape != (n,) or mu64.shape != (r,) \
            or ra64.shape != (r,):
        raise ValueError(f"write_normalized_output: shapes z {z64.shape}, mask {m_sel.shape}, "
                         f"scales {s64.shape}, means {mu64.shape}, ratios {ra64.shape} for "
                         f"{n} samples")
    m8 = np.ascontiguousarray(np.asarray(m_sel, dtype=np.uint8))
    rc = lib.grid_write_normalized(
        str(path).encode(), _ids_buffer(sample_ids), n, r,
        s64.ctypes.data_as(pd), z64.ctypes.data_as(pd),
        m8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        mu64.ctypes.data_as(pd), ra64.ctypes.data_as(pd),
    )
    _check_write("grid_write_normalized", path, rc)
    return True


def _native_write_neighbors(path, sample_ids, scales, nbr_idx, dists) -> bool:
    """grid_write_neighbors; False when the native writers do not apply."""
    lib = _native_writer_lib()
    if lib is None:
        return False
    pd = ctypes.POINTER(ctypes.c_double)
    s64 = _f64(scales)
    idx64 = np.ascontiguousarray(np.asarray(nbr_idx, dtype=np.int64))
    d64 = _f64(dists)
    n, k = idx64.shape
    if len(sample_ids) != n or s64.shape != (n,) or d64.shape != (n, k):
        raise ValueError(f"write_neighbors_dense: {len(sample_ids)} IDs, scales {s64.shape}, "
                         f"indices {idx64.shape}, distances {d64.shape}")
    rc = lib.grid_write_neighbors(
        str(path).encode(), _ids_buffer(sample_ids), n, k, s64.ctypes.data_as(pd),
        idx64.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), d64.ctypes.data_as(pd),
    )
    _check_write("grid_write_neighbors", path, rc)
    return True


def read_neighbors(path):
    """Parse a neighbors file (ref: grid/utils/compute_dipcn.py:105-152).

    Returns:
        neighbors     : {sample_id: [(nbr_id, nbr_scale, norm_dist), ...]}
        sample_scales : {sample_id: scale}
    """
    neighbors: dict[str, list[tuple[str, float, float]]] = {}
    sample_scales: dict[str, float] = {}
    with open_maybe_gz(path) as f:
        for line in f:
            parts = line.strip().split("\t")
            if len(parts) < 2:
                continue
            sid = parts[0]
            try:
                sample_scales[sid] = float(parts[1])
            except ValueError:
                continue
            nbr_list = []
            i = 2
            while i + 2 <= len(parts):
                nid = parts[i]
                try:
                    nscale = float(parts[i + 1])
                    ndist = float(parts[i + 2]) if i + 2 < len(parts) else float("nan")
                except ValueError:
                    i += 3
                    continue
                nbr_list.append((nid, nscale, ndist))
                i += 3
            neighbors[sid] = nbr_list
    return neighbors, sample_scales


# ------------------------------------------------------------- dipCN TSV ---


def write_dipcn(path, sample_ids, values) -> None:
    """``Sample\\tNorm_Reads`` TSV (ref: grid/utils/compute_dipcn.py:99-100).

    pandas ``to_csv`` writes full float repr; match that.
    """
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        f.write("Sample\tNorm_Reads\n")
        for sid, v in zip(sample_ids, values):
            # str(float) yields the shortest round-trip repr, matching what
            # pandas.to_csv wrote in the reference.
            f.write(f"{sid}\t{float(v)}\n")


def read_dipcn(path):
    """Read a diploid-CN file, skipping non-data rows
    (ref: grid/utils/hi_inference.py:10-31).

    Returns: (ids, irrs, id_to_ind) — list[str], list[float], {id: row}.
    """
    ids: list[str] = []
    irrs: list[float] = []
    id_to_ind: dict[str, int] = {}
    with open_maybe_gz(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split()
            if len(parts) < 2:
                continue
            try:
                irr = float(parts[1])
            except ValueError:
                continue  # header row
            id_to_ind[parts[0]] = len(irrs)
            ids.append(parts[0])
            irrs.append(irr)
    return ids, irrs, id_to_ind


# ------------------------------------------------------ haploid output ---


def write_haploid_output(path, sample_ids, irrs, hap1, hap2, imp1, imp2) -> None:
    """``ID IRRs hap1phased hap2phased hap1imp hap2imp`` at %.2f
    (ref: grid/utils/hi_inference.py:329-337)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wt") as f:
        f.write("ID\tIRRs\thap1phased\thap2phased\thap1imp\thap2imp\n")
        for i, sid in enumerate(sample_ids):
            f.write(
                f"{sid}\t{irrs[i]:.2f}\t{hap1[i]:.2f}\t{hap2[i]:.2f}\t{imp1[i]:.2f}\t{imp2[i]:.2f}\n"
            )
