"""Batched Smith-Waterman local alignment (twin of ``grid_tpu/ops/align.py``).

Scores thousands of reads against a handful of exon references for the
exon-classification realignment path (:mod:`grid_tpu_torch.models.realign`).
Linear gap penalties: the classification needs relative scores, not optimal
affine alignments.

Sequences are integer-encoded on the host (A=0 C=1 G=2 T=3, N, IUPAC codes
and pad = 4; a reference code 4 never matches, and a read position with
code 4 leaves the row as it is).

:func:`sw_scores` dispatches by the tensors' device: CUDA tensors go to the
hand kernel (:func:`grid_tpu_torch.ops.gpu_align.sw_scores_gpu`, which
launches or raises), CPU tensors to :func:`sw_scores_plain`, the plain
version: the JAX package's scan over query positions, one [Q, T, Lr] int32
row slab a step, written in PyTorch with the same integer arithmetic.
:func:`classify_reads` stays host numpy, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

_CODE = {"A": 0, "C": 1, "G": 2, "T": 3}
# the code of every byte: A/C/G/T in either case, everything else 4
_LUT = np.full(256, 4, dtype=np.int8)
for _i, _b in enumerate("ACGT"):
    _LUT[ord(_b)] = _LUT[ord(_b.lower())] = _i


def _encode_loop(seqs, out: np.ndarray, length: int) -> None:
    """The JAX package's per-character encoding; kept for strings that are
    not ASCII, whose ``upper()`` may change their length."""
    for i, s in enumerate(seqs):
        for j, b in enumerate(s[:length].upper()):
            out[i, j] = _CODE.get(b, 4)


def encode_seqs(seqs, length: int | None = None) -> np.ndarray:
    """Encode sequences to a padded [n, L] int8 array (pad/N = 4).

    ASCII sequences, cut or padded to L, go through one table lookup over
    their joined bytes; anything else through the per-character loop. Both
    give the JAX package's codes."""
    if length is None:
        length = max((len(s) for s in seqs), default=0)
    if not len(seqs) or length == 0:
        return np.full((len(seqs), length), 4, dtype=np.int8)
    try:
        raw = "".join([s[:length].ljust(length, "N") for s in seqs]).encode("ascii")
    except (AttributeError, TypeError, UnicodeEncodeError):
        out = np.full((len(seqs), length), 4, dtype=np.int8)
        _encode_loop(seqs, out, length)
        return out
    return _LUT[np.frombuffer(raw, dtype=np.uint8)].reshape(len(seqs), length)


def sw_scores_plain(queries: torch.Tensor, refs: torch.Tensor, match: int = 2,
                    mismatch: int = -1, gap: int = -2) -> torch.Tensor:
    """Best local-alignment score of every query against every reference,
    the plain version: ``grid_tpu/ops/align.py:sw_scores``'s scan.

    Args:
        queries: [Q, Lq] int8 or uint8 encoded reads (pad=4).
        refs: [T, Lr] encoded references (pad=4), on the same device.

    Returns scores [Q, T] int32 on the inputs' device.
    """
    q, lq = queries.shape
    t, lr = refs.shape
    device = queries.device
    best = torch.zeros((q, t), dtype=torch.int32, device=device)
    if not (q and t and lq and lr):
        return best
    ref = refs.to(torch.int32)[None]
    ref_ok = ref != 4
    # the left dependency within the row as a running max: with linear gaps
    # H[j] = max_{j'<=j} (base[j'] + (j - j')*gap), so u[j] = base[j] - j*gap
    # is a plain cumulative max (the JAX package's transform)
    decay = (torch.arange(lr, dtype=torch.int32, device=device) * (-gap))[None, None, :]
    prev = torch.zeros((q, t, lr), dtype=torch.int32, device=device)
    zero = torch.zeros((), dtype=torch.int32, device=device)
    cols = queries.to(torch.int32).T
    for i in range(lq):
        q_col = cols[i][:, None, None]
        valid_q = q_col != 4
        sub = torch.where((q_col == ref) & ref_ok, match, mismatch).to(torch.int32)
        diag = torch.nn.functional.pad(prev[:, :, :-1], (1, 0)) + sub
        up = prev + gap
        base = torch.maximum(torch.maximum(diag, up), zero)
        base = torch.where(valid_q, base, torch.maximum(prev, zero))
        u = torch.cummax(base + decay, dim=2).values
        row = torch.where(valid_q, u - decay, base)
        best = torch.maximum(best, row.amax(dim=2))
        prev = row
    return best


def sw_scores(queries: torch.Tensor, refs: torch.Tensor, match: int = 2, mismatch: int = -1,
              gap: int = -2) -> torch.Tensor:
    """Best local-alignment score of every query against every reference:
    [Q, Lq] and [T, Lr] encoded int8/uint8 tensors → [Q, T] int32.

    The JAX package's name for the kernel's wrapper, which decides: CUDA
    tensors launch the hand kernel or raise, CPU tensors take
    :func:`sw_scores_plain`. The wrapper's module imports this one, hence
    the import here."""
    from grid_tpu_torch.ops.gpu_align import sw_scores_gpu

    return sw_scores_gpu(queries, refs, match=match, mismatch=mismatch, gap=gap)


def sw_score_host(query: str, ref: str, match=2, mismatch=-1, gap=-2) -> int:
    """Tiny O(len^2) host oracle for tests. Unlike :func:`sw_scores`, it
    scores a mismatch at a read's N: hold only ACGT reads to it."""
    lq, lr = len(query), len(ref)
    h = np.zeros((lq + 1, lr + 1), dtype=np.int64)
    best = 0
    for i in range(1, lq + 1):
        for j in range(1, lr + 1):
            s = match if query[i - 1].upper() == ref[j - 1].upper() else mismatch
            h[i, j] = max(0, h[i - 1, j - 1] + s, h[i - 1, j] + gap, h[i, j - 1] + gap)
            best = max(best, h[i, j])
    return int(best)


def classify_reads(queries, refs, labels, min_score: int, margin: int = 0,
                   match: int = 2, mismatch: int = -1, gap: int = -2, device="cuda"):
    """Assign each read to the best-scoring reference (or none).

    Args:
        queries: [Q, Lq] encoded reads (numpy or tensor).
        refs: [T, Lr] encoded references.
        labels: T label strings aligned with refs.
        min_score: required best score.
        margin: best must beat second-best by at least this much ("tied"
            reads get label None unless margin == 0).
        device: where the scores are computed ("cuda" unless the caller
            asks for "cpu").

    Returns: (assigned list[str|None], scores np.ndarray [Q, T]).
    """
    scores = sw_scores(torch.as_tensor(queries, device=device),
                       torch.as_tensor(refs, device=device),
                       match=match, mismatch=mismatch, gap=gap).cpu().numpy()
    # the JAX package's call on the same host array: ties between
    # references get the same labels
    order = np.argsort(-scores, axis=1)
    best = order[:, 0]
    best_s = scores[np.arange(len(scores)), best]
    second_s = (
        scores[np.arange(len(scores)), order[:, 1]] if scores.shape[1] > 1 else
        np.full(len(scores), -(10**9))
    )
    assigned = []
    for i in range(len(scores)):
        if best_s[i] >= min_score and (best_s[i] - second_s[i]) >= margin:
            assigned.append(labels[best[i]])
        else:
            assigned.append(None)
    return assigned, scores
