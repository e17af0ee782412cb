"""grid_tpu_torch phasing against grid_tpu on the same numpy inputs.

Tolerances: float64 at 1e-9 (docs/parity.md); float32 at 1e-6 relative —
the sweeps repeat the same float32 arithmetic, and the row sums of K
neighbors may round in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grid_tpu.ops.phasing import compute_imputed as j_imputed
from grid_tpu.ops.phasing import phase_haplotypes as j_phase
from grid_tpu_torch.io.hap_neighbors import pad_hap_neighbors
from grid_tpu_torch.ops.phasing import compute_imputed, phase_haplotypes


def _inputs(dt, n=64, max_nbr=4, seed=7):
    rng = np.random.default_rng(seed)
    irrs = rng.uniform(1.0, 6.0, n).astype(dt)
    irrs[[3, 17]] = np.nan  # samples without a dipCN
    hap_nbrs = []
    for h in range(2 * n):
        deg = int(rng.integers(0, max_nbr + 1)) if h % 11 else 0  # some empty lists
        hap_nbrs.append([(int(rng.integers(0, 2 * n)), float(rng.uniform(0.1, 1.0)))
                         for _ in range(deg)])
    return irrs, pad_hap_neighbors(hap_nbrs, max_nbr)


@pytest.mark.parametrize("dt,rtol", [(np.float64, 1e-9), (np.float32, 1e-6)])
@pytest.mark.parametrize("min_nbr,n_iters", [(1, 0), (1, 10), (2, 25)])
def test_phase_and_impute(dt, rtol, min_nbr, n_iters):
    irrs, (hi, hw, hv) = _inputs(dt)
    want = j_phase(jnp.asarray(irrs), jnp.asarray(hi), jnp.asarray(hw), jnp.asarray(hv),
                   min_nbr, n_iters)
    t = [torch.from_numpy(a) for a in (irrs, hi, hw, hv)]
    got = phase_haplotypes(*t, min_nbr, n_iters)
    np.testing.assert_array_equal(got.phased.numpy(), np.asarray(want.phased))
    np.testing.assert_allclose(got.hap_irrs.numpy(), np.asarray(want.hap_irrs), rtol=rtol)
    np.testing.assert_allclose(float(got.mean_irrs), float(want.mean_irrs), rtol=rtol)
    assert got.hap_irrs.dtype == t[0].dtype

    imp = compute_imputed(got.hap_irrs, t[1], t[2], t[3], got.mean_irrs)
    want_imp = j_imputed(want.hap_irrs, jnp.asarray(hi), jnp.asarray(hw), jnp.asarray(hv),
                         want.mean_irrs)
    np.testing.assert_allclose(imp.numpy(), np.asarray(want_imp), rtol=rtol)


def test_nobody_phased_gives_zero_mean():
    irrs, (hi, hw, hv) = _inputs(np.float64)
    hv[:] = False
    got = phase_haplotypes(*[torch.from_numpy(a) for a in (irrs, hi, hw, hv)], 1, 5)
    assert not got.phased.any() and float(got.mean_irrs) == 0.0
    assert torch.isnan(got.hap_irrs).all()


def test_pad_hap_neighbors_copy_matches_grid_tpu():
    from grid_tpu.io.hap_neighbors import pad_hap_neighbors as j_pad

    nbrs = [[(1, 0.5), (3, 0.25)], [], [(0, 1.0)], [(2, 0.1), (0, 0.2), (1, 0.3)]]
    for max_nbr in (1, 2, 5):
        for got, want in zip(pad_hap_neighbors(nbrs, max_nbr), j_pad(nbrs, max_nbr)):
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype


# ---------------------------------------------------------------------------
# The arithmetic of csrc/phase_sweeps.cu, emulated in numpy float32: per
# haplotype the slot-order sums of w and w * val over the valid non-NaN
# neighbors (each product and sum rounded on its own: the kernel uses no
# fused multiply-add), m = wval / (1e-9 + wsum), new = irr * m / (m0 + m1),
# the old value kept where m0 + m1 <= 0 or it is NaN, and samples with two
# NaN values skipped. Held to grid_tpu's phase_haplotypes at rtol 1e-6 with
# the NaN pattern exact.
# ---------------------------------------------------------------------------


def _emulate_phase_sweeps(hap0, irrs, idx, w, valid, n_iters):
    """hap [B, 2N] after n_iters sweeps from hap0 [2N]; idx and w [B, 2N, K]
    (one set of lists per replicate), valid [2N, K]."""
    f32 = np.float32
    reps, two_n, k = idx.shape
    hap = np.broadcast_to(hap0.astype(f32), (reps, two_n)).copy()
    with np.errstate(invalid="ignore", divide="ignore"):
        for _ in range(n_iters):
            nxt = hap.copy()
            for b in range(reps):
                cur = hap[b]
                wsum = np.zeros(two_n, f32)
                wval = np.zeros(two_n, f32)
                for s in range(k):  # slot order
                    v = cur[idx[b, :, s]]
                    ok = valid[:, s] & ~np.isnan(v)
                    wsum = np.where(ok, wsum + w[b, :, s], wsum).astype(f32)
                    wval = np.where(ok, wval + (w[b, :, s] * v).astype(f32), wval).astype(f32)
                m = (wval / (f32(1e-9) + wsum)).astype(f32)
                m0, m1 = m[0::2], m[1::2]
                denom = (m0 + m1).astype(f32)
                o0, o1 = cur[0::2], cur[1::2]
                skip = np.isnan(o0) & np.isnan(o1)
                hold = denom <= 0
                new0 = ((irrs * m0).astype(f32) / denom).astype(f32)
                new1 = ((irrs * m1).astype(f32) / denom).astype(f32)
                nxt[b, 0::2] = np.where(skip | hold | np.isnan(o0), o0, new0)
                nxt[b, 1::2] = np.where(skip | hold | np.isnan(o1), o1, new1)
            hap = nxt
    return hap


def _start(irrs, hv, min_nbr):
    deg = hv.sum(axis=1).reshape(-1, 2)
    phased = (deg[:, 0] >= min_nbr) & (deg[:, 1] >= min_nbr) & np.isfinite(irrs)
    hap0 = np.where(phased, irrs / np.float32(2), np.float32(np.nan)).astype(np.float32)
    return np.repeat(hap0, 2)


def _ring_inputs(n, seed=5):
    """The slice's ring lists at N samples: haplotype h's neighbors h + 2
    (weight 1.0) and h - 2 (0.5), every 11th list empty, some NaN samples."""
    rng = np.random.default_rng(seed)
    irrs = rng.uniform(1.0, 6.0, n).astype(np.float32)
    irrs[rng.random(n) < 0.02] = np.nan
    hap_nbrs = [[] if h % 11 == 0 else [((h + 2) % (2 * n), 1.0), ((h - 2) % (2 * n), 0.5)]
                for h in range(2 * n)]
    return irrs, pad_hap_neighbors(hap_nbrs, 2)


# (min_nbr, n_iters, lists): the small random lists of _inputs, and the
# slice's full width, N=2504, with its ring lists (K=2) and with random
# lists of the pipeline's default max_neighbors (K=10), 100 sweeps
_ARITHMETIC_CASES = [
    *(pytest.param(m, i, None, id=f"{m}-{i}") for m, i in
      ((1, 0), (1, 1), (1, 10), (2, 25), (1, 100))),
    pytest.param(1, 100, "ring", id="1-100-N2504-ring-K2"),
    pytest.param(1, 100, "random", id="1-100-N2504-random-K10"),
]


@pytest.mark.parametrize("min_nbr,n_iters,lists", _ARITHMETIC_CASES)
def test_phase_sweeps_kernel_arithmetic(min_nbr, n_iters, lists):
    if lists == "ring":
        irrs, (hi, hw, hv) = _ring_inputs(2504)
    elif lists == "random":
        irrs, (hi, hw, hv) = _inputs(np.float32, n=2504, max_nbr=10, seed=11)
    else:
        irrs, (hi, hw, hv) = _inputs(np.float32)
    want = j_phase(jnp.asarray(irrs), jnp.asarray(hi), jnp.asarray(hw), jnp.asarray(hv),
                   min_nbr, n_iters)
    got = _emulate_phase_sweeps(_start(irrs, hv, min_nbr), irrs, hi[None], hw[None], hv,
                                n_iters)[0]
    want_hap = np.asarray(want.hap_irrs)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want_hap))
    np.testing.assert_allclose(got, want_hap, rtol=1e-6)
    assert np.isnan(got).sum() > 0 and np.isfinite(got).sum() > 0


@pytest.mark.parametrize("n_iters", [1, 30])
def test_phase_sweeps_kernel_arithmetic_on_replicates(n_iters):
    """Bootstrap replicates (each haplotype's slots drawn with numpy within
    its degree): every replicate equals grid_tpu's phase_haplotypes on its
    own gathered lists; the port's plain replicate batch too."""
    from grid_tpu_torch.ops.phasing import phase_bootstrap_slots

    irrs, (hi, hw, hv) = _inputs(np.float32, seed=9)
    rng = np.random.default_rng(3)
    deg = np.maximum(hv.sum(axis=1), 1)
    slots = (rng.random((5, *hi.shape)) * deg[None, :, None]).astype(np.int64)
    bi = np.take_along_axis(np.broadcast_to(hi, slots.shape), slots, axis=2)
    bw = np.take_along_axis(np.broadcast_to(hw, slots.shape), slots, axis=2)
    got = _emulate_phase_sweeps(_start(irrs, hv, 1), irrs, bi, bw, hv, n_iters)
    for b in range(slots.shape[0]):
        want = np.asarray(j_phase(jnp.asarray(irrs), jnp.asarray(bi[b]), jnp.asarray(bw[b]),
                                  jnp.asarray(hv), 1, n_iters).hap_irrs)
        np.testing.assert_array_equal(np.isnan(got[b]), np.isnan(want))
        np.testing.assert_allclose(got[b], want, rtol=1e-6)
    _, _, plain = phase_bootstrap_slots(*[torch.from_numpy(a) for a in (irrs, hi, hw, hv)],
                                        torch.from_numpy(slots), 1, n_iters)
    np.testing.assert_array_equal(np.isnan(plain.numpy()), np.isnan(got))
    np.testing.assert_allclose(plain.numpy(), got, rtol=1e-6)


def test_phase_sweeps_wrapper_takes_the_plain_route_on_cpu():
    from grid_tpu_torch.ops.phasing import phase_sweeps, phase_sweeps_gpu

    irrs, (hi, hw, hv) = _inputs(np.float32)
    t = [torch.from_numpy(a) for a in (irrs, hi, hw, hv)]
    hap0 = torch.from_numpy(_start(irrs, hv, 1))
    before = phase_sweeps_gpu.launches
    got = phase_sweeps_gpu(hap0, *t, 12)
    assert phase_sweeps_gpu.launches == before
    assert torch.equal(got.isnan(), phase_sweeps(hap0, *t, 12).isnan())
    torch.testing.assert_close(got, phase_sweeps(hap0, *t, 12), rtol=0, atol=0,
                               equal_nan=True)
    torch.testing.assert_close(got, phase_haplotypes(*t, 1, 12).hap_irrs, rtol=0, atol=0,
                               equal_nan=True)
