"""PyTorch port, kernels K1, K2, K5 and K6: each kernel's plain PyTorch
version against the JAX package's Pallas function, run in interpret mode on
the CPU as ``test_ops_numerics.py`` runs it. The kernels themselves are
held against their plain versions on a GPU by ``test_torch_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_process_edge_trace_torch.ops import cuda_chol as cc
from gaussian_process_edge_trace_torch.ops import cuda_interp as ci
from gaussian_process_edge_trace_torch.trace.scoring import curve_costs
from gaussian_process_edge_trace_tpu.ops import pallas_chol as pc
from gaussian_process_edge_trace_tpu.ops import pallas_interp as pi
from gaussian_process_edge_trace_tpu.trace import scoring as ref_scoring
from torch_parity import j32, t32

torch.set_num_threads(1)


def _cols_ys(E, M, S, seed=11):
    """Non-negative columns and a mix of interior, integer and out-of-domain
    sample rows (the reference's own interp test inputs)."""
    rng = np.random.default_rng(seed)
    cols = rng.random((E, M)).astype(np.float32)
    ys = np.concatenate([rng.uniform(0, M - 1, (E, S - 16)),
                         rng.integers(0, M, (E, 8)).astype(float),
                         rng.uniform(-3, M + 3, (E, 8))],
                        axis=1).astype(np.float32)
    return cols, ys


def _curves(E, M, S, seed=5):
    """Smooth random-walk curves, like posterior draws."""
    rng = np.random.default_rng(seed)
    y = M / 2 + np.cumsum(rng.normal(0, 1.5, (E, S)), axis=0)
    return y.astype(np.float32)


def _spd(B, n, seed=7):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, n, n))
    return (A @ np.transpose(A, (0, 2, 1)) / n + np.eye(n)).astype(np.float32)


# --- K1 ----------------------------------------------------------------------

@pytest.mark.parametrize("E,M,S", [(48, 72, 160), (38, 61, 130)])
def test_fused_cost_plain_matches_pallas_kernel(E, M, S):
    """K1's plain version against ``_fused_cost_jit`` in interpret mode.
    The two sum the same pair terms in other orders; the bounds are the
    reference's own (test_ops_numerics.py:272-273)."""
    cols, ys = _cols_ys(E, M, S)
    fl, fa = (np.asarray(a) for a in pi._fused_cost_jit(j32(cols), j32(ys),
                                                         1e-3))
    line, arc = ci.fused_cost_plain(t32(cols), t32(ys), 1e-3)
    np.testing.assert_allclose(line.numpy(), fl, rtol=1e-4)
    np.testing.assert_allclose(arc.numpy(), fa, rtol=1e-5)


@pytest.mark.parametrize("E,M,S,even", [
    (96, 64, 256, "simpson"),   # K1 path (even E, S >= 128)
    (96, 64, 100, "simpson"),   # S < 128: K2 + plain Simpson
    (95, 64, 256, "simpson"),   # odd E: K2 + Cartwright tail
    (95, 64, 256, "avg"),       # odd E, historical even='avg'
    (96, 64, 1, "simpson"),     # the final cost's single curve
])
def test_curve_costs_match_reference(E, M, S, even):
    """The port's curve costs on the CPU against the reference's (its
    unfused path on the CPU). Same formulas, f32 sums in other orders: the
    costs agree to 2e-6 relative."""
    cols = np.random.default_rng(3).random((E, M)).astype(np.float32)
    ys = _curves(E, M, S)
    x_grid = np.arange(10, 10 + E)
    grad_img = np.zeros((M, 10 + E), np.float32)
    grad_img[:, 10:] = cols.T
    ref = np.asarray(ref_scoring.curve_costs(
        j32(grad_img), jnp.asarray(x_grid, jnp.int32), j32(ys),
        kde_thresh=1e-3, cols=j32(cols), even=even))
    got = curve_costs(t32(cols), t32(ys), kde_thresh=1e-3, even=even)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-6)


def test_fused_cost_gate():
    """The K1 gate is the reference's without its backend test."""
    assert ci.fused_cost_eligible(500, 500, 1000)
    assert not ci.fused_cost_eligible(500, 500, 1)        # final cost
    assert not ci.fused_cost_eligible(499, 500, 1000)     # odd E
    assert not ci.fused_cost_eligible(14, 500, 1000)      # E < 16
    assert not ci.fused_cost_eligible(500, 15, 1000)      # M < 4·H
    for M in (16, 17, 128, 129, 500, 1000, 4097):
        H = pi._H_for(M)
        assert ci.fused_cost_eligible(64, M, 128) == (M >= 4 * H)


# --- K2 ----------------------------------------------------------------------

@pytest.mark.parametrize("E,M,S", [(24, 72, 96), (16, 600, 64), (8, 33, 1)])
def test_column_interp_plain_matches_pallas_kernels(E, M, S):
    """K2's plain version against the reference's gather formulation and
    both Pallas forms, within the reference's own bounds
    (test_ops_numerics.py:230-231): XLA contracts the lerp's multiply-add
    into an FMA on the CPU, PyTorch rounds each op, so they differ by an
    ulp."""
    cols, ys = (_cols_ys(E, M, S) if S >= 16 else
                (np.random.default_rng(1).random((E, M)).astype(np.float32),
                 np.random.default_rng(2).uniform(-3, M + 3, (E, S))
                 .astype(np.float32)))
    got = ci.column_interp_plain(t32(cols), t32(ys), 1e-3).numpy()
    for ref_fn in (pi._column_interp_gather, pi._column_interp_pallas_2l,
                   pi._column_interp_pallas):
        ref = np.asarray(ref_fn(j32(cols), j32(ys), add_const=1e-3))
        np.testing.assert_allclose(got, ref, rtol=2e-6, atol=2e-7)


def test_column_interp_dispatches_plain_on_cpu():
    cols, ys = _cols_ys(8, 40, 32)
    n0 = ci.LAUNCHES["column_interp"]
    out = ci.column_interp(t32(cols), t32(ys), 0.5)
    assert ci.LAUNCHES["column_interp"] == n0        # no kernel on the CPU
    np.testing.assert_array_equal(
        out.numpy(), ci.column_interp_plain(t32(cols), t32(ys), 0.5).numpy())


def test_cuda_wrappers_refuse_cpu_tensors():
    """A wrapper's kernel arm takes CUDA tensors only: no silent fallback."""
    cols, ys = _cols_ys(8, 40, 32)
    with pytest.raises(ValueError, match="not cuda"):
        ci.column_interp_cuda(t32(cols), t32(ys))
    with pytest.raises(ValueError, match="not cuda"):
        ci.fused_cost_cuda(t32(cols), t32(ys))
    K = torch.tensor(_spd(2, 5))
    with pytest.raises(ValueError, match="not cuda"):
        cc.cholesky_cuda(K)
    with pytest.raises(ValueError, match="not cuda"):
        cc.solve_cuda(K, K, False)


# --- K5 / K6 -----------------------------------------------------------------

@pytest.mark.parametrize("n", [17, 24])
def test_cholesky_plain_matches_pallas(n):
    """K5's plain version (``cholesky_ex``) against the Pallas kernel:
    both f32, other summation orders, 2e-5 relative to max |L|."""
    K = _spd(3, n)
    ref = np.asarray(pc.batched_cholesky(j32(K)))
    got = cc.batched_cholesky(torch.tensor(K)).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5 * np.abs(ref).max())
    assert np.all(np.triu(got, 1) == 0)


def test_cholesky_non_pd_gives_nan():
    """A non-PD matrix gives NaN, not an error, as on the TPU."""
    K = _spd(3, 12)
    K[1] = -K[1]
    ref = np.asarray(pc.batched_cholesky(j32(K)))
    got = cc.batched_cholesky(torch.tensor(K)).numpy()
    assert np.isnan(ref[1]).any() and np.isnan(got[1]).all()
    assert np.isfinite(got[[0, 2]]).all()
    np.testing.assert_allclose(got[[0, 2]], ref[[0, 2]], atol=2e-5 * 4)


@pytest.mark.parametrize("m", [1, 17])
@pytest.mark.parametrize("backward", [False, True])
def test_triangular_solves_plain_match_pallas(m, backward):
    """K6's plain version (``solve_triangular``) against the Pallas solve
    kernels, m = 1 and m = n (the identity right-hand side of K⁻¹)."""
    n = 17
    L = np.asarray(pc.batched_cholesky(j32(_spd(3, n))))
    R = (np.broadcast_to(np.eye(n, dtype=np.float32), (3, n, n)).copy()
         if m == n else
         np.random.default_rng(0).normal(size=(3, n, m)).astype(np.float32))
    if backward:
        ref = pc.batched_backward_solve(j32(L), j32(R))
        got = cc.batched_backward_solve(torch.tensor(L), torch.tensor(R))
    else:
        ref = pc.batched_forward_solve(j32(L), j32(R))
        got = cc.batched_forward_solve(torch.tensor(L), torch.tensor(R))
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref,
                               atol=2e-5 * np.abs(ref).max())


def test_blocked_variants_match_pallas(monkeypatch):
    """The blocked orchestration (n > _DIRECT_N): panels through the
    kernels, trailing updates as matmuls. Both packages' gates are lowered
    so a small n runs three panels."""
    monkeypatch.setattr(pc, "_DIRECT_N", 20)
    monkeypatch.setattr(pc, "_PANEL", 16)
    monkeypatch.setattr(cc, "_DIRECT_N", 20)
    monkeypatch.setattr(cc, "_PANEL", 16)
    n, B, m = 40, 2, 5
    K = _spd(B, n)
    R = np.random.default_rng(4).normal(size=(B, n, m)).astype(np.float32)
    Lr = np.asarray(pc.cholesky_auto(j32(K)))
    L = cc.cholesky_auto(torch.tensor(K))
    np.testing.assert_allclose(L.numpy(), Lr, atol=2e-5 * np.abs(Lr).max())
    for ref_fn, fn in ((pc.forward_solve_auto, cc.forward_solve_auto),
                       (pc.backward_solve_auto, cc.backward_solve_auto)):
        ref = np.asarray(ref_fn(j32(Lr), j32(R)))
        got = fn(torch.tensor(Lr), torch.tensor(R)).numpy()
        np.testing.assert_allclose(got, ref, atol=2e-5 * np.abs(ref).max())


def test_leading_axes_flatten_into_batch():
    K = _spd(6, 9).reshape(2, 3, 9, 9)
    L = cc.batched_cholesky(torch.tensor(K))
    assert L.shape == (2, 3, 9, 9)
    flat = cc.batched_cholesky(torch.tensor(K.reshape(6, 9, 9)))
    np.testing.assert_array_equal(L.reshape(6, 9, 9).numpy(), flat.numpy())
