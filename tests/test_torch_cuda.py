"""PyTorch port on the card: each hand-written kernel (K1, K2, K5, K6)
against its plain PyTorch version on CUDA tensors, and the small slice
traced on the card. Every test here carries the ``cuda`` marker and skips
where ``torch.cuda.is_available()`` is false.

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import gaussian_process_edge_trace_torch as gpt
from gaussian_process_edge_trace_torch.ops import cuda_chol as cc
from gaussian_process_edge_trace_torch.ops import cuda_interp as ci

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)


@pytest.fixture
def dev():
    """The first CUDA device; decided inside the fixture, never at import
    or collection."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda", 0)


def _curves(E, M, S, seed=5):
    rng = np.random.default_rng(seed)
    y = M / 2 + np.cumsum(rng.normal(0, 1.5, (E, S)), axis=0)
    y[:, :2] = rng.uniform(-3 - M, -1, (E, 2))     # beyond both clamp edges
    y[:, 2:4] = rng.uniform(M, 2 * M, (E, 2))
    return y.astype(np.float32)


def _spd(B, n, seed=7):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, n, n))
    return (A @ np.transpose(A, (0, 2, 1)) / n + np.eye(n)).astype(np.float32)


@pytest.mark.parametrize("E,M,S", [(500, 500, 1000), (38, 61, 130)])
def test_fused_cost_kernel_matches_plain(dev, E, M, S):
    """K1: f32 sums in other orders; the reference test's bounds."""
    cols = torch.tensor(np.random.default_rng(0).random((E, M)),
                        dtype=torch.float32, device=dev)
    ys = torch.tensor(_curves(E, M, S), device=dev)
    n0 = ci.LAUNCHES["fused_cost"]
    line, arc = ci.fused_curve_cost(cols, ys, 1e-3)
    assert ci.LAUNCHES["fused_cost"] == n0 + 1
    pline, parc = ci.fused_cost_plain(cols, ys, 1e-3)
    torch.testing.assert_close(line, pline, rtol=1e-4, atol=0)
    torch.testing.assert_close(arc, parc, rtol=1e-5, atol=0)


@pytest.mark.parametrize("S", [1, 1000])
def test_column_interp_kernel_matches_plain(dev, S):
    """K2: each op rounded once on both sides; one ulp allowed."""
    rng = np.random.default_rng(1)
    cols = torch.tensor(rng.random((500, 500)), dtype=torch.float32,
                        device=dev)
    ys = torch.tensor(rng.uniform(-20, 520, (500, S)), dtype=torch.float32,
                      device=dev)
    out = ci.column_interp(cols, ys, 1e-3)
    torch.testing.assert_close(out, ci.column_interp_plain(cols, ys, 1e-3),
                               rtol=1.2e-7, atol=0)


def test_cholesky_and_solve_kernels_match_plain(dev):
    """K5 and K6 at the final fit's shapes; a non-PD matrix gives NaN."""
    K = _spd(109, 104)
    K[3] = -K[3]
    Kt = torch.tensor(K, device=dev)
    L = cc.batched_cholesky(Kt)
    Lp = cc.cholesky_plain(Kt)
    assert torch.isnan(torch.diagonal(L[3])).any()
    keep = [i for i in range(109) if i != 3]
    Lk = Lp[keep].contiguous()
    torch.testing.assert_close(L[keep], Lk, rtol=0,
                               atol=2e-5 * Lk.abs().max().item())
    for m in (1, 104):
        R = torch.randn(108, 104, m, device=dev)
        for transpose in (False, True):
            Z = cc.solve_cuda(Lk, R, transpose)
            Zp = cc.solve_plain(Lk, R, transpose)
            torch.testing.assert_close(Z, Zp, rtol=0,
                                       atol=2e-5 * Zp.abs().max().item())


def test_blocked_kernels_match_plain(dev):
    """n = 200 runs the blocked orchestration over the panel kernels."""
    K = torch.tensor(_spd(4, 200), device=dev)
    Lp = cc.cholesky_plain(K)
    torch.testing.assert_close(cc.cholesky_auto(K), Lp, rtol=0,
                               atol=2e-5 * Lp.abs().max().item())
    R = torch.randn(4, 200, 3, device=dev)
    for fn, transpose in ((cc.forward_solve_auto, False),
                          (cc.backward_solve_auto, True)):
        Zp = cc.solve_plain(Lp, R, transpose)
        torch.testing.assert_close(fn(Lp, R), Zp, rtol=0,
                                   atol=2e-5 * Zp.abs().max().item())


def test_small_trace_on_the_card(dev):
    """The slice on the card: every kernel of the path launches, the trace
    is accurate and a rerun is bitwise identical."""
    img, edge = gpt.construct_test_img((64, 96), 40, 2, 0.03, "sinusoidal",
                                       0.3)
    grad = gpt.comp_grad_img(img, gpt.kernel_builder((9, 5)), device=dev)
    init = np.array([[0, edge[0, 0]], [95, edge[95, 0]]])
    for counts in (ci.LAUNCHES, cc.LAUNCHES):
        for k in counts:
            counts[k] = 0
    args = (init, grad, {"kernel": "RBF", "sigma_f": 20, "length_scale": 8},
            1, np.array([]), 256, 1, 6, 0.1, 4, 1, False, True)
    out = gpt.GP_Edge_Tracing(*args, device=dev)()
    assert all(n > 0 for n in ci.LAUNCHES.values())
    assert all(n > 0 for n in cc.LAUNCHES.values())
    assert gpt.trace_dicecoef(out, edge) > 0.97
    np.testing.assert_array_equal(out,
                                  gpt.GP_Edge_Tracing(*args, device=dev)())
