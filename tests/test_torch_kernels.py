"""PyTorch port, kernels K1 (with its transposed-samples output), K2, K5 and
K6: each kernel's plain PyTorch
version against the JAX package's Pallas function, run in interpret mode on
the CPU as ``test_ops_numerics.py`` runs it, and the launch plans the
wrappers hand the kernels. The kernels themselves are held against their
plain versions on a GPU by ``test_torch_cuda.py``."""

import jax.numpy as jnp
import numpy as np
from jax.scipy.linalg import solve_triangular as jsolve_triangular
import pytest
import torch

from gaussian_process_edge_trace_torch.ops import cuda_chol as cc
from gaussian_process_edge_trace_torch.ops import cuda_interp as ci
from gaussian_process_edge_trace_torch.trace.scoring import (
    best_curves, curve_costs)
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


def test_fused_cost_transpose_matches_pallas_kernel():
    """K1's transposed-samples output (the ``with_transpose`` arm, which
    the reference itself does not test): E not a multiple of 8 and S >= 8192
    not a multiple of the sample block. The reference pads the copy's
    columns to E_pad; its first E columns must equal ``ys.T`` bit for bit,
    and so must the port's (S, E) copy. The quadratures keep the bounds of
    the test above."""
    E, M, S = 38, 64, 8197
    cols = np.random.default_rng(2).random((E, M)).astype(np.float32)
    ys = _curves(E, M, S)
    fl, fa, fyt = (np.asarray(a) for a in pi._fused_cost_jit(
        j32(cols), j32(ys), 1e-3, with_transpose=True))
    line, arc, samples_t = ci.fused_cost_plain(t32(cols), t32(ys), 1e-3,
                                               with_transpose=True)
    assert samples_t.shape == (S, E) and samples_t.is_contiguous()
    np.testing.assert_array_equal(fyt[:, :E], ys.T)
    np.testing.assert_array_equal(samples_t.numpy(), fyt[:, :E])
    np.testing.assert_allclose(line.numpy(), fl, rtol=1e-4)
    np.testing.assert_allclose(arc.numpy(), fa, rtol=1e-5)


@pytest.mark.parametrize("S,want", [(8191, True), (8192, False),
                                    (8192, True)])
def test_fused_curve_cost_transpose_gate(S, want):
    """``fused_curve_cost`` returns the transposed copy only when asked and
    S >= 8192 (pallas_interp.py:427,450), from the plain version on the CPU,
    and the quadratures do not depend on it."""
    E, M = 16, 20
    cols, ys = t32(np.random.default_rng(0).random((E, M))), t32(
        _curves(E, M, S))
    n0 = dict(ci.LAUNCHES)
    line, arc, samples_t = ci.fused_curve_cost(cols, ys, 1e-3,
                                               want_transpose=want)
    assert ci.LAUNCHES == n0
    if want and S >= ci._TRANSPOSE_MIN_S:
        np.testing.assert_array_equal(samples_t.numpy(), ys.numpy().T)
    else:
        assert samples_t is None
    pline, parc = ci.fused_cost_plain(cols, ys, 1e-3)
    np.testing.assert_array_equal(line.numpy(), pline.numpy())
    np.testing.assert_array_equal(arc.numpy(), parc.numpy())


def test_best_curves_row_take_equals_column_take():
    """``best_curves`` from the transposed copy gives bitwise the curves of
    the column take (scoring.py:132-138 of the reference), contiguous, and
    the costs with and without the copy are equal."""
    E, M, S = 40, 30, 8200
    cols = t32(np.random.default_rng(1).random((E, M)))
    ys = t32(_curves(E, M, S))
    costs, samples_t = curve_costs(cols, ys, 1e-3, return_samples_t=True)
    assert samples_t.shape == (S, E)
    np.testing.assert_array_equal(costs.numpy(),
                                  curve_costs(cols, ys, 1e-3).numpy())
    rows, rc = best_curves(ys, costs, 820, samples_t=samples_t)
    cols_take, cc = best_curves(ys, costs, 820)
    assert rows.is_contiguous() and rows.shape == (E, 820)
    np.testing.assert_array_equal(rows.numpy(), cols_take.numpy())
    np.testing.assert_array_equal(rc.numpy(), cc.numpy())
    _, none = curve_costs(cols, ys[:, :100].contiguous(), 1e-3,
                          return_samples_t=True)
    assert none is None


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


@pytest.mark.parametrize("E,M,S,transpose", [
    (500, 500, 1000, False),      # the demo
    (1000, 1000, 10000, True),    # 1000², with the copy
    (1000, 1000, 10000, False),
    (2000, 2000, 8200, True),     # M = 2000
    (600, 100, 8200, True),       # whole steps, a shorter last chunk
    (38, 61, 130, False),         # ragged
    (38, 61, 8197, True),
    (4, 2, 1, False),             # the smallest launch
])
def test_k1_launch_plan_covers_windows_and_rows_once(E, M, S, transpose):
    """K1's plan: every pair window of (E-2)/2 lies in exactly one chunk,
    every row of ``samples_t`` is written by exactly one chunk, no chunk is
    empty or longer than the kernel takes, chunks start on 8-row (32-byte)
    boundaries of ``samples_t``, every sample lies in one block of whole
    thread tiles, one block's shared memory fits the card's 232,448 bytes,
    and the chunks are the same with and without the copy (so are the
    sums)."""
    plan = ci.k1_launch_plan(E, M, S, transpose)
    P = (E - 2) // 2
    windows = np.zeros(P, int)
    rows = np.zeros(E, int)
    for c in range(plan["n_chunks"]):
        # The kernel's chunk c: its pair windows [j0, j1) and the rows of
        # samples_t it writes, those its windows begin (the last chunk also
        # rows E-2 and E-1).
        j0 = c * plan["pairs_per_chunk"]
        j1 = min(P, j0 + plan["pairs_per_chunk"])
        assert j0 < j1 and j0 % 4 == 0
        windows[j0:j1] += 1
        rows[2 * j0:E if j1 == P else 2 * j1] += 1
    assert (windows == 1).all() and (rows == 1).all()
    assert plan["pairs_per_chunk"] <= ci._K1_PAIRS
    assert plan["smem_bytes"] <= cc.SMEM_LIMIT
    spb = plan["samples_per_block"]
    assert spb == plan["threads"] * plan["samples_per_thread"]
    assert (plan["sample_groups"] - 1) * spb < S <= plan["sample_groups"] * spb
    assert plan["blocks"] == plan["sample_groups"] * plan["n_chunks"]
    other = ci.k1_launch_plan(E, M, S, not transpose)
    keys = ("pairs_per_chunk", "n_chunks", "samples_per_block")
    assert [other[k] for k in keys] == [plan[k] for k in keys]
    assert (other["smem_bytes"] < plan["smem_bytes"]) == transpose


def test_k1_launch_plan_sizes():
    """One wave of two blocks per SM: 63 chunks of 8 pairs × 4 groups of
    2560 samples at the 1000² shape, 63 chunks of 4 pairs × 4 groups of
    256 at the demo's S = 1000; odd or short E has no launch; columns too
    tall for two blocks per SM take one, and taller ones none."""
    big = ci.k1_launch_plan(1000, 1000, 10000, True)
    assert (big["pairs_per_chunk"], big["n_chunks"], big["sample_groups"],
            big["samples_per_block"]) == (8, 63, 4, 2560)
    demo = ci.k1_launch_plan(500, 500, 1000)
    assert (demo["pairs_per_chunk"], demo["n_chunks"],
            demo["sample_groups"]) == (4, 63, 4)
    for E in (3, 2, 499):
        with pytest.raises(ValueError, match="even E"):
            ci.k1_launch_plan(E, 10, 100)
    tall = ci.k1_launch_plan(100, 10000, 1000, True)   # one block per SM
    assert tall["pairs_per_chunk"] == 2
    assert cc.SMEM_LIMIT // 2 < tall["smem_bytes"] <= cc.SMEM_LIMIT
    with pytest.raises(ValueError, match="do not fit"):
        ci.k1_launch_plan(100, 20000, 1000)


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


@pytest.mark.parametrize("E,M,S", [
    (999, 1000, 10000),   # the odd-E trace's unfused cost: one tile a row
    (499, 500, 1000),     # the odd demo shape
    (37, 61, 10003),      # few rows: rows split into tiles, ragged S
    (95, 64, 256),        # the small odd-E test trace
    (1000, 1000, 1),      # the final cost: flat
    (500, 500, 3),        # few samples: flat
    (100, 1000, 400),     # samples do not outweigh the column: flat
])
def test_k2_launch_plan_covers_every_sample_once(E, M, S):
    """K2's plan: in the tiled layout every (e, s) lies in exactly one
    block's span, tiles start on 4-sample boundaries, no tile is empty and
    the staged column fits shared memory; in the flat layout the threads
    cover the E·S elements with less than one block left over. The layout
    follows the sample count: flat for a few samples per column, tiled
    where they outweigh the column."""
    plan = ci.k2_launch_plan(E, M, S)
    tiled = S >= 64 and 2 * S >= M
    assert plan["layout"] == ("tiled" if tiled else "flat")
    if tiled:
        covered = np.zeros(S, int)
        for t in range(plan["tiles"]):
            s0 = t * plan["span"]
            assert s0 < S and s0 % 4 == 0
            covered[s0:s0 + plan["span"]] += 1
        assert (covered == 1).all()         # the same for every row e
        assert plan["blocks"] == E * plan["tiles"]
        assert plan["smem_bytes"] == 4 * M <= cc.SMEM_LIMIT
        assert plan["tiles"] == 1 or plan["span"] >= ci._K2_MIN_SPAN
    else:
        n = plan["blocks"] * plan["threads"]
        assert E * S <= n < E * S + plan["threads"]
        assert plan["smem_bytes"] == 0


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
    with pytest.raises(ValueError, match="not cuda"):
        ci.fused_cost_cuda(t32(cols), t32(ys), with_transpose=True)
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


@pytest.mark.parametrize("m", [None, 1, 33, "n"])
def test_launch_plan_fits_shared_memory(m):
    """The direct kernels' layout (``launch_plan``, which mirrors the
    launchers) fits one block's 232,448 bytes of shared memory for every
    n <= ``_DIRECT_N``, for K5 (m None) and K6 at widths 1, 33 and n;
    ``_DIRECT_N`` is the largest such n, so n = 208 (the 1000² config's
    n_train) runs direct and n = 408 (the 2000² config's) blocked."""
    def plan(n):
        return cc.launch_plan(n, n if m == "n" else m)
    for n in range(1, cc._DIRECT_N + 1):
        p = plan(n)
        assert p["direct"] and p["smem_bytes"] <= cc.SMEM_LIMIT, (n, p)
        assert p["threads"] == cc.THREADS
    assert plan(208)["direct"] and not plan(408)["direct"]
    over = [cc.launch_plan(cc._DIRECT_N + 1, w)["smem_bytes"]
            for w in (None, 1, 2)]
    assert max(over) > cc.SMEM_LIMIT
    assert plan(cc._DIRECT_N)["chunk"] == {None: None, 1: 1}.get(m, cc.CHUNK)


@pytest.mark.parametrize("op,m", [("cholesky", None), ("forward", 1),
                                  ("forward", 208), ("backward", 1)])
def test_auto_at_208_matches_jax(op, m):
    """At n = 208 the ``*_auto`` functions agree with JAX's ``cholesky`` /
    ``solve_triangular`` on the same float32 inputs within 2e-5 of max |·|
    (f32 sums in other orders on a well-conditioned batch). On the card
    n = 208 runs the direct kernels; on the CPU it stays on the blocked
    form over the plain versions (``runs_direct``)."""
    assert cc.runs_direct(208, "cuda") and not cc.runs_direct(208, "cpu")
    assert cc.runs_direct(160, "cpu") and not cc.runs_direct(408, "cuda")
    n = 208
    K = _spd(2, n)
    if op == "cholesky":
        ref = np.asarray(jnp.linalg.cholesky(j32(K)))
        got = cc.cholesky_auto(torch.tensor(K)).numpy()
    else:
        L = np.asarray(jnp.linalg.cholesky(j32(K)))
        R = (np.broadcast_to(np.eye(n, dtype=np.float32), (2, n, n)).copy()
             if m == n else
             np.random.default_rng(8).normal(size=(2, n, m)).astype(
                 np.float32))
        trans = "T" if op == "backward" else 0
        ref = np.asarray(jsolve_triangular(j32(L), j32(R), lower=True,
                                           trans=trans))
        fn = cc.backward_solve_auto if trans else cc.forward_solve_auto
        got = fn(torch.tensor(L), torch.tensor(R)).numpy()
    assert ref.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=2e-5 * np.abs(ref).max())


def test_leading_axes_flatten_into_batch():
    K = _spd(6, 9).reshape(2, 3, 9, 9)
    L = cc.batched_cholesky(torch.tensor(K))
    assert L.shape == (2, 3, 9, 9)
    flat = cc.batched_cholesky(torch.tensor(K.reshape(6, 9, 9)))
    np.testing.assert_array_equal(L.reshape(6, 9, 9).numpy(), flat.numpy())
