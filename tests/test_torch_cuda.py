"""PyTorch port on the card: each hand-written kernel (K1 with its
transposed-samples output, K2, K3, K4, K5, K6) against its plain PyTorch
version on CUDA tensors, K1-K4 over several frames in one launch
against single-frame launches, the launch plans against the launchers, the
curve costs over sample shards against the full launch's columns, and the
small slice traced on the card, at an even and at an odd edge length, as a
batch of two frames and through a (1, 1) NCCL mesh; the self-test, the CLI's
``trace`` against the API and each denoiser against the port's CPU path.
Every test here carries the ``cuda`` marker and skips where
``torch.cuda.is_available()`` is false.

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
from gaussian_process_edge_trace_torch.trace import cuda_kde as ck

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


def _bits_equal(a, b):
    """Bitwise equality that holds NaN equal to the same NaN."""
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


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
    line, arc, samples_t = ci.fused_curve_cost(cols, ys, 1e-3)
    assert ci.LAUNCHES["fused_cost"] == n0 + 1 and samples_t is None
    pline, parc = ci.fused_cost_plain(cols, ys, 1e-3)
    torch.testing.assert_close(line, pline, rtol=1e-4, atol=0)
    torch.testing.assert_close(arc, parc, rtol=1e-5, atol=0)


def test_fused_cost_transposed_copy(dev):
    """K1's transposed copy equals ys.T bit for bit at a ragged E and an S
    that is no multiple of the block; the quadratures do not change."""
    E, M, S = 38, 61, 8197
    cols = torch.tensor(np.random.default_rng(0).random((E, M)),
                        dtype=torch.float32, device=dev)
    ys = torch.tensor(_curves(E, M, S), device=dev)
    line, arc, samples_t = ci.fused_curve_cost(cols, ys, 1e-3,
                                               want_transpose=True)
    assert samples_t.shape == (S, E)
    assert torch.equal(samples_t, ys.T.contiguous())
    line0, arc0, none = ci.fused_curve_cost(cols, ys, 1e-3)
    assert none is None
    assert torch.equal(line, line0) and torch.equal(arc, arc0)


@pytest.mark.parametrize("E,M,S", [
    (1000, 1000, 10000),   # 16 chunks of 32 pairs: two whole steps each
    (600, 100, 8200),      # 19 chunks of 16 pairs, the last of 11
    (2000, 2000, 8200),    # M = 2000
    (500, 500, 1),         # S = 1
    (38, 61, 8197),        # S no multiple of the 128 samples of a block
])
def test_fused_cost_kernel_at_chunk_boundaries(dev, E, M, S):
    """K1 at the new plan's chunk boundaries, partial steps and ragged S:
    within the reference test's bounds of the plain version; the
    transposed copy equals ys.T; line and arc are bitwise the same with and
    without the copy and on a rerun."""
    cols = torch.tensor(np.random.default_rng(2).random((E, M)),
                        dtype=torch.float32, device=dev)
    ys = torch.tensor(_curves(E, M, S) if S >= 4 else np.random.default_rng(
        3).uniform(-3, M + 3, (E, S)), dtype=torch.float32, device=dev)
    line, arc, samples_t = ci.fused_cost_cuda(cols, ys, 1e-3,
                                              with_transpose=True)
    pline, parc = ci.fused_cost_plain(cols, ys, 1e-3)
    torch.testing.assert_close(line, pline, rtol=1e-4, atol=0)
    torch.testing.assert_close(arc, parc, rtol=1e-5, atol=0)
    assert torch.equal(samples_t, ys.T.contiguous())
    for _ in range(2):
        line0, arc0 = ci.fused_cost_cuda(cols, ys, 1e-3)
        assert torch.equal(line0, line) and torch.equal(arc0, arc)


def _kept(dev, E, S, M, seed=3):
    """Kept curves with exact integers, both image edges and rows just
    outside it; normalised inverse-cost weights."""
    rng = np.random.default_rng(seed)
    y = M / 2 + np.cumsum(rng.normal(0, 1.5, (E, S)), axis=0)
    y[:, :4] = [0.0, M - 1.0, M // 3, -1.0]
    y[::3, 4] = float(M)
    w = 1.0 / rng.uniform(0.5, 2.0, S)
    return (torch.tensor(y, dtype=torch.float32, device=dev),
            torch.tensor(w / w.sum(), dtype=torch.float32, device=dev))


@pytest.mark.parametrize("E,S,M", [(1000, 1000, 1000), (500, 100, 500),
                                   (37, 33, 129)])
def test_binning_kernels_match_plain(dev, E, S, M):
    """K3 and K4 against the dense plain version: the same taps summed in
    other orders; the reference test's bounds (rtol 1e-5, atol
    1e-6·max|H|). K4 adds each row's terms in sample order, so it equals
    the sequential plain version bit for bit. Reruns are bitwise equal."""
    y, w = _kept(dev, E, S, M)
    ref = ck.column_binning_plain(y, w, M)
    atol = 1e-6 * ref.abs().max().item()
    n0 = dict(ck.LAUNCHES)
    H3 = ck.column_binning(y, w, M)
    H4 = ck.column_binning(y, w, M, use_pallas=True)
    assert ck.LAUNCHES["binning_2l"] == n0["binning_2l"] + 1
    assert ck.LAUNCHES["binning_dense"] == n0["binning_dense"] + 1
    for H in (H3, H4):
        torch.testing.assert_close(H, ref, rtol=1e-5, atol=atol)
    assert torch.equal(H4, ck.column_binning_sequential(y, w, M))
    assert torch.equal(H3, ck.binning_2l_cuda(y, w, M))
    assert torch.equal(H4, ck.binning_dense_cuda(y, w, M))


@pytest.mark.parametrize("case", ["one row", "outside", "S=1", "S=0",
                                  "ragged", "several tiles"])
def test_binning_dense_worst_cases(dev, case):
    """K4 where its groups are largest or empty: every sample in one row
    (32 lanes in one group, two rows add all S terms), every sample outside
    the image (no term at all), one kept curve, none, a block whose last
    columns lie past E with S no multiple of 32, and more samples than one
    tile holds (the rows' sums carry over from tile to tile). Bitwise equal
    to the sequential plain version and to a rerun; within the reference
    test's bounds of the dense one."""
    E, S, M = 300, 1000, 400
    rng = np.random.default_rng(11)
    if case == "one row":
        y = np.full((E, S), M / 2 + 0.25)
    elif case == "outside":
        y = np.where(rng.random((E, S)) < 0.5, rng.uniform(-40, -1e-3, (E, S)),
                     rng.uniform(M - 1 + 1e-3, M + 40, (E, S)))
    elif case in ("S=1", "S=0"):
        S = int(case[2])
        y = rng.uniform(-3, M + 2, (E, S))
    else:
        E, M = 21, 100
        S = 1001 if case == "ragged" else 2 * ck._K4_TILE + 77
        y = M / 2 + np.cumsum(rng.normal(0, 1.5, (E, S)), axis=0)
    assert ck.k4_launch_plan(E, S, M)["tiles"] == (
        3 if case == "several tiles" else 1 if S else 0)
    w = rng.uniform(0.5, 2.0, S)
    y = torch.tensor(y, dtype=torch.float32, device=dev)
    w = torch.tensor(w / max(w.sum(), 1.0), dtype=torch.float32, device=dev)
    H = ck.binning_dense_cuda(y, w, M)
    assert torch.equal(H, ck.column_binning_sequential(y, w, M))
    assert torch.equal(H, ck.binning_dense_cuda(y, w, M))
    ref = ck.column_binning_plain(y, w, M)
    torch.testing.assert_close(H, ref, rtol=1e-5,
                               atol=1e-6 * ref.abs().max().item())
    if case in ("outside", "S=0"):
        assert not H.any()


@pytest.mark.parametrize("case", ["one row", "one integer row", "outside",
                                  "S=1", "edges"])
def test_binning_2l_worst_cases(dev, case):
    """K3 where its groups are largest or empty: every sample in one row
    (32 lanes in one group), on one exact integer row (the f = 0 tap),
    every sample outside the image (weight 0, taps at rows 0 and M+1),
    one kept curve, and rows at and just beyond both edges. Within the
    reference test's bounds of the plain version; a rerun is bitwise."""
    E, S, M = 300, 1000, 400
    rng = np.random.default_rng(9)
    if case == "one row":
        y = np.full((E, S), M / 2 + 0.25)
    elif case == "one integer row":
        y = np.full((E, S), M - 1.0)
    elif case == "outside":
        y = np.where(rng.random((E, S)) < 0.5, rng.uniform(-40, -1e-3, (E, S)),
                     rng.uniform(M - 1 + 1e-3, M + 40, (E, S)))
        y[:, 0], y[:, 1] = -1.0, float(M)
    elif case == "S=1":
        S = 1
        y = rng.uniform(-3, M + 2, (E, S))
    else:
        y = rng.choice([-1.0, -1e-3, 0.0, 1e-3, M - 1.0, M - 1 + 1e-3,
                        float(M), 0.5, M - 1.5], (E, S))
    w = rng.uniform(0.5, 2.0, S)
    y = torch.tensor(y, dtype=torch.float32, device=dev)
    w = torch.tensor(w / w.sum(), dtype=torch.float32, device=dev)
    H = ck.binning_2l_cuda(y, w, M)
    ref = ck.column_binning_plain(y, w, M)
    torch.testing.assert_close(H, ref, rtol=1e-5,
                               atol=1e-6 * ref.abs().max().item())
    if case == "outside":
        assert not H.any()
    assert torch.equal(H, ck.binning_2l_cuda(y, w, M))


def test_k1_k3_plans_match_launchers(dev):
    """The plans' shared-memory bytes are the launchers' own."""
    from gaussian_process_edge_trace_torch.ops import cuda_build
    lib = cuda_build.library()
    for E, M, S in ((1000, 1000, 10000), (500, 500, 1000), (38, 61, 130)):
        for transpose in (False, True):
            plan = ci.k1_launch_plan(E, M, S, transpose)
            assert lib.gpet_fused_cost_smem(
                M, plan["pairs_per_chunk"], plan["threads"], transpose) == \
                plan["smem_bytes"]
    for E, S, M in ((1000, 1000, 1000), (500, 100, 500), (37, 33, 129),
                    (100, 1000, 20000), (1, 1, 1)):
        plan = ck.k3_launch_plan(E, S, M)
        assert lib.gpet_binning_2l_smem(M, plan["cols"],
                                        plan["warps_per_col"]) == \
            plan["smem_bytes"]


@pytest.mark.parametrize("S", [1, 3, 1000, 10003])
def test_column_interp_kernel_matches_plain(dev, S):
    """K2: each op rounded once on both sides, so bitwise equal to the
    plain version, with and without add_const; an odd E, so at S = 10003
    most rows start off a 16-byte boundary (the scalar head and tail), and
    samples taken from a slice whose start is 4 bytes past one (no float4
    at all). A rerun is bitwise equal."""
    E, M = 499, 500
    rng = np.random.default_rng(S)
    cols = torch.tensor(rng.random((E, M)), dtype=torch.float32, device=dev)
    big = torch.tensor(rng.uniform(-20, M + 20, (E + 1, S)),
                       dtype=torch.float32, device=dev)
    for ys in (big[:E], big[1:]):
        for add in (1e-3, 0.0):
            n0 = ci.LAUNCHES["column_interp"]
            out = ci.column_interp(cols, ys, add)
            assert ci.LAUNCHES["column_interp"] == n0 + 1
            assert torch.equal(out, ci.column_interp_plain(cols, ys, add))
            assert torch.equal(out, ci.column_interp(cols, ys, add))


def test_k2_k4_plans_match_launchers(dev):
    """K2's and K4's plans: their shared-memory bytes are the launchers'
    own (K2 flat and tiled; K4 at 4 columns per block, fewer for tall
    columns, and in several tiles)."""
    from gaussian_process_edge_trace_torch.ops import cuda_build
    lib = cuda_build.library()
    for E, M, S in ((999, 1000, 10000), (499, 500, 1000), (1000, 1000, 1),
                    (37, 61, 10003), (95, 64, 256)):
        plan = ci.k2_launch_plan(E, M, S)
        assert lib.gpet_column_interp_smem(
            M, plan["layout"] == "tiled") == plan["smem_bytes"]
    for E, S, M in ((1000, 1000, 1000), (500, 100, 500), (37, 33, 129),
                    (20, 9000, 100), (3, 0, 5), (10, 100, 9000)):
        plan = ck.k4_launch_plan(E, S, M)
        assert lib.gpet_binning_dense_smem(M, plan["tile"],
                                           plan["cols"]) == \
            plan["smem_bytes"]


@pytest.mark.parametrize("n", [17, 97, 104, 161, 208, cc._DIRECT_N])
def test_cholesky_and_solve_kernels_match_plain(dev, n):
    """K5 and K6 against their plain versions within 2e-5 of max |·| (f32
    sums in other orders) at ragged n up to the direct limit. K5: a batch
    with leading axes (2, 3) that flatten into the batch and one non-PD
    matrix, which gives NaN on its diagonal and leaves the others finite.
    K6: m = 1, 33 and n, forward and backward. A rerun of each is bitwise
    equal."""
    K = _spd(6, n).reshape(2, 3, n, n)
    K[1, 0] = -K[1, 0]
    Kt = torch.tensor(K, device=dev)
    n0 = cc.LAUNCHES["cholesky"]
    L = cc.cholesky_auto(Kt)
    assert cc.LAUNCHES["cholesky"] == n0 + 1 and L.shape == K.shape
    assert _bits_equal(L, cc.batched_cholesky(Kt))     # NaN included
    assert torch.isnan(torch.diagonal(L[1, 0])).any()
    keep = torch.ones(2, 3, dtype=torch.bool, device=dev)
    keep[1, 0] = False
    Lp = cc.cholesky_plain(Kt)[keep]
    assert torch.isfinite(L[keep]).all()
    torch.testing.assert_close(L[keep], Lp, rtol=0,
                               atol=2e-5 * Lp.abs().max().item())
    assert (torch.triu(L[keep], 1) == 0).all()
    rng = np.random.default_rng(n)
    for m in (1, 33, n):
        R = torch.tensor(rng.normal(size=(5, n, m)), dtype=torch.float32,
                         device=dev)
        for transpose in (False, True):
            t0 = cc.LAUNCHES["trsm"]
            Z = cc.solve_cuda(Lp, R, transpose)
            assert cc.LAUNCHES["trsm"] == t0 + 1
            Zp = cc.solve_plain(Lp, R, transpose)
            torch.testing.assert_close(Z, Zp, rtol=0,
                                       atol=2e-5 * Zp.abs().max().item())
            assert torch.equal(Z, cc.solve_cuda(Lp, R, transpose))


def test_launch_plan_matches_launchers(dev):
    """``launch_plan``'s shared-memory bytes are the launchers' own for
    every n up to the direct limit, and a direct call beyond it raises."""
    from gaussian_process_edge_trace_torch.ops import cuda_build
    lib = cuda_build.library()
    for n in range(1, cc._DIRECT_N + 1):
        assert lib.gpet_batched_cholesky_smem(n) == \
            cc.launch_plan(n)["smem_bytes"]
        for m in (1, 2, n):
            assert lib.gpet_batched_trsm_smem(n, m) == \
                cc.launch_plan(n, m)["smem_bytes"]
    big = torch.eye(cc._DIRECT_N + 1, device=dev)[None]
    with pytest.raises(ValueError):
        cc.cholesky_cuda(big)
    with pytest.raises(ValueError):
        cc.solve_cuda(big, big, False)


def test_blocked_kernels_match_plain(dev):
    """n = 408 (the 2000² config's n_train) runs the blocked orchestration
    over the direct kernels."""
    K = torch.tensor(_spd(4, 408), device=dev)
    Lp = cc.cholesky_plain(K)
    torch.testing.assert_close(cc.cholesky_auto(K), Lp, rtol=0,
                               atol=2e-5 * Lp.abs().max().item())
    R = torch.randn(4, 408, 3, device=dev)
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
    for counts in (ci.LAUNCHES, cc.LAUNCHES, ck.LAUNCHES):
        for k in counts:
            counts[k] = 0
    args = (init, grad, {"kernel": "RBF", "sigma_f": 20, "length_scale": 8},
            1, np.array([]), 256, 1, 6, 0.1, 4, 1, False, True)
    out = gpt.GP_Edge_Tracing(*args, device=dev)()
    # S = 256 < 8192: K1 writes no transposed copy; K4 is off the path.
    assert ci.LAUNCHES["fused_cost"] > 0 and ci.LAUNCHES["column_interp"] > 0
    assert ci.LAUNCHES["fused_cost_transpose"] == 0
    assert ck.LAUNCHES["binning_2l"] > 0 and ck.LAUNCHES["binning_dense"] == 0
    assert all(n > 0 for n in cc.LAUNCHES.values())
    assert gpt.trace_dicecoef(out, edge) > 0.97
    np.testing.assert_array_equal(out,
                                  gpt.GP_Edge_Tracing(*args, device=dev)())


def test_small_odd_edge_trace_on_the_card(dev):
    """An odd edge length on the card (E = 95): K1 never runs, K2 scores
    every iteration and the final cost (n_iters + 1 launches), the trace is
    accurate and a rerun is bitwise identical."""
    img, edge = gpt.construct_test_img((64, 96), 40, 2, 0.03, "sinusoidal",
                                       0.3)
    grad = gpt.comp_grad_img(img, gpt.kernel_builder((9, 5)), device=dev)
    init = np.array([[0, edge[0, 0]], [94, edge[94, 0]]])
    for counts in (ci.LAUNCHES, cc.LAUNCHES, ck.LAUNCHES):
        for k in counts:
            counts[k] = 0
    args = (init, grad, {"kernel": "RBF", "sigma_f": 20, "length_scale": 8},
            1, np.array([]), 256, 1, 6, 0.1, 4, 1, False, True)
    tracer = gpt.GP_Edge_Tracing(*args, device=dev)
    out = tracer()
    assert out.shape == (95, 2)
    assert ci.LAUNCHES["fused_cost"] == 0
    assert ci.LAUNCHES["column_interp"] == tracer.last_result.n_iters + 1
    assert ck.LAUNCHES["binning_2l"] > 0 and ck.LAUNCHES["binning_dense"] == 0
    # The CPU path reads DICE 0.977 here; the card draws other normals.
    assert gpt.trace_dicecoef(out, edge[:95]) > 0.95
    np.testing.assert_array_equal(out,
                                  gpt.GP_Edge_Tracing(*args, device=dev)())


@pytest.mark.parametrize("E,M,S,transpose,shared", [
    (38, 61, 130, False, False), (38, 61, 8197, True, False),
    (500, 500, 1000, False, True), (100, 80, 8200, True, True)])
def test_fused_cost_frames_equal_single_launches(dev, E, M, S, transpose,
                                                  shared):
    """K1 over four frames in one launch (and one chunk sum), with columns
    of their own or one set shared by the frames: each frame's line, arc
    and transposed copy equal a single-frame launch of that frame bit for
    bit."""
    B = 4
    rng = np.random.default_rng(1)
    cols = torch.tensor(rng.random((E, M) if shared else (B, E, M)),
                        dtype=torch.float32, device=dev)
    ys = torch.tensor(np.stack([_curves(E, M, S, seed=f) for f in range(B)]),
                      device=dev)
    n0 = ci.LAUNCHES["fused_cost"]
    out = ci.fused_cost_cuda(cols, ys, 1e-3, with_transpose=transpose)
    assert ci.LAUNCHES["fused_cost"] == n0 + 1
    assert out[0].shape == (B, S)
    for f in range(B):
        one = ci.fused_cost_cuda(cols if shared else cols[f], ys[f], 1e-3,
                                 with_transpose=transpose)
        for a, b in zip(out, one):
            assert torch.equal(a[f], b)


@pytest.mark.parametrize("S", [1, 1000, 10003])
@pytest.mark.parametrize("shared", [False, True])
def test_column_interp_frames_equal_single_launches(dev, S, shared):
    """K2 over three frames in one launch, flat (S = 1) and tiled, with
    columns of their own or shared: bitwise equal to single-frame launches
    and to the plain version."""
    B, E, M = 3, 37, 61
    rng = np.random.default_rng(S)
    cols = torch.tensor(rng.random((E, M) if shared else (B, E, M)),
                        dtype=torch.float32, device=dev)
    ys = torch.tensor(rng.uniform(-20, M + 20, (B, E, S)),
                      dtype=torch.float32, device=dev)
    n0 = ci.LAUNCHES["column_interp"]
    out = ci.column_interp_cuda(cols, ys, 1e-3)
    assert ci.LAUNCHES["column_interp"] == n0 + 1
    assert torch.equal(out, ci.column_interp_plain(cols, ys, 1e-3))
    for f in range(B):
        assert torch.equal(out[f], ci.column_interp_cuda(
            cols if shared else cols[f], ys[f], 1e-3))


@pytest.mark.parametrize("E,S,M", [(37, 33, 129), (300, 1000, 400)])
def test_binning_2l_frames_equal_single_launches(dev, E, S, M):
    """K3 over three frames in one launch: each frame's (M+2, E) masses
    equal a single-frame launch bit for bit."""
    kept = [_kept(dev, E, S, M, seed=f) for f in range(3)]
    y = torch.stack([k[0] for k in kept])
    w = torch.stack([k[1] for k in kept])
    n0 = ck.LAUNCHES["binning_2l"]
    H = ck.binning_2l_cuda(y, w, M)
    assert ck.LAUNCHES["binning_2l"] == n0 + 1 and H.shape == (3, M + 2, E)
    for f in range(3):
        assert torch.equal(H[f], ck.binning_2l_cuda(y[f], w[f], M))


@pytest.mark.parametrize("E,S,M", [(37, 33, 129), (300, 1000, 400),
                                   (700, 200, 700)])
def test_binning_dense_frames_equal_single_launches(dev, E, S, M):
    """K4 over 16 frames in one launch: each frame's (M+2, E) masses equal
    its single-frame launch and the sequential plain version bit for bit,
    and ``curve_kde(..., use_pallas_binning=True)`` over the frames equals
    the per-frame calls (both axes past ``_BLUR_MATMUL_MAX``, where the blur
    is elementwise)."""
    from gaussian_process_edge_trace_torch.trace.kde import curve_kde
    kept = [_kept(dev, E, S, M, seed=f) for f in range(16)]
    y = torch.stack([k[0] for k in kept])
    w = torch.stack([k[1] for k in kept])
    n0 = ck.LAUNCHES["binning_dense"]
    H = ck.binning_dense_cuda(y, w, M)
    assert ck.LAUNCHES["binning_dense"] == n0 + 1
    assert H.shape == (16, M + 2, E)
    assert torch.equal(H, ck.column_binning_sequential(y, w, M))
    for f in range(16):
        assert torch.equal(H[f], ck.binning_dense_cuda(y[f], w[f], M))
    if M < 700:
        return
    kde = curve_kde(y, w, M, E + 5, 2, use_pallas_binning=True)
    for f in range(16):
        assert torch.equal(kde[f], curve_kde(y[f], w[f], M, E + 5, 2,
                                             use_pallas_binning=True))


def test_small_batch_trace_on_the_card(dev):
    """Two frames of the small slice traced as one batch: K1 and K3 launch
    once per loop iteration for both frames, K2 once for both final costs,
    and each frame traces its edge."""
    from gaussian_process_edge_trace_torch.parallel import (
        make_batch_data, make_batch_state, trace_batch)
    from gaussian_process_edge_trace_torch.trace.driver import make_config
    imgs = [gpt.construct_test_img((64, 96), 40, 2, 0.03, "sinusoidal", 0.3,
                                   seed=s) for s in (1, 2)]
    grads = torch.stack([gpt.comp_grad_img(img, gpt.kernel_builder((9, 5)),
                                           device=dev) for img, _ in imgs])
    inits = np.array([[[0, e[0, 0]], [95, e[95, 0]]] for _, e in imgs])
    cfg = make_config(inits[0], (64, 96), {"kernel": "RBF", "sigma_f": 20,
                                           "length_scale": 8},
                      N_samples=256, delta_x=6, pixel_thresh=4, seed=1)
    data = make_batch_data(cfg, grads, inits)
    for counts in (ci.LAUNCHES, cc.LAUNCHES, ck.LAUNCHES):
        for k in counts:
            counts[k] = 0
    res = trace_batch(cfg, data, make_batch_state(cfg, 2, dev))
    assert ci.LAUNCHES["fused_cost"] == int(res.n_iters.max())
    assert ck.LAUNCHES["binning_2l"] == int(res.n_iters.max())
    assert ci.LAUNCHES["column_interp"] == 1
    # The gates lie at the JAX package's own spread on these images
    # (tests/torch_small_reference.py, tracer seeds 1-30, on a CPU): its
    # lowest DICE is 0.9593 on image seed 1 and 0.9515 on image seed 2, and
    # the median of its two frames' DICE at one tracer seed reads 0.98865
    # over the 30 seeds, with a spread down to 0.9672.
    dice = [gpt.trace_dicecoef(res.edge_trace[f].cpu().numpy(), edge)
            for f, (_, edge) in enumerate(imgs)]
    assert dice[0] > 0.959 and dice[1] > 0.951, dice
    assert np.median(dice) > 0.967, dice


@pytest.mark.parametrize("n", [104, 208, 408])
def test_final_fit_does_not_depend_on_frames(dev, n):
    """The final fit of four frames at once on the card, at n = 104 (the
    direct screen), n = 208 (coarse to fine) and n = 408 (the 2000²
    config's: coarse to fine, the fine fit through the blocked
    orchestration): each frame's mean, std, scale, θ and LML equal, bit for
    bit, its fit alone (factors and solves through K5 and K6, the blocked
    path's trailing products one frame at a time, sums through a fixed
    tree)."""
    import types

    from gaussian_process_edge_trace_torch.trace import driver as pd
    F, N = 4, 1000
    cfg = pd.make_config(np.array([[0, 500], [N - 1, 500]]), (N, N),
                         {"kernel": "RBF", "sigma_f": 200,
                          "length_scale": 50}, N_samples=10000, delta_x=5)
    rng = np.random.default_rng(n)
    x = np.sort(rng.choice(N, (F, n)), axis=-1)
    y = np.rint(500 + 80 * np.sin(x / (90 + 10 * np.arange(F)[:, None]))
                + rng.normal(0, 3, (F, n)))
    mask = rng.random((F, n)) < 0.9
    mask[:, :2] = True
    noise_w = np.ones(n, np.float32)
    noise_w[:2] = cfg.init_noise_weight
    data = types.SimpleNamespace(x_grid=torch.arange(N, device=dev))
    u = torch.rand((cfg.lml_restarts, 3), device=dev,
                   generator=torch.Generator(device=dev).manual_seed(1))
    args = [torch.as_tensor(a, device=dev) for a in (x, y, mask)]
    nw = torch.as_tensor(noise_w, device=dev)
    n0, b0 = dict(cc.LAUNCHES), dict(cc.BLOCKED)
    batch = pd._final_fit_buffers(cfg, data, u, *args, nw)
    assert all(cc.LAUNCHES[k] > n0[k] for k in n0)
    assert all((cc.BLOCKED[k] > b0[k]) == (n > cc._DIRECT_N) for k in b0)
    assert batch[0].shape == (F, N) and torch.isfinite(batch[0]).all()
    for f in range(F):
        one = pd._final_fit_buffers(cfg, data, u,
                                    *(a[f:f + 1] for a in args), nw)
        for a, b in zip(batch, one):
            assert torch.equal(a[f], b[0])


@pytest.mark.parametrize("k", [2, 4])
def test_fused_cost_shard_widths_equal_full_launch_columns(dev, k):
    """K1 at the 1000² trace's shape (E = M = 1000, S = 10⁴) over each of
    k shards of S/k samples, planned on the global S as the sample arm
    plans it: every shard's line and arc equal the full launch's columns
    bit for bit."""
    E = M = 1000
    S = 10000
    cols = torch.tensor(np.random.default_rng(k).random((E, M)),
                        dtype=torch.float32, device=dev)
    ys = torch.tensor(_curves(E, M, S, seed=k), device=dev)
    line, arc = ci.fused_cost_cuda(cols, ys, 1e-3)
    w = S // k
    for j in range(k):
        part = ys[:, j * w:(j + 1) * w].contiguous()
        sl, sa = ci.fused_cost_cuda(cols, part, 1e-3, plan_samples=S)
        assert torch.equal(sl, line[j * w:(j + 1) * w])
        assert torch.equal(sa, arc[j * w:(j + 1) * w])


@pytest.mark.parametrize("k", [2, 4])
def test_unfused_cost_shard_widths_equal_full_columns(dev, k):
    """At an odd E the sample arm scores through K2 and ``line_and_arc``'s
    PyTorch reductions over E: over each of k shards of S/k samples they
    give the columns of the full S bit for bit."""
    E, M, S = 999, 1000, 10000
    cols = torch.tensor(np.random.default_rng(k).random((E, M)),
                        dtype=torch.float32, device=dev)
    ys = torch.tensor(_curves(E, M, S, seed=k), device=dev)

    def cost(y):
        return ci.line_and_arc(ci.column_interp(cols, y, 1e-3), y)
    line, arc = cost(ys)
    w = S // k
    for j in range(k):
        sl, sa = cost(ys[:, j * w:(j + 1) * w].contiguous())
        assert torch.equal(sl, line[j * w:(j + 1) * w])
        assert torch.equal(sa, arc[j * w:(j + 1) * w])


def test_sharded_one_by_one_nccl_equals_trace_batch(dev, tmp_path):
    """``sharded_trace_batch`` on a (1, 1) NCCL mesh in this process (NCCL
    refuses two ranks on one device, and the GPU tests need one card):
    bitwise ``trace_batch`` of the same two frames, with one all_gather
    and one all_reduce per loop iteration and one all_gather at the end."""
    import torch.distributed as dist

    from gaussian_process_edge_trace_torch.ops import collectives
    from gaussian_process_edge_trace_torch.parallel import (
        make_batch_data, make_batch_state, make_mesh, sharded_trace_batch,
        trace_batch)
    from gaussian_process_edge_trace_torch.trace.driver import make_config
    imgs = [gpt.construct_test_img((64, 96), 40, 2, 0.03, "sinusoidal", 0.3,
                                   seed=s) for s in (1, 2)]
    grads = torch.stack([gpt.comp_grad_img(img, gpt.kernel_builder((9, 5)),
                                           device=dev) for img, _ in imgs])
    inits = np.array([[[0, e[0, 0]], [95, e[95, 0]]] for _, e in imgs])
    cfg = make_config(inits[0], (64, 96), {"kernel": "RBF", "sigma_f": 20,
                                           "length_scale": 8},
                      N_samples=256, delta_x=6, pixel_thresh=4, seed=1)
    data = make_batch_data(cfg, grads, inits)
    want = trace_batch(cfg, data, make_batch_state(cfg, 2, dev))
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rv",
                            world_size=1, rank=0)
    try:
        collectives.COLLECTIVES.update(all_gather=0, all_reduce=0)
        got = sharded_trace_batch(cfg, data, make_batch_state(cfg, 2, dev),
                                  make_mesh(1, 1, "cuda"), 2)
    finally:
        dist.destroy_process_group()
    for f in want._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    loops = int(want.n_iters.max())
    assert collectives.COLLECTIVES == {"all_gather": loops + 1,
                                       "all_reduce": loops}


def _small_tracer(dev, **kw):
    img, edge = gpt.construct_test_img((64, 96), 40, 2, 0.03, "sinusoidal",
                                       0.3)
    grad = gpt.comp_grad_img(img, gpt.kernel_builder((9, 5)), device=dev)
    init = np.array([[0, edge[0, 0]], [95, edge[95, 0]]])
    return gpt.GP_Edge_Tracing(init, grad, {"kernel": "RBF", "sigma_f": 20,
                                            "length_scale": 8}, 1,
                               np.array([]), 256, 1, 6, 0.1, 4, 1, False,
                               True, device=dev, **kw)


def _same_result(a, b):
    return all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
               for x, y in zip(a, b))


def test_introspective_trace_on_the_card(dev):
    """``return_lines`` and ``verbose`` on the card: the fused call's result
    bit for bit, with the same launches of every kernel."""
    tracer = _small_tracer(dev)
    counts = (ci.LAUNCHES, cc.LAUNCHES, ck.LAUNCHES)
    launches = []
    results = []
    for kw in ({}, {"return_lines": True}, {"verbose": True}):
        for c in counts:
            for k in c:
                c[k] = 0
        out = tracer(**kw)
        torch.cuda.synchronize()
        launches.append([dict(c) for c in counts])
        results.append(tracer.last_result)
        edge = out[0] if kw.get("return_lines") else out
        if not kw:
            fused = out
        np.testing.assert_array_equal(edge, fused)
    assert launches[1] == launches[0] == launches[2]
    assert _same_result(results[1], results[0])
    assert _same_result(results[2], results[0])
    n = results[0].n_iters
    _, (samples, obs, curves) = tracer(return_lines=True)
    assert len(samples) == n + 1 and samples[0].shape == (96, 256)
    assert len(obs) == n + 2 and len(curves) == n + 1


def test_checkpoint_round_trip_on_the_card(dev, tmp_path):
    """Two ``trace_step``s on the card, ``save_checkpoint``,
    ``load_checkpoint`` onto the card and ``resume_trace``: the
    uninterrupted trace bit for bit; a changed image is refused."""
    from gaussian_process_edge_trace_torch.trace import checkpoint as pck
    from gaussian_process_edge_trace_torch.trace import driver as pd
    tracer = _small_tracer(dev)
    cfg, data = tracer.cfg, tracer.data
    full = pd.run_trace(cfg, data, pd.init_state(cfg, dev))
    state = pd.init_state(cfg, dev)
    for _ in range(2):
        state, _ = pd.trace_step(cfg, data, state)
    p = tmp_path / "ckpt.npz"
    pck.save_checkpoint(p, cfg, state, data=data)
    lcfg, loaded = pck.load_checkpoint(p, expect_cfg=cfg, data=data)
    assert loaded.obs_x.device.type == "cuda" and loaded.it == 2
    assert _same_result(pck.resume_trace(lcfg, data, loaded), full)
    grad = data.grad_img.clone()
    grad[10, 20] += 0.25
    other = pd.make_data(cfg, grad, tracer.init, dev)
    with pytest.raises(ValueError, match="fingerprint"):
        pck.load_checkpoint(p, data=other)


def test_selftest_is_green_on_the_card(dev):
    """``run_selftest`` pins K1-K6 (K4 over frames too) on the card."""
    from gaussian_process_edge_trace_torch.utils.selftest import run_selftest
    lines = []
    results = run_selftest(lines.append)
    assert [name for name, _ in results] == [
        "fused_cost_vs_plain", "column_interp_vs_plain",
        "binning_2l_vs_plain", "binning_dense_frames_vs_sequential",
        "cholesky_and_solves_vs_plain"]
    assert len(lines) == len(results) and all(s > 0 for _, s in results)


def test_cli_trace_on_the_card_equals_the_api(dev, tmp_path, capsys):
    """``trace`` through the CLI on the card: the ``.npz`` trace and
    interval bit for bit the in-process ``GP_Edge_Tracing``'s."""
    from gaussian_process_edge_trace_torch.__main__ import main
    img, edge = gpt.construct_test_img((64, 96), 40, 2, 0.03, "sinusoidal",
                                       0.3, seed=1)
    np.save(tmp_path / "img.npy", img)
    init = np.array([[0, edge[0, 0]], [95, edge[95, 0]]])
    main(["trace", str(tmp_path / "img.npy"), "--init",
          f"0,{init[0, 1]}", f"95,{init[1, 1]}", "--sigma-f", "20",
          "--length-scale", "8", "--n-samples", "256", "--delta-x", "6",
          "--pixel-thresh", "4", "--seed", "1", "--out",
          str(tmp_path / "r.npz")])
    capsys.readouterr()
    grad = gpt.comp_grad_img(img, gpt.kernel_builder((11, 5)), device=dev)
    tracer = gpt.GP_Edge_Tracing(
        init, grad, {"kernel": "RBF", "sigma_f": 20, "length_scale": 8}, 1,
        np.zeros((0, 2)), 256, 1, 6, 0.1, 4, 1, True, True, device=dev)
    edge_pred, (lo, hi) = tracer()
    z = np.load(tmp_path / "r.npz")
    np.testing.assert_array_equal(z["edge_trace"], edge_pred)
    np.testing.assert_array_equal(z["cred_lower"], lo)
    np.testing.assert_array_equal(z["cred_upper"], hi)


@pytest.mark.parametrize("technique,kwargs,rtol", [
    ("gaussian", {}, 1e-5), ("median", {"size": 4}, 0.0),
    ("minimum", {"size": 3}, 0.0), ("tvc", {}, 5e-4),
    ("nl", {"patch_distance": 5}, 1e-5),
    ("wavelet", {"wavelet": "db4"}, 1e-5),
    ("wavelet", {"wavelet": "sym8", "method": "VisuShrink"}, 1e-5),
    ("tvb", {}, 1e-4)])
def test_denoisers_on_the_card_match_the_cpu(dev, technique, kwargs, rtol):
    """Each denoiser on the card against the port's CPU path on one noisy
    image: bitwise where the filter only sorts or compares, else within
    ``rtol`` of the largest magnitude (reductions and the library's exp
    round otherwise on the card; tvc amplifies last-bit differences over
    its 100 projections, tvb's stopping test may fall an iteration apart)."""
    img, _ = gpt.construct_test_img((200, 150), 60, 2, 0.05, "sinusoidal",
                                    0.3, gaps=True)
    cpu = gpt.denoise(torch.tensor(img, dtype=torch.float32), technique,
                      kwargs)
    got = gpt.denoise(img, technique, kwargs, device=dev)
    assert got.device.type == "cuda" and got.shape == cpu.shape
    if rtol == 0.0:
        assert torch.equal(got.cpu(), cpu)
    else:
        err = (got.cpu() - cpu).abs().max().item() / cpu.abs().max().item()
        assert err <= rtol


def test_card_generator_keeps_64_bits_of_a_seed(dev):
    """The card's generator tells seeds 2³² apart, which the default draws'
    64-bit packing needs (the CPU's gives them one stream)."""
    def normals(seed):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        return torch.randn(64, generator=g, device=dev)
    for s in (5, 2 ** 16 + 1, 2 ** 32 + 7):
        assert not torch.equal(normals(s), normals(s + 2 ** 32))
    assert torch.equal(normals(5), normals(5))


def test_wide_draws_on_the_card(dev):
    """The default draws beyond the 32-bit packing, on the card: tracer
    seeds 1 and 65537 = 1 + 2¹⁶ trace differently; a 65-member ensemble
    runs, its members' first-iteration normals all distinct; ``max_iters``
    = 1100 builds its streams, those past slot 1022 in the 64-bit
    packing."""
    from gaussian_process_edge_trace_torch.parallel import trace_ensemble
    from gaussian_process_edge_trace_torch.trace import driver as pd
    img, edge = gpt.construct_test_img((64, 96), 40, 2, 0.03, "sinusoidal",
                                       0.3)
    grad = gpt.comp_grad_img(img, gpt.kernel_builder((9, 5)), device=dev)
    init = np.array([[0, edge[0, 0]], [95, edge[95, 0]]])

    def traced(seed):
        tracer = gpt.GP_Edge_Tracing(
            init, grad, {"kernel": "RBF", "sigma_f": 20, "length_scale": 8},
            1, np.array([]), 256, 1, 6, 0.1, 4, seed, False, True,
            device=dev)
        tracer()
        return tracer
    one, far = traced(1), traced(1 + 2 ** 16)
    assert not torch.equal(one.last_result.y_mean, far.last_result.y_mean)
    cfg, data = one.cfg, one.data
    rank = data.L_prior_unit.shape[1]
    z0 = [pd.TorchDraws(cfg, rank, dev, member=k).normals(0)[0]
          for k in range(65)]
    assert all(not torch.equal(z0[a], z0[b])
               for a in range(65) for b in range(a))
    best, every = trace_ensemble(cfg, data, pd.init_state(cfg, device=dev),
                                 n_seeds=65, return_all=True)
    assert every.edge_trace.shape[0] == 65
    assert torch.isfinite(every.y_mean).all()
    long = pd.TorchDraws(cfg._replace(max_iters=1100), rank, dev)
    seeds = [long.iteration_seed(it) for it in range(1100)]
    assert len(set(seeds)) == 1100 and seeds[1021] < 2 ** 32 <= seeds[1022]
    z = [long.normals(it)[0] for it in (1021, 1022, 1099)]
    assert not torch.equal(z[0], z[1]) and not torch.equal(z[1], z[2])
