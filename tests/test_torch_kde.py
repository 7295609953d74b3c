"""PyTorch port, KDE binning kernels K3 and K4: their plain PyTorch versions
(dense and sequential) against the JAX package's Pallas functions, run in
interpret mode on the CPU, the routing of ``column_binning`` and the K3 and
K4 launch plans. The kernels themselves are held
against the plain version on a GPU by ``test_torch_cuda.py``."""

import functools

import jax
import jax.experimental.pallas
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_process_edge_trace_torch.ops import cuda_build
from gaussian_process_edge_trace_torch.trace import cuda_kde as ck
from gaussian_process_edge_trace_torch.trace import kde as pkde
from gaussian_process_edge_trace_tpu.trace import pallas_kde as pk
from torch_parity import t32

torch.set_num_threads(1)


def _binning_inputs(E, S, M, seed=7):
    """Rows spread over and beyond the image, with exact integers, both
    image edges and an out-of-image sentinel in the first samples (the
    reference test's inputs, test_trace.py:66-70)."""
    rng = np.random.default_rng(seed)
    y = np.asarray(rng.uniform(-3, M + 2, (E, S)), np.float32)
    y[:, :4] = [0.0, M - 1.0, M / 2, -1.0]
    y[::5, 4] = -10.0
    y[1::5, 5] = float(M)
    w = rng.random(S).astype(np.float32)
    return y, w


@pytest.mark.parametrize("E,S,M", [
    (37, 33, 129),    # E not a multiple of the 8-column block, odd M
    (48, 5000, 257),  # three sample chunks and a masked edge chunk
])
def test_binning_plain_matches_binning_2l(E, S, M, monkeypatch):
    """K3's plain version against ``_binning_2l`` in interpret mode, called
    as the reference's own test calls it, within that test's bounds: rtol
    1e-5, atol 1e-6·max|H| (the two sum the same taps in other orders)."""
    monkeypatch.setattr(pk, "_S_BLK2L", 2048)
    y, w = _binning_inputs(E, S, M)
    ref = np.asarray(jax.jit(
        lambda a, b: pk._binning_2l.__wrapped__(a, b, M))(
            jnp.asarray(y), jnp.asarray(w)))
    got = ck.column_binning_plain(t32(y), t32(w), M).numpy()
    assert got.shape == ref.shape == (M + 2, E)
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("E,S,M", [(37, 40, 61), (48, 129, 100)])
def test_binning_plain_matches_binning_pallas(E, S, M, monkeypatch):
    """K4's plain version against ``_binning_pallas``, whose
    ``pallas_call`` has no interpret flag: it is run in interpret mode by
    patching ``pallas_call`` for the call. Same bounds as K3."""
    monkeypatch.setattr(
        jax.experimental.pallas, "pallas_call",
        functools.partial(jax.experimental.pallas.pallas_call,
                          interpret=True))
    y, w = _binning_inputs(E, S, M, seed=3)
    ref = np.asarray(pk._binning_pallas.__wrapped__(jnp.asarray(y),
                                                     jnp.asarray(w), M))
    got = ck.column_binning_plain(t32(y), t32(w), M).numpy()
    assert got.shape == ref.shape == (M + 2, E)
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("E,S,M", [(37, 40, 61), (12, 129, 30)])
def test_binning_sequential_matches_plain_and_pallas(E, S, M, monkeypatch):
    """The sequential plain version (K4's order: each sample's term added
    in index order) against the dense plain version and ``_binning_pallas``
    run in interpret mode, within the reference test's bounds; and, where
    every sample falls in one row, equal to a float32 loop in numpy that
    adds one rounded term at a time."""
    monkeypatch.setattr(
        jax.experimental.pallas, "pallas_call",
        functools.partial(jax.experimental.pallas.pallas_call,
                          interpret=True))
    y, w = _binning_inputs(E, S, M, seed=5)
    got = ck.column_binning_sequential(t32(y), t32(w), M).numpy()
    ref = np.asarray(pk._binning_pallas.__wrapped__(jnp.asarray(y),
                                                     jnp.asarray(w), M))
    plain = ck.column_binning_plain(t32(y), t32(w), M).numpy()
    for other in (ref, plain):
        np.testing.assert_allclose(got, other, rtol=1e-5,
                                   atol=1e-6 * np.abs(other).max())
    one = np.full((E, S), np.float32(M / 2 + 0.25))
    row = int(np.floor(one[0, 0] + 1))
    acc = np.zeros((2, E), np.float32)
    for s in range(S):
        for j, m in enumerate((row, row + 1)):
            hat = np.maximum(np.float32(0), np.float32(1) - np.abs(
                (one[:, s] + np.float32(1)) - np.float32(m)))
            acc[j] = acc[j] + hat * w[s]
    seq = ck.column_binning_sequential(t32(one), t32(w), M).numpy()
    np.testing.assert_array_equal(seq[row:row + 2], acc)
    assert not np.delete(seq, [row, row + 1], axis=0).any()


def test_plain_binning_chunks_agree(monkeypatch):
    """The plain version's chunked sum equals its one-block sum to f32
    rounding (the chunk size only splits the sum over kept curves)."""
    y, w = _binning_inputs(20, 300, 40)
    whole = ck.column_binning_plain(t32(y), t32(w), 40).numpy()
    monkeypatch.setattr(ck, "_CHUNK_ELEMS", 42 * 20 * 64)   # 64 per chunk
    chunked = ck.column_binning_plain(t32(y), t32(w), 40).numpy()
    np.testing.assert_allclose(chunked, whole, rtol=1e-6,
                               atol=1e-7 * np.abs(whole).max())


@pytest.mark.parametrize("E,S,M", [
    (1000, 1000, 1000),   # the 1000² config's kept curves
    (500, 100, 500),      # the demo's
    (2000, 100, 2000),
    (37, 33, 129),        # ragged
    (64, 1000, 200),      # eight warps per column
    (5, 1, 7),            # S = 1
    (1, 1, 1),
    (3, 0, 5),            # no kept curve: H is zero
])
def test_k3_launch_plan_covers_columns_and_samples_once(E, S, M):
    """K3's plan: every column lies in exactly one block, every sample of a
    column in exactly one warp's batches, no warp is without samples, and
    one block fits 1024 threads and the card's 232,448 bytes of shared
    memory."""
    plan = ck.k3_launch_plan(E, S, M)
    assert plan["smem_bytes"] <= cuda_build.SMEM_LIMIT
    assert plan["threads"] == 32 * plan["cols"] * plan["warps_per_col"] <= 1024
    cols = np.zeros(E, int)
    for b in range(plan["blocks"]):
        e = np.arange(b * plan["cols"], (b + 1) * plan["cols"])
        cols[e[e < E]] += 1
    assert (cols == 1).all()
    span = 32 * plan["batches_per_warp"]
    samples = np.zeros(S, int)
    for p in range(plan["warps_per_col"]):
        assert p * span < max(S, 1)
        samples[p * span:(p + 1) * span] += 1
    assert (samples == 1).all()


@pytest.mark.parametrize("E,S,M", [
    (1000, 1000, 1000),   # the 1000² config's kept curves
    (500, 100, 500),      # the demo's
    (21, 8269, 100),      # several tiles
    (37, 33, 129),        # ragged: the last block's columns past E
    (3, 0, 5),            # no kept curve
    (10, 100, 9000),      # tall columns: fewer columns per block
])
def test_k4_launch_plan_covers_columns_and_samples_once(E, S, M):
    """K4's plan: every column lies in exactly one block of a power-of-two
    number of columns, two warps each; every sample in exactly one tile,
    and within a tile in exactly one of its two halves; one block fits the
    card's shared memory."""
    plan = ck.k4_launch_plan(E, S, M)
    cols, tile = plan["cols"], plan["tile"]
    assert cols & (cols - 1) == 0 and plan["threads"] == 64 * cols
    assert plan["smem_bytes"] == ck.k4_smem_bytes(M, tile, cols)
    assert plan["smem_bytes"] <= cuda_build.SMEM_LIMIT
    seen = np.zeros(E, int)
    for b in range(plan["blocks"]):
        e = np.arange(b * cols, (b + 1) * cols)
        seen[e[e < E]] += 1
    assert (seen == 1).all()
    samples = np.zeros(S, int)
    for t in range(plan["tiles"]):
        n = min(tile, S - t * tile)
        span = -(-n // 2)
        for h in range(2):      # the kernel's halves of the tile
            k0 = t * tile + h * span
            samples[k0:t * tile + min(n, (h + 1) * span)] += 1
    assert (samples == 1).all()


def test_k3_launch_plan_lowers_then_refuses_tall_columns():
    """Tall columns take fewer warps per column, then fewer columns per
    block; beyond one warp's accumulators in shared memory there is no
    launch, and the wrapper's check raises before any kernel."""
    assert ck.k3_launch_plan(100, 1000, 1000)["warps_per_col"] == 8
    tall = ck.k3_launch_plan(100, 1000, 20000)
    assert (tall["cols"], tall["warps_per_col"]) == (2, 1)
    assert tall["smem_bytes"] <= cuda_build.SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        ck.k3_launch_plan(100, 1000, 60000)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_column_binning_takes_plain_version_on_cpu(use_pallas):
    """On CPU tensors both flags give the plain version and launch
    nothing; ``trace/kde.py`` exposes the same function."""
    y, w = _binning_inputs(12, 30, 20)
    n0 = dict(ck.LAUNCHES)
    got = pkde.column_binning(t32(y), t32(w), 20, use_pallas=use_pallas)
    assert ck.LAUNCHES == n0
    np.testing.assert_array_equal(
        got.numpy(), ck.column_binning_plain(t32(y), t32(w), 20).numpy())


def test_curve_kde_flag_reaches_binning():
    """``curve_kde(..., use_pallas_binning=True)`` is the same KDE on the
    CPU."""
    y, w = _binning_inputs(30, 25, 40)
    a = pkde.curve_kde(t32(y), t32(w), 40, 50, 3)
    b = pkde.curve_kde(t32(y), t32(w), 40, 50, 3, use_pallas_binning=True)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_binning_wrappers_refuse_cpu_tensors():
    """The kernel arms take CUDA tensors only: no silent fallback."""
    y, w = _binning_inputs(8, 16, 20)
    for fn in (ck.binning_2l_cuda, ck.binning_dense_cuda):
        with pytest.raises(ValueError, match="not cuda"):
            fn(t32(y), t32(w), 20)
    with pytest.raises(ValueError, match="expected"):
        ck.binning_2l_cuda(t32(y), t32(w[:-1]), 20)


def test_sequential_binning_takes_frames():
    """The sequential plain version over (B, E, S) frames with (B, S)
    weights: each frame bitwise its single-frame call, which the GPU tests
    and the smoke hold K4's frames to."""
    frames = [_binning_inputs(12, 40, 30, seed=f) for f in range(3)]
    y = t32(np.stack([f[0] for f in frames]))
    w = t32(np.stack([f[1] for f in frames]))
    H = ck.column_binning_sequential(y, w, 30)
    assert H.shape == (3, 32, 12)
    for f in range(3):
        assert torch.equal(H[f], ck.column_binning_sequential(y[f], w[f], 30))


def test_binning_dense_wrapper_takes_frames():
    """K4's wrapper accepts (B, E, S) with (B, S), as K3's does: on CPU
    tensors it gets past the shape check and refuses the device."""
    y, w = _binning_inputs(8, 16, 20)
    yb, wb = t32(np.stack([y, y])), t32(np.stack([w, w]))
    for fn in (ck.binning_2l_cuda, ck.binning_dense_cuda):
        with pytest.raises(ValueError, match="not cuda"):
            fn(yb, wb, 20)
        with pytest.raises(ValueError, match="B, S"):
            fn(yb, wb[:, :-1], 20)
