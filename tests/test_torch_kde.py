"""PyTorch port, KDE binning kernels K3 and K4: their plain PyTorch version
against the JAX package's Pallas functions, run in interpret mode on the CPU,
and the routing of ``column_binning``. The kernels themselves are held
against the plain version on a GPU by ``test_torch_cuda.py``."""

import functools

import jax
import jax.experimental.pallas
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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


def test_plain_binning_chunks_agree(monkeypatch):
    """The plain version's chunked sum equals its one-block sum to f32
    rounding (the chunk size only splits the sum over kept curves)."""
    y, w = _binning_inputs(20, 300, 40)
    whole = ck.column_binning_plain(t32(y), t32(w), 40).numpy()
    monkeypatch.setattr(ck, "_CHUNK_ELEMS", 42 * 20 * 64)   # 64 per chunk
    chunked = ck.column_binning_plain(t32(y), t32(w), 40).numpy()
    np.testing.assert_allclose(chunked, whole, rtol=1e-6,
                               atol=1e-7 * np.abs(whole).max())


@pytest.mark.parametrize("M", [5, 33, 129, 500, 1000, 2000, 4097])
def test_row_block_height_matches_reference(M):
    assert ck._hb_for(M) == pk._hb_for(M)


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
