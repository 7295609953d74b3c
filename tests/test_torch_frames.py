"""PyTorch port: the frame-batched product K8 and row sum K9
(``ops/cuda_frames.py``) through their plain versions on the CPU, at the
shapes of the three products and the sums that the tracing loop gives them:
a shared or a per-frame operand, frames equal to their batch of one bit for
bit, values within float32 rounding of a float64 product or sum; and the
launch plans and k ranges that the CUDA launchers mirror. The kernels
themselves run in ``tests/test_torch_cuda.py`` on the card."""

import numpy as np
import pytest
import torch

from gaussian_process_edge_trace_torch.ops import cuda_frames as cf
from gaussian_process_edge_trace_torch.trace import kde

torch.set_num_threads(1)

# Unit roundoff of float32: a sum of K products in any order is within
# K·u·Σ|a||b| of the exact one (a chain of K rounded adds).
U32 = 2.0 ** -24


def _toeplitz(n, band=8):
    return kde._toeplitz(n, kde.gaussian_taps(band))


def _site(site, B, rng):
    """(a, b) as the loop hands them to K8: the sampling round's cross
    product (both per frame), or the blur's Ty @ g and g @ Tx (the factor
    shared, given without the frame axis)."""
    def frames(*shape):
        return torch.tensor(rng.normal(size=(B,) + shape),
                            dtype=torch.float32)
    if site == "cross":
        return frames(37, 13).abs(), frames(13, 70)
    if site == "blur_rows":
        return _toeplitz(40), frames(40, 30).abs()
    return frames(40, 30).abs(), _toeplitz(30)


def _within_rounding(C, a, b):
    exact = a.double() @ b.double()
    scale = a.double().abs() @ b.double().abs()
    assert (C.double() - exact).abs().le(a.shape[-1] * U32 * scale
                                         + 1e-30).all()


@pytest.mark.parametrize("B", [1, 3, 7])
@pytest.mark.parametrize("site", ["cross", "blur_rows", "blur_cols"])
def test_frames_product_plain_frames_equal_batch_of_one(site, B):
    rng = np.random.default_rng(B)
    a, b = _site(site, B, rng)
    C = cf.frames_product(a, b)
    assert C.shape == (B, a.shape[-2], b.shape[-1])
    for f in range(B):
        one = cf.frames_product(a if a.dim() == 2 else a[f:f + 1],
                                b if b.dim() == 2 else b[f:f + 1])
        assert torch.equal(C[f], one[0])
    _within_rounding(C, a, b)


@pytest.mark.parametrize("B", [1, 3, 7])
@pytest.mark.parametrize("n", [100, 104, 1000])
def test_row_sum_plain_frames_equal_batch_of_one(n, B):
    rng = np.random.default_rng(n + B)
    x = torch.tensor(rng.normal(size=(B, n)), dtype=torch.float32)
    s = cf.row_sum(x)
    assert s.shape == (B,)
    for f in range(B):
        assert torch.equal(s[f], cf.row_sum(x[f:f + 1])[0])
    exact = x.double().sum(-1)
    assert (s.double() - exact).abs().le(
        n * U32 * x.double().abs().sum(-1)).all()


@pytest.mark.parametrize("F,M,N,K", [(64, 500, 1000, 104),
                                     (1, 1000, 10000, 208),
                                     (256, 502, 502, 502), (3, 1, 1, 1)])
def test_product_launch_plan_covers_every_output_once(F, M, N, K):
    """The grid's tiles cover every output element of every frame once:
    the last tile of each axis reaches past the end by less than a tile."""
    plan = cf.product_launch_plan(F, M, N, K)
    gx, gy, gz = plan["grid"]
    assert gz == F and plan["blocks"] == gx * gy * gz
    assert (gx - 1) * cf.TILE_N < N <= gx * cf.TILE_N
    assert (gy - 1) * cf.TILE_M < M <= gy * cf.TILE_M
    assert plan["smem_bytes"] == 16640 and plan["threads"] == 256


@pytest.mark.parametrize("n", [66, 98, 502])
def test_band_k_range_skips_only_zeros(n):
    """The k range a tile walks holds every nonzero of a banded factor over
    the tile's rows (a shared A) or columns (a shared B), so the products it
    skips are zeros; at most a tile and both bands, rounded to k-tiles."""
    T = _toeplitz(n)
    for start in range(0, n, cf.TILE_M):
        lo, hi = cf.product_k_range(n, start, 0, a_band=8)
        rows = T[start:start + cf.TILE_M]
        assert not rows[:, :lo].any() and not rows[:, hi:].any()
        lo_b, hi_b = cf.product_k_range(n, 0, start, b_band=8)
        cols = T[:, start:start + cf.TILE_N]
        assert not cols[:lo_b].any() and not cols[hi_b:].any()
        assert lo % cf.TILE_K == 0
        assert hi - lo <= cf.TILE_M + 2 * 8 + cf.TILE_K
    assert cf.product_k_range(n, 0, 0) == (0, n)


def test_row_sum_launch_plan_gives_each_row_a_warp():
    for rows in (1, 8, 9, 64, 256):
        plan = cf.row_sum_launch_plan(rows)
        per = plan["threads"] // 32
        assert (plan["blocks"] - 1) * per < rows <= plan["blocks"] * per


def test_frames_product_refuses_what_the_kernel_does_not_take():
    """Shapes that do not multiply, frame axes that differ and a band on a
    per-frame operand raise before any launch."""
    a, b = torch.ones(3, 4, 5), torch.ones(3, 5, 6)
    for x, y, kw in ((a, torch.ones(3, 4, 6), {}),
                     (a, torch.ones(2, 5, 6), {}),
                     (a, b, {"a_band": 2}),
                     (torch.ones(4, 5), b, {"b_band": 2}),
                     (torch.ones(4, 5), b, {"a_band": -1})):
        with pytest.raises(ValueError):
            cf.frames_product_cuda(x, y, **kw)


def test_blur_matrices_carry_their_band():
    """``blur_matrices`` hands back (Ty, Tx) with the band that K8's tiles
    skip beyond; the blur through them equals the blur that builds its own
    factors."""
    mats = kde.blur_matrices(38, 88, dtype=torch.float32)
    Ty, Tx = mats
    assert mats.band == kde.DEFAULT_RADIUS and Ty.shape == (40, 40)
    grid = torch.rand(2, 40, 90)
    taps = kde.gaussian_taps(kde.DEFAULT_RADIUS)
    assert torch.equal(kde._separable_blur(grid, taps, mats=mats),
                       kde._separable_blur(grid, taps))


@pytest.mark.parametrize("size", [(64, 96), (96, 64)])
def test_batch_data_takes_every_frame_kde_in_one_call(size, monkeypatch):
    """``make_batch_data`` blurs every frame's gradient KDE in one call of
    each product (the Toeplitz factor shared, its band given), and each
    frame's data equals ``make_data`` of that frame alone, bit for bit."""
    import gaussian_process_edge_trace_torch as gpt
    from gaussian_process_edge_trace_torch.parallel import make_batch_data
    from gaussian_process_edge_trace_torch.trace import driver as pd
    M, N = size
    imgs = [gpt.construct_test_img(size, M // 2.5, 2, 0.03, "sinusoidal",
                                   0.3, seed=s) for s in (1, 2, 3)]
    grads = torch.stack([gpt.comp_grad_img(img, gpt.kernel_builder((9, 5)),
                                           device="cpu") for img, _ in imgs])
    inits = np.array([[[0, e[0, 0]], [N - 1, e[N - 1, 0]]] for _, e in imgs])
    cfg = pd.make_config(inits[0], size, {"kernel": "RBF", "sigma_f": 20,
                                          "length_scale": 8},
                         N_samples=64, seed=1)
    calls = []

    def counted(a, b, **kw):
        calls.append((tuple(a.shape), tuple(b.shape), kw))
        return cf.frames_product(a, b, **kw)
    monkeypatch.setattr(kde, "frames_product", counted)
    data = make_batch_data(cfg, grads, inits, device="cpu")
    assert calls == [((M + 2, M + 2), (3, M + 2, N + 2), {"a_band": 8}),
                     ((3, M + 2, N + 2), (N + 2, N + 2), {"b_band": 8})]
    for f in range(3):
        one = pd.make_data(cfg, grads[f], inits[f], device="cpu")
        for k in ("grad_img", "grad_kde", "grad_cols", "init_x", "init_y"):
            assert torch.equal(getattr(data, k)[f], getattr(one, k)), k
