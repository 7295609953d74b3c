"""PyTorch port, the denoisers (``utils/denoise_native.py`` and
``utils/image.py::denoise``) against the JAX package's functions on the CPU.

The same images, made from a numpy seed, go through both. Sizes 48×40 and
41×37 hit even and odd axes. Tolerances, each relative to the largest
magnitude of the JAX output: the order-free filters (median, minimum) are
bitwise; the float32 denoisers within 1e-5; the float64 metrics within
1e-10, the filter tables within 1e-12. ``tvc`` is held within 5e-4 at its
worst pixel and 1e-6 on average: XLA on the CPU contracts ``a*b + c`` into
fused multiply-adds and PyTorch does not, a last-bit difference from the
first iteration on, which 100 projections amplify at the kinks of the ROF
dual. The wavelets are in ``test_torch_wavelet.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gaussian_process_edge_trace_torch.utils import denoise_native as td
from gaussian_process_edge_trace_torch.utils import image as ti
from gaussian_process_edge_trace_tpu.utils import denoise_native as jd
from gaussian_process_edge_trace_tpu.utils import image as ji

torch.set_num_threads(1)

SIZES = [(48, 40), (41, 37)]


def _image(H, W, seed=0):
    """A noisy two-level image with a sinusoidal boundary, in [~0, ~1]."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:H, :W]
    base = (yy > H / 2 + 5 * np.sin(xx / 6)).astype(np.float32) * 0.6 + 0.2
    return (base + 0.1 * rng.standard_normal((H, W))).astype(np.float32)


def _close(got, want, rtol, mean_atol=None):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    diff = np.abs(got.astype(np.float64) - want)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(diff)) / scale
    assert err <= rtol, f"relative error {err:.3e} > {rtol:.0e}"
    if mean_atol is not None:
        assert float(np.mean(diff)) <= mean_atol


def _both(H, W, technique, kwargs, seed=0):
    x = _image(H, W, seed)
    return (ti.denoise(torch.tensor(x), technique, kwargs),
            ji.denoise(x, technique, kwargs))


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("technique,kwargs", [
    ("median", {}),
    ("median", {"size": 4}),                       # an even window
    ("median", {"size": 4, "mode": "wrap"}),
    ("median", {"size": 5, "mode": "nearest"}),
    ("minimum", {}),
    ("minimum", {"size": 4, "mode": "mirror"}),    # the (H+1, W+1) window
    ("minimum", {"size": 3, "mode": "constant"}),
])
def test_order_free_filters_are_bitwise(size, technique, kwargs):
    """Median and minimum sort or compare: bitwise equal to the JAX
    function, an even ``size`` included (the mean of the two middle
    values)."""
    got, want = _both(*size, technique, kwargs)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("technique,kwargs,rtol", [
    ("gaussian", {}, 1e-5),
    ("gaussian", {"sigma": 2.0, "mode": "nearest"}, 1e-5),
    ("gaussian", {"sigma": 0.7, "radius": 2, "mode": "mirror"}, 1e-5),
    ("tvc", {}, 5e-4),
    ("tvc", {"weight": 0.3, "n_iter": 30, "mode": "reflect"}, 5e-4),
    ("nl", {"patch_distance": 2}, 1e-5),
    ("nl", {"patch_size": 5, "patch_distance": 3, "h": 0.08,
            "sigma": 0.05}, 1e-5),
    ("tvb", {}, 1e-5),
    ("tvb", {"eps": 0.0}, 1e-5),
    ("tvb", {"weight": 2.0, "isotropic": False, "max_num_iter": 20}, 1e-5),
])
def test_denoise_techniques_match_reference(size, technique, kwargs, rtol):
    got, want = _both(*size, technique, kwargs)
    _close(got, want, rtol, mean_atol=1e-6)


@pytest.mark.parametrize("n", [2, 7, 64, 65])
def test_median_averages_the_two_middle_values(n):
    """``jnp.median``'s rule, bitwise, for even and odd counts; and the
    MAD sigma of images whose finest diagonal subband holds an even count
    (48×40: 24·20) and an odd one (41×37: 21·19)."""
    rng = np.random.default_rng(n)
    a = rng.standard_normal((3, n)).astype(np.float32)
    np.testing.assert_array_equal(td._median_last(torch.tensor(a)).numpy(),
                                  np.asarray(jnp.median(a, axis=-1)))
    for H, W in SIZES:
        x = _image(H, W, seed=n)
        np.testing.assert_array_equal(
            td.estimate_sigma(torch.tensor(x)).numpy(),
            np.asarray(jd.estimate_sigma(x)))


@pytest.mark.parametrize("metric", ["peak_signal_noise_ratio",
                                    "normalized_root_mse",
                                    "structural_similarity"])
@pytest.mark.parametrize("size", SIZES)
def test_quality_metrics_match_reference(metric, size):
    x = _image(*size)
    y = np.asarray(ji.denoise(x, "gaussian", {}))
    got = getattr(td, metric)(torch.tensor(x), torch.tensor(y))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(float(got), float(getattr(jd, metric)(x, y)),
                               rtol=1e-10)
    if metric == "normalized_root_mse":
        for norm in ("euclidean", "mean"):
            np.testing.assert_allclose(
                float(td.normalized_root_mse(torch.tensor(x), torch.tensor(y),
                                             norm)),
                float(jd.normalized_root_mse(x, y, norm)), rtol=1e-10)


def test_shannon_entropy_bins_edges_as_reference():
    """Values on bin edges: 0.5 is edge 128 and opens bin 128 (a value
    just below it stays in bin 127), and the maximum falls in the closed
    last bin with its neighbour; a wrong edge rule merges or splits bins
    and moves the entropy. Also a random image and a constant one."""
    vals = np.array([0.0, 0.5 - 1e-9, 0.5, 0.5, 0.999, 1.0, 1.0, 0.25,
                     0.25, 0.25, 0.75, 0.1], np.float64).reshape(3, 4)
    want = float(jd.shannon_entropy(vals))
    got = float(td.shannon_entropy(torch.tensor(vals)))
    np.testing.assert_allclose(got, want, rtol=1e-10)
    hist = np.histogram(vals, bins=256, range=(0.0, 1.0))[0]
    p = hist[hist > 0] / hist.sum()
    np.testing.assert_allclose(got, -np.sum(p * np.log2(p)), rtol=1e-10)
    for img in (_image(41, 37), np.full((5, 6), 0.3)):
        np.testing.assert_allclose(float(td.shannon_entropy(
            torch.tensor(img))), float(jd.shannon_entropy(img)), rtol=1e-10)


@pytest.mark.parametrize("mode", ["symmetric", "reflect", "edge", "wrap",
                                  "constant"])
def test_pad2d_is_numpy_pad(mode):
    """Every boundary mode, pads wider than the axis included (numpy
    repeats its reflections)."""
    x = np.arange(20, dtype=np.float32).reshape(4, 5)
    for rows, cols in (((1, 2), (2, 1)), ((6, 9), (7, 5))):
        np.testing.assert_array_equal(
            td.pad2d(torch.tensor(x), rows, cols, mode).numpy(),
            np.pad(x, (rows, cols), mode=mode))


def test_denoise_verbose_report_and_unknown_technique(capsys):
    x = _image(41, 37)
    ti.denoise(torch.tensor(x), "tvc", {}, verbose=True)
    got = capsys.readouterr().out
    ji.denoise(x, "tvc", {}, verbose=True)
    assert got == capsys.readouterr().out and "Peak-SNR" in got
    assert ti.denoise(torch.tensor(x), "sharpen", {}) is None
    assert "not implemented" in capsys.readouterr().out


def test_denoise_puts_numpy_input_on_the_card():
    """A numpy image goes to ``"cuda"`` by default, and raises where there
    is none; ``device="cpu"`` or a CPU tensor runs here."""
    x = _image(41, 37)
    assert ti.denoise(x, "median", {}, device="cpu").device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            ti.denoise(x, "median", {})


def test_package_exports_denoise():
    import gaussian_process_edge_trace_torch as gpt
    from gaussian_process_edge_trace_torch import utils
    assert gpt.denoise is ti.denoise and utils.denoise is ti.denoise
    assert "denoise" in gpt.__all__
