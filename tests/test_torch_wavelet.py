"""PyTorch port, the wavelet denoiser (``utils/denoise_native.py::
denoise_wavelet``, its transforms and filter generators) against the JAX
package's functions on the CPU.

The same images, made from a numpy seed, go through both; sizes 48×40 and
41×37 hit even and odd axes (``test_torch_denoise.py`` holds the other
techniques). Tolerances, each relative to the largest magnitude of the JAX
output: the denoised images within 1e-5, one level's subbands within 1e-6
(the Haar pair bitwise), perfect reconstruction within 1e-6 absolute, the
filter tables within 1e-12. The wavelet references are the JAX function
under ``jax.jit``, its four threshold variants in one compiled program per
wavelet, level count and size (eager JAX compiles each of its slices on
first use).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_process_edge_trace_torch.utils import denoise_native as td
from gaussian_process_edge_trace_torch.utils import image as ti
from gaussian_process_edge_trace_tpu.utils import denoise_native as jd
from test_torch_denoise import SIZES, _close, _image

torch.set_num_threads(1)


WAVELETS = ["db1", "db2", "db4", "db8", "sym4", "sym8"]
VARIANTS = [(m, me) for m in ("soft", "hard")
            for me in ("BayesShrink", "VisuShrink")]


@functools.lru_cache(maxsize=None)
def _jax_wavelets(wavelet, levels, size):
    """The JAX function's four (mode, method) variants on the image of
    ``size`` (seed ``levels``), compiled as one program."""
    def four(x):
        return [jd.denoise_wavelet(x, wavelet=wavelet, wavelet_levels=levels,
                                   mode=m, method=me) for m, me in VARIANTS]
    outs = jax.device_get(jax.jit(four)(_image(*size, seed=levels)))
    return dict(zip(VARIANTS, outs))


@pytest.mark.parametrize("method", ["BayesShrink", "VisuShrink"])
@pytest.mark.parametrize("mode", ["soft", "hard"])
@pytest.mark.parametrize("levels", [1, 2, 3])
@pytest.mark.parametrize("wavelet", WAVELETS)
def test_denoise_wavelet_matches_reference(wavelet, levels, mode, method):
    """Every wavelet at levels 1-3, both threshold modes and both methods,
    on both sizes, within 1e-5 (the sigma estimate from the MAD of an
    even count included)."""
    kw = dict(wavelet=wavelet, wavelet_levels=levels, mode=mode,
              method=method)
    for size in SIZES:
        got = ti.denoise(torch.tensor(_image(*size, seed=levels)), "wavelet",
                         kw)
        _close(got, _jax_wavelets(wavelet, levels, size)[mode, method],
               1e-5)


@pytest.mark.parametrize("wavelet", WAVELETS + ["haar"])
def test_wave_dwt_matches_reference_and_reconstructs(wavelet):
    """One analysis level's four subbands against the JAX transform, and
    synthesis back to the input (perfect reconstruction), on both sizes."""
    for H, W in SIZES:
        x = _image(H, W)
        L = len(td._wavelet_filter(wavelet))
        if min(H, W) < L:
            continue
        ll, det, shape = td.wave_dwt2(torch.tensor(x), wavelet)
        jll, jdet, _ = jd.wave_dwt2(jnp.asarray(x), wavelet)
        for a, b in zip((ll,) + det, (jll,) + jdet):
            _close(a, b, 1e-6)
        rec = td.wave_idwt2(ll, det, shape, wavelet)
        np.testing.assert_allclose(rec.numpy(), x, atol=1e-6)


def test_haar_pair_matches_reference_and_reconstructs():
    for H, W in SIZES:
        x = _image(H, W)
        ll, det, shape = td.haar_dwt2(torch.tensor(x))
        jll, jdet, _ = jd.haar_dwt2(jnp.asarray(x))
        for a, b in zip((ll,) + det, (jll,) + jdet):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_allclose(td.haar_idwt2(ll, det, shape).numpy(), x,
                                   atol=1e-6)


@pytest.mark.parametrize("name", ["db0", "db17", "sym1", "sym17", "coif1",
                                  "bior1.3", "meyer"])
def test_unsupported_wavelets_are_refused(name):
    x = torch.tensor(_image(48, 40))
    for fn in (lambda: td.denoise_wavelet(x, wavelet=name),
               lambda: jd.denoise_wavelet(x.numpy(), wavelet=name)):
        with pytest.raises(NotImplementedError):
            fn()


def test_filter_generators_equal_reference_tables():
    """db1-db16 and sym2-sym16, the QMF highpass included, to 1e-12."""
    names = ([f"db{n}" for n in range(1, 17)]
             + [f"sym{n}" for n in range(2, 17)] + ["haar"])
    for name in names:
        h = td._wavelet_filter(name)
        np.testing.assert_allclose(h, jd._wavelet_filter(name), atol=1e-12,
                                   rtol=0)
        np.testing.assert_allclose(td._qmf(h), jd._qmf(h), atol=1e-12,
                                   rtol=0)
    for N in (4, 9, 16):
        np.testing.assert_allclose(np.sort_complex(td._halfband_roots(N)),
                                   np.sort_complex(jd._halfband_roots(N)),
                                   atol=1e-12)
