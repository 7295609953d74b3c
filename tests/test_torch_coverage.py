"""PyTorch port, the credible interval's coverage of the true edge on the
CPU: ``tests/test_e2e_parity.py``'s two calibration tests (:114 at 128²,
:156 at the README demo) with the JAX package's gates, marked ``slow`` as
the reference marks them; run with

    JAX_PLATFORMS=cpu python -m pytest -m slow tests/test_torch_coverage.py

At the demo the port's default draws hold the reference's gate on seed 1.
At 128² the reference's gate (0.78) was set for its own seed-1 stream
(which reads 0.906 today) and lies near the middle of the seed spread:
over tracer seeds 1-60 the port reads a median of 0.793 from the
reference's draws and 0.762 from its default draws, each seed from 0.37 to
0.98, and its default seed 1 reads 0.766. So there the gate holds the port
on the reference's own seed-1 draws, and the default draws are held to the
reference's draws' median over seeds 1-60, within 0.05 (this CPU read
them 0.031 apart)."""

import numpy as np
import pytest
import torch

import gaussian_process_edge_trace_torch as gpt
from gaussian_process_edge_trace_torch.trace import driver as pd

torch.set_num_threads(1)


def _coverage(lo, hi, true_y):
    return float(np.mean((true_y >= lo) & (true_y <= hi)))


def _small_case():
    img, edge = gpt.construct_test_img((128, 128), 40, 2, 0.02,
                                       "sinusoidal", 0.3, gaps=False)
    grad = gpt.comp_grad_img(img, gpt.kernel_builder((9, 5)), device="cpu")
    init = np.array([[0, edge[0, 0]], [127, edge[127, 0]]])
    return grad, init, edge[:128, 0]


def _small_trace(grad, init, seed, draws=None):
    """test_e2e_parity.py:114's config: RBF σf 30, ℓ 10, S = 256."""
    cfg = pd.make_config(init, grad.shape, {"kernel": "RBF", "sigma_f": 30,
                                            "length_scale": 10},
                         1, 0, 256, 0.5, 6, 0.1, 4, seed)
    data = pd.make_data(cfg, grad, init, device="cpu")
    if draws is not None:
        draws = draws(cfg, data.L_prior_unit.shape[1])
    return pd.run_trace(cfg, data, pd.init_state(cfg, device="cpu"), draws)


@pytest.mark.slow
def test_credible_interval_coverage():
    """At 128² the pixel-unit 95% interval covers at least 78% of the true
    edge's columns on the reference's seed-1 draws, and the reference-quirk
    interval (its std left in standardised units, gpet.py:266) covers less,
    as in the JAX package. The default draws' median coverage over tracer
    seeds 1-60 lies within 0.05 of the reference's draws' (see above)."""
    from torch_parity import JaxDraws
    grad, init, true_y = _small_case()
    res = _small_trace(grad, init, 1, JaxDraws)
    lo, hi = res.cred_interval_px.numpy()
    cov_px = _coverage(lo, hi, true_y)
    cov_quirk = _coverage(*res.cred_interval.numpy(), true_y)
    print(f"coverage 128², seed 1, the reference's draws: pixel-unit "
          f"{cov_px}, quirk {cov_quirk}")
    assert cov_px >= 0.78, cov_px
    assert cov_quirk < cov_px
    assert np.all(hi - lo > 0)
    medians = {}
    for name, draws in (("reference", JaxDraws), ("default", None)):
        medians[name] = float(np.median([_coverage(
            *_small_trace(grad, init, seed, draws).cred_interval_px.numpy(),
            true_y) for seed in range(1, 61)]))
    print(f"coverage 128², median over seeds 1-60: {medians}")
    assert abs(medians["default"] - medians["reference"]) < 0.05, medians


@pytest.mark.slow
def test_credible_interval_coverage_demo():
    """At the README demo config (500², gaps) the pixel-unit interval
    covers at least 85% of the true edge's columns."""
    img, edge = gpt.construct_test_img((500, 500), 200, 4, 0.05,
                                       "sinusoidal", 0.3, gaps=True)
    grad = gpt.comp_grad_img(img, gpt.kernel_builder((11, 5), unit=False),
                             device="cpu")
    tracer = gpt.GP_Edge_Tracing(
        edge[[0, -1]][:, [1, 0]], grad,
        {"kernel": "RBF", "sigma_f": 75, "length_scale": 20}, 1,
        np.array([]), 1000, 1, 5, 0.1, 5, 1, True, True, device="cpu")
    tracer()
    lo, hi = tracer.last_result.cred_interval_px.numpy()
    cov_px = _coverage(lo, hi, edge[:500, 0])
    print(f"coverage demo: pixel-unit {cov_px}")
    assert cov_px >= 0.85, cov_px
