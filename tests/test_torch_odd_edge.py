"""PyTorch port, an odd edge length: the small config's image cut to 95
columns, so E = 95 and every iteration scores its curves on the unfused
path (K2's interpolation, then the Simpson sums with their even-count
tails), traced by the JAX package and by the port from the same draws."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_process_edge_trace_torch import interop
from gaussian_process_edge_trace_torch.trace import driver as pd
from gaussian_process_edge_trace_torch.trace import scoring
from gaussian_process_edge_trace_tpu.trace import driver as rd
from torch_parity import SMALL_IMG, SMALL_KW, JaxDraws, small_problem

torch.set_num_threads(1)

ODD_IMG = dict(SMALL_IMG, size=(64, 95))


@pytest.mark.parametrize("legacy_simpson", [False, True])
def test_odd_edge_trajectory_matches_reference(legacy_simpson, monkeypatch):
    """Given the reference's draws the port accepts the same pixels in the
    same iterations with the same per-iteration observation counts, and the
    optimal curve's cost per iteration agrees to 1e-5 relative (f32 sums in
    other orders), with the modern Simpson tail and with the historical
    ``even='avg'`` rule. Every cost took the unfused branch: the fused cost
    (K1's plain version on the CPU) never ran, and the interpolation ran
    once per iteration and once for the final cost."""
    calls = {"fused": 0, "interp": 0}

    def no_fused(*args, **kwargs):
        calls["fused"] += 1
        raise AssertionError("the fused cost cannot take an odd E")

    def counted(*args, **kwargs):
        calls["interp"] += 1
        return interp(*args, **kwargs)
    interp = scoring.column_interp
    monkeypatch.setattr(scoring, "fused_curve_cost", no_fused)
    monkeypatch.setattr(scoring, "column_interp", counted)

    _, _, grad, init = small_problem(ODD_IMG)
    kw = dict(SMALL_KW, legacy_simpson=legacy_simpson)
    cfg = rd.make_config(init, grad.shape, **kw)
    assert cfg.x_en - cfg.x_st + 1 == 95
    data = rd.make_data(cfg, jnp.asarray(grad), jnp.asarray(init))
    state0 = rd.init_state(cfg)
    ref = jax.device_get(rd.run_trace(cfg, data, state0))
    pcfg, pdata, pstate0 = interop.from_reference(
        cfg._asdict(), jax.device_get(data._asdict()),
        jax.device_get(state0._asdict()), device="cpu")
    assert pcfg.legacy_simpson == legacy_simpson
    got = pd.run_trace(pcfg, pdata, pstate0,
                       draws=JaxDraws(pcfg, pdata.L_prior_unit.shape[1]))
    assert got.n_iters == int(ref.n_iters) >= 2
    for f in ("obs_x", "obs_y", "obs_valid", "iter_nobs"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    np.testing.assert_allclose(got.iter_costs.numpy(), ref.iter_costs,
                               rtol=1e-5)
    assert got.edge_trace.shape == (95, 2)
    assert calls == {"fused": 0, "interp": got.n_iters + 1}
