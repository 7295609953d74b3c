"""PyTorch port, ``trace/checkpoint.py``: save, load and resume of a trace's
state against the uninterrupted trace, across the two packages (the JAX
package's ``.npz`` layout and dtypes, its data fingerprint), and the
refusal of a changed config or image."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_process_edge_trace_torch import interop
from gaussian_process_edge_trace_torch.trace import checkpoint as pck
from gaussian_process_edge_trace_torch.trace import driver as pd
from gaussian_process_edge_trace_tpu.trace import checkpoint as rck
from gaussian_process_edge_trace_tpu.trace import driver as rd
from torch_parity import SMALL_KW, JaxDraws, assert_same_bits, small_problem

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def both():
    """The small config's data in both packages, the port's uninterrupted
    trace from its default draws and from the reference's."""
    _, edge, grad, init = small_problem()
    cfg = rd.make_config(init, grad.shape, **SMALL_KW)
    data = rd.make_data(cfg, jnp.asarray(grad), jnp.asarray(init))
    pcfg = pd.make_config(init, grad.shape, **SMALL_KW)
    pdata = pd.make_data(pcfg, grad, init, "cpu")
    return dict(cfg=cfg, data=data, pcfg=pcfg, pdata=pdata, grad=grad,
                init=init, full=pd.run_trace(pcfg, pdata,
                                             pd.init_state(pcfg, "cpu")))


def _two_steps(cfg, data, draws=None):
    state = pd.init_state(cfg, "cpu")
    for _ in range(2):
        state, _ = pd.trace_step(cfg, data, state, draws)
    return state


def _same_state(a, b):
    for f in pd.TraceState._fields:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), f
        else:
            assert type(x) is type(y) and x == y, f


def test_save_load_resume_is_the_uninterrupted_trace(both, tmp_path):
    """Two steps, then ``save_checkpoint`` / ``load_checkpoint`` and
    ``save_state`` / ``load_state``: the state comes back with the port's
    types, and ``resume_trace`` gives the uninterrupted trace bit for
    bit."""
    pcfg, pdata = both["pcfg"], both["pdata"]
    state = _two_steps(pcfg, pdata)
    assert state.it == 2
    p = tmp_path / "ckpt.npz"
    pck.save_checkpoint(p, pcfg, state, data=pdata)
    cfg, loaded = pck.load_checkpoint(p, expect_cfg=pcfg, data=pdata)
    assert cfg == pcfg
    _same_state(loaded, state)
    assert_same_bits(pck.resume_trace(cfg, pdata, loaded), both["full"])
    q = tmp_path / "state.npz"
    pck.save_state(q, state)
    _same_state(pck.load_state(q, device="cpu"), state)
    obs = pck.obs_from_result(both["full"])
    v = both["full"].obs_valid.numpy()
    np.testing.assert_array_equal(obs[:, 0], both["full"].obs_x.numpy()[v])
    assert obs.dtype == np.int64 and obs.shape == (int(v.sum()), 2)


def test_file_layout_is_the_reference_layout(both, tmp_path):
    """The same keys and dtypes as the JAX package's file of the same
    state, the config JSON equal, and the same data fingerprint."""
    cfg, data = both["cfg"], both["data"]
    rstate, _ = rd.trace_step(cfg, data, rd.init_state(cfg))
    rck.save_checkpoint(tmp_path / "ref.npz", cfg, rstate, data=data)
    pstate = _two_steps(both["pcfg"], both["pdata"])
    pck.save_checkpoint(tmp_path / "port.npz", both["pcfg"], pstate,
                        data=both["pdata"])
    with np.load(tmp_path / "ref.npz") as r, \
            np.load(tmp_path / "port.npz") as g:
        assert sorted(r.files) == sorted(g.files)
        for k in r.files:
            assert r[k].dtype == g[k].dtype and r[k].shape == g[k].shape, k
        assert str(r["__cfg__"]) == str(g["__cfg__"])
        assert str(r["__fingerprint__"]) == str(g["__fingerprint__"])
    assert pck.data_fingerprint(both["pdata"]) == rck.data_fingerprint(data)
    assert pck.cfg_to_json(both["pcfg"]) == rck.cfg_to_json(cfg)


def test_reference_checkpoint_resumes_in_the_port(both, tmp_path):
    """A checkpoint written by the JAX package after two of its steps loads
    in the port and, from the reference's draws, resumes to the JAX
    package's own uninterrupted pixels and n_iters; and the port's file
    loads in the JAX package."""
    cfg, data = both["cfg"], both["data"]
    state = rd.init_state(cfg)
    for _ in range(2):
        state, _ = rd.trace_step(cfg, data, state)
    p = tmp_path / "ref.npz"
    rck.save_checkpoint(p, cfg, state, data=data)
    full = jax.device_get(rd.run_trace(cfg, data, rd.init_state(cfg)))
    pcfg, pdata, _ = interop.from_reference(
        cfg._asdict(), jax.device_get(data._asdict()), None, device="cpu")
    lcfg, loaded = pck.load_checkpoint(p, expect_cfg=pcfg, data=pdata)
    assert loaded.it == 2 and loaded.obs_x.dtype == torch.int64
    res = pck.resume_trace(lcfg, pdata, loaded,
                           JaxDraws(pcfg, pdata.L_prior_unit.shape[1]))
    assert res.n_iters == int(full.n_iters)
    for f in ("obs_x", "obs_y", "obs_valid", "iter_nobs"):
        np.testing.assert_array_equal(getattr(res, f).numpy(),
                                      np.asarray(getattr(full, f)), f)
    q = tmp_path / "port.npz"
    pck.save_checkpoint(q, lcfg, loaded, data=pdata)
    rcfg, rstate = rck.load_checkpoint(q, expect_cfg=cfg, data=data)
    assert rcfg == cfg
    for f in pd.TraceState._fields:
        np.testing.assert_array_equal(np.asarray(getattr(rstate, f)),
                                      np.asarray(getattr(state, f)), f)


def test_mismatched_config_or_image_is_refused(both, tmp_path):
    """A changed config field, or an image with one pixel changed, raises
    ``ValueError``; without a recorded fingerprint the data is not
    checked."""
    pcfg, pdata = both["pcfg"], both["pdata"]
    state = _two_steps(pcfg, pdata)
    p = tmp_path / "ckpt.npz"
    pck.save_checkpoint(p, pcfg, state, data=pdata)
    with pytest.raises(ValueError, match="config mismatch"):
        pck.load_checkpoint(p, expect_cfg=pcfg._replace(N_samples=999),
                            device="cpu")
    grad = both["grad"].copy()
    grad[10, 20] += 0.5
    other = pd.make_data(pcfg, grad, both["init"], "cpu")
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        pck.load_checkpoint(p, data=other)
    q = tmp_path / "bare.npz"
    pck.save_checkpoint(q, pcfg, state)
    pck.load_checkpoint(q, data=other)
    with pytest.raises(ValueError, match="one trace"):
        pck.save_state(q, pd._lift(state))
