"""PyTorch port, the constructors' call forms: ``frame_arrays``,
``make_data``, ``init_state`` and ``make_batch_state`` take the JAX
package's parameters in its order, then a keyword ``device`` (by default
that of a tensor input, else the card); the port's earlier form, with the
device in the second place of ``init_state`` and the third of
``make_batch_state``, still works and gives identical tensors."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_process_edge_trace_torch.parallel import make_batch_state
from gaussian_process_edge_trace_torch.trace import driver as pd
from gaussian_process_edge_trace_tpu.trace import driver as rd
from torch_parity import SMALL_KW, small_problem

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def small():
    _, edge, grad, init = small_problem()
    obs = np.array([[30, edge[30, 0]], [60, edge[60, 0]]])
    cfg = pd.make_config(init, grad.shape, n_user_obs=2, **SMALL_KW)
    return dict(grad=grad, init=init, obs=obs, cfg=cfg,
                cold=pd.make_config(init, grad.shape, **SMALL_KW))


def _same(a, b):
    """Two NamedTuples (or tuples) of tensors and ints, equal field by
    field: values, dtypes and devices."""
    assert type(a) is type(b) and len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.device == y.device
            assert torch.equal(x, y)
        else:
            assert x == y


def test_frame_arrays_and_make_data_forms(small):
    cfg, grad, init = small["cold"], small["grad"], small["init"]
    _same(pd.frame_arrays(cfg, grad, init, device="cpu"),
          pd.frame_arrays(cfg, grad, init, "cpu"))
    data = pd.make_data(cfg, grad, init, device="cpu")
    _same(data, pd.make_data(cfg, grad, init, "cpu"))
    # A tensor input decides where the rest goes.
    _same(pd.make_data(cfg, torch.tensor(grad), init), data)
    assert data.grad_img.device.type == "cpu"


def test_init_state_forms(small):
    """The reference's ``init_state(cfg)``, ``init_state(cfg, xy)`` and
    ``init_state(cfg, xy, valid)`` with ``device="cpu"`` against the port's
    ``init_state(cfg, "cpu", ...)``, and a warm start that is a tensor
    placing the state on its device. Its integers are the JAX package's."""
    cold, warm, obs = small["cold"], small["cfg"], small["obs"]
    _same(pd.init_state(cold, device="cpu"), pd.init_state(cold, "cpu"))
    _same(pd.init_state(cold, device=torch.device("cpu")),
          pd.init_state(cold, torch.device("cpu")))
    ref_form = pd.init_state(warm, obs, device="cpu")
    _same(ref_form, pd.init_state(warm, "cpu", obs))
    _same(ref_form, pd.init_state(warm, "cpu", user_obs_xy=obs))
    _same(ref_form, pd.init_state(warm, user_obs_xy=obs, device="cpu"))
    _same(ref_form, pd.init_state(warm, torch.as_tensor(obs)))
    valid = np.array([True, False])
    masked = pd.init_state(warm, obs, valid, device="cpu")
    _same(masked, pd.init_state(warm, "cpu", obs, valid))
    assert int(masked.n_fobs) == 1 and int(ref_form.n_fobs) == 2
    rcfg = rd.make_config(small["init"], small["grad"].shape, n_user_obs=2,
                          **SMALL_KW)
    ref = rd.init_state(rcfg, jnp.asarray(obs), jnp.asarray(valid))
    for f in ("user_x", "user_y", "user_valid", "n_fobs", "obs_valid"):
        np.testing.assert_array_equal(getattr(masked, f).numpy(),
                                      np.asarray(getattr(ref, f)),
                                      err_msg=f)
    with pytest.raises(TypeError, match="two devices"):
        pd.init_state(warm, "cpu", obs, device="cpu")


def test_make_batch_state_forms(small):
    cold, warm, obs = small["cold"], small["cfg"], small["obs"]
    _same(make_batch_state(cold, 3, device="cpu"),
          make_batch_state(cold, 3, "cpu"))
    xy = np.stack([obs, obs + [[1, 2], [3, 4]]])
    ref_form = make_batch_state(warm, 2, xy, device="cpu")
    _same(ref_form, make_batch_state(warm, 2, "cpu", xy))
    _same(ref_form, make_batch_state(warm, 2, "cpu", user_obs_xy=xy))
    _same(ref_form, make_batch_state(warm, 2, torch.as_tensor(xy)))
    assert ref_form.it.tolist() == [0, 0]
    for f in range(2):
        one = pd.init_state(warm, xy[f], device="cpu")
        for k in pd.TraceState._fields:
            if k != "it":
                assert torch.equal(getattr(ref_form, k)[f], getattr(one, k))


def test_reference_forms_default_to_the_card(small):
    """Without a device and without a tensor input the constructors go to
    the card: with none they raise, and nothing runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal")
    cold, grad, init = small["cold"], small["grad"], small["init"]
    for call in (lambda: pd.init_state(cold),
                 lambda: pd.init_state(small["cfg"], small["obs"]),
                 lambda: pd.make_data(cold, grad, init),
                 lambda: pd.frame_arrays(cold, grad, init),
                 lambda: make_batch_state(cold, 2)):
        with pytest.raises((RuntimeError, AssertionError)):
            call()
