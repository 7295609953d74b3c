"""PyTorch port, the utilities: ``utils/profiling.py`` (``PhaseTimer``,
``trace_telemetry``, ``device_op_breakdown``, ``sync_timer``),
``utils/debug.py`` (the NaN check and ``assert_all_finite``),
``utils/selftest.py`` without a card, and ``models/gpr.py::
prior_grid_cholesky``, against the JAX package's functions where both have
one.

Tolerances: ``trace_telemetry`` of one result is the JAX function's dict
bit for bit, key by key; of the port's own trace from the reference's
draws, the trajectory test's bounds (integers equal, costs 1e-5 and
thresholds 1e-6 relative). ``prior_grid_cholesky``'s F Fᵀ is held to the
Gram within 1e-4 of its largest entry (a float32 eigendecomposition), and
to the JAX function's F Fᵀ within 2e-4.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_process_edge_trace_torch import interop
from gaussian_process_edge_trace_torch.models import gpr as pgpr
from gaussian_process_edge_trace_torch.models.kernels import KernelSpec
from gaussian_process_edge_trace_torch.trace import driver as pd
from gaussian_process_edge_trace_torch.utils import debug as pdebug
from gaussian_process_edge_trace_torch.utils import profiling as pprof
from gaussian_process_edge_trace_torch.utils import selftest as pself
from gaussian_process_edge_trace_tpu.models import gpr as rgpr
from gaussian_process_edge_trace_tpu.models.kernels import (
    KernelSpec as RefKernelSpec)
from gaussian_process_edge_trace_tpu.trace import driver as rd
from gaussian_process_edge_trace_tpu.utils import profiling as rprof
from torch_parity import SMALL_KW, JaxDraws, small_problem

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def traced():
    """The JAX package's trace of the small config, and the port's from
    the same data (``interop.from_reference``) and draws."""
    _, _, grad, init = small_problem()
    cfg = rd.make_config(init, grad.shape, **SMALL_KW)
    data = rd.make_data(cfg, jnp.asarray(grad), jnp.asarray(init))
    state0 = rd.init_state(cfg)
    ref = jax.device_get(rd.run_trace(cfg, data, state0))
    pcfg, pdata, pstate0 = interop.from_reference(
        cfg._asdict(), jax.device_get(data._asdict()),
        jax.device_get(state0._asdict()), device="cpu")
    got = pd.run_trace(pcfg, pdata, pstate0,
                       draws=JaxDraws(pcfg, pdata.L_prior_unit.shape[1]))
    return ref, got


def _as_port_result(ref):
    """The JAX result's arrays as the port's TraceResult (CPU tensors)."""
    return pd.TraceResult(**{
        k: (int(v) if k == "n_iters" else bool(v) if k == "converged"
            else torch.as_tensor(np.array(v)))
        for k, v in ref._asdict().items()})


def test_trace_telemetry_equals_reference_dict(traced):
    ref, _ = traced
    want = rprof.trace_telemetry(ref)
    got = pprof.trace_telemetry(_as_port_result(ref))
    assert list(got) == list(want)
    for k in want:
        assert type(got[k]) is type(want[k]) or isinstance(
            got[k], np.ndarray), k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_trace_telemetry_of_the_port_trace(traced):
    ref, got = traced
    want = rprof.trace_telemetry(ref)
    tel = pprof.trace_telemetry(got)
    assert tel["n_iters"] == want["n_iters"] >= 2
    assert tel["converged"] == want["converged"]
    np.testing.assert_array_equal(tel["n_obs"], want["n_obs"])
    np.testing.assert_allclose(tel["optimal_costs"], want["optimal_costs"],
                               rtol=1e-5)
    np.testing.assert_allclose(tel["score_thresholds"],
                               want["score_thresholds"], rtol=1e-6)


def test_phase_timer_reports_as_reference():
    """The same phases and calls give the JAX class's report keys and
    counts; the totals are each class's own wall clock."""
    timers = pprof.PhaseTimer(), rprof.PhaseTimer()
    for t in timers:
        for name in ("fit", "score", "fit"):
            with t.phase(name):
                time.sleep(0.002)
    got, want = (t.report() for t in timers)
    assert list(got) == list(want) == ["fit", "score"]
    for k in want:
        assert got[k]["calls"] == want[k]["calls"]
        assert set(got[k]) == set(want[k])
        assert got[k]["total_s"] >= 0.002 * got[k]["calls"]
        assert got[k]["mean_s"] == pytest.approx(got[k]["total_s"]
                                                 / got[k]["calls"])
    with pytest.raises(ValueError):
        with timers[0].phase("boom"):
            raise ValueError
    assert timers[0].report()["boom"]["calls"] == 1


def test_device_op_breakdown_runs_on_the_cpu(tmp_path):
    """Without a card the rows are the CPU operators' self time, sorted,
    at most ``top``; the Chrome trace is kept where asked."""
    a = torch.randn(64, 64)
    rows = pprof.device_op_breakdown(lambda x: (x @ x).relu().sum(), a,
                                     top=5, log_dir=tmp_path)
    assert 0 < len(rows) <= 5
    assert all(isinstance(ms, float) and ms >= 0 for ms, _ in rows)
    assert [r[0] for r in rows] == sorted((r[0] for r in rows),
                                          reverse=True)
    assert any("mm" in name for _, name in rows)
    assert (tmp_path / "trace.json").exists()


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with pprof.device_trace(tmp_path / "prof"):
        torch.randn(32, 32).sum()
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0


def test_sync_timer_and_selftest_need_a_card():
    """Both time or check the card and refuse to stand in for it on the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal")
    with pytest.raises(RuntimeError, match="CUDA"):
        pprof.sync_timer(lambda: None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pself.run_selftest()


def test_debug_nans_raises_and_restores():
    """Inside the block a NaN raises ``FloatingPointError`` naming the op;
    after it, also after a raise, NaNs pass again; ``enable_debug`` turns
    the check on and off globally."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode
    neg = torch.tensor(-1.0)
    assert _get_current_dispatch_mode() is None
    with pytest.raises(FloatingPointError, match="log"):
        with pdebug.debug_nans():
            torch.log(neg) / torch.log(neg)
    assert _get_current_dispatch_mode() is None
    assert torch.isnan(torch.log(neg))
    with pdebug.debug_nans():
        assert float(torch.exp(neg)) > 0        # finite ops pass
    pdebug.enable_debug()
    try:
        assert pdebug._global_mode is not None
        with pytest.raises(FloatingPointError):
            torch.sqrt(neg)
    finally:
        pdebug.enable_debug(False)
    assert pdebug._global_mode is None and torch.isnan(torch.sqrt(neg))


def test_assert_all_finite_names_the_field(traced):
    _, got = traced
    pdebug.assert_all_finite(got)
    pdebug.assert_all_finite({"a": np.ones(3), "b": (torch.zeros(2), 1.5),
                              "n": np.array([1, 2])})
    bad = got._replace(y_mean=got.y_mean.clone())
    bad.y_mean[3] = float("nan")
    with pytest.raises(FloatingPointError, match=r"result\.y_mean"):
        pdebug.assert_all_finite(bad)
    with pytest.raises(FloatingPointError, match=r"res\['b'\]\[1\]"):
        pdebug.assert_all_finite({"a": 1.0, "b": (torch.ones(1),
                                                  float("inf"))}, "res")


@pytest.mark.parametrize("kernel,E,ls", [("RBF", 60, 8.0),
                                         ("Matern", 45, 5.0)])
def test_prior_grid_cholesky_matches_reference(kernel, E, ls):
    spec = KernelSpec(kernel, 2.5)
    ref_spec = RefKernelSpec(kernel, 2.5)
    grid = np.arange(E, dtype=np.float32)
    F = pgpr.prior_grid_cholesky(spec, torch.tensor(grid), ls)
    Fr = np.asarray(rgpr.prior_grid_cholesky(ref_spec, jnp.asarray(grid),
                                             ls))
    K = pgpr.cross_gram(spec, torch.tensor(grid), torch.tensor(grid), ls,
                        1.0).numpy()
    FF = (F @ F.T).numpy()
    scale = np.abs(K).max()
    assert F.shape == (E, E) and F.dtype == torch.float32
    assert np.abs(FF - K).max() <= 1e-4 * scale
    assert np.abs(FF - Fr @ Fr.T).max() <= 2e-4 * scale
