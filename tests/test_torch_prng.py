"""PyTorch port, ``ops/prng.py`` and the default draws: the port's copy of
the JAX package's random stream against ``jax.random`` on the CPU.

Keys, bits and uniforms are held bit for bit; so are the float32 normals,
over every one of the 2²³ uniforms the transform can see (XLA's CPU
``erf_inv`` and ``log1p`` reproduced with their fused multiply-adds). The
float64 normals of the sklearn-style GPR go through ``torch.special.erfinv``
where XLA has its own float64 ``erf_inv``: they agree to 1e-11 relative
(measured at most 1.5e-12 over 3·10⁵ draws, about 42% equal in every bit).
Then every derivation of the JAX package's call sites, and whole traces
with the port's default draws, nothing injected, against the JAX package's
at the same seed."""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussian_process_edge_trace_torch as gpt
from gaussian_process_edge_trace_torch import interop
from gaussian_process_edge_trace_torch.models import sklearn_api as P
from gaussian_process_edge_trace_torch.ops import prng
from gaussian_process_edge_trace_torch.parallel import sharded as ps
from gaussian_process_edge_trace_torch.trace import driver as pd
from gaussian_process_edge_trace_tpu.models import sklearn_api as R
from gaussian_process_edge_trace_tpu.models.tracer import (
    GP_Edge_Tracing as RefTracer)
from gaussian_process_edge_trace_tpu.parallel import sharded as rs
from gaussian_process_edge_trace_tpu.trace import driver as rd
from torch_parity import (SMALL_KW, JaxDraws, JaxKeyDraws,
                          assert_results_match, assert_same_bits,
                          small_problem)

torch.set_num_threads(1)

F64_NORMAL_RTOL = 1e-11


def _key(k):
    return tuple(int(v) for v in np.asarray(k))


def _u32(t):
    return np.asarray(t.numpy(), np.int64).astype(np.uint32)


SEEDS_64 = [0, 1, 2 ** 31 - 1, 2 ** 32, 2 ** 32 + 5, 2 ** 63 - 1, -1,
            -2 ** 63]


@pytest.mark.parametrize("seed", SEEDS_64)
def test_prng_key_matches_jax(seed):
    """The tracer's keys are ``PRNGKey`` as the JAX package runs it, with
    x64 off: (0, seed mod 2³²) (the tests' conftest turns x64 on)."""
    with jax.enable_x64(False):
        ref = _key(jax.random.PRNGKey(seed))
    assert prng.prng_key(seed) == ref == (0, seed % 2 ** 32)


@pytest.mark.parametrize("seed", SEEDS_64)
def test_prng_key_x64_matches_jax_with_x64(seed):
    """The sklearn-style GPR's keys are ``PRNGKey`` with x64 on, the
    JAX package's float64 path; in [0, 2³²) both key functions agree."""
    with jax.enable_x64(True):
        ref = _key(jax.random.PRNGKey(seed))
    assert prng.prng_key_x64(seed) == ref
    assert (prng.prng_key_x64(seed) == prng.prng_key(seed)) == (
        0 <= seed < 2 ** 32)


@pytest.mark.parametrize("seed,chain", [(0, (0,)), (1, (1, 2, 3)),
                                        (7, (2 ** 32 - 1, 0, 41)),
                                        (2 ** 31 - 1, (5, 5))])
def test_fold_in_chains_match_jax(seed, chain):
    key, ref = prng.prng_key(seed), jax.random.PRNGKey(seed)
    for d in chain:
        key, ref = prng.fold_in(key, d), jax.random.fold_in(ref, d)
        assert key == _key(ref)


@pytest.mark.parametrize("n", [2, 3, 8])
def test_split_matches_jax(n):
    base = jax.random.fold_in(jax.random.PRNGKey(3), 9)
    got = prng.split(_key(base), n)
    assert [tuple(k) for k in got] == [_key(k) for k in
                                       jax.random.split(base, n)]


def test_fold_in_and_seed_bounds_raise():
    """A seed outside [-2⁶³, 2⁶³) raises ``OverflowError`` in either mode,
    as ``jax.random.PRNGKey`` does."""
    with pytest.raises(ValueError, match="fold_in"):
        prng.fold_in((0, 1), 2 ** 32)
    for seed in (2 ** 63, -2 ** 63 - 1, 2 ** 64):
        for x64 in (False, True):
            with jax.enable_x64(x64), pytest.raises(OverflowError):
                jax.random.PRNGKey(seed)
        for key in (prng.prng_key, prng.prng_key_x64):
            with pytest.raises(OverflowError, match="64-bit"):
                key(seed)


@pytest.mark.parametrize("shape", [(60, 1000), (13, 3), (7, 33), (1, 1)])
def test_random_bits_match_jax(shape):
    key = jax.random.fold_in(jax.random.PRNGKey(1), 4)
    ref = np.asarray(jax.random.bits(key, shape, jnp.uint32))
    np.testing.assert_array_equal(_u32(prng.random_bits(_key(key), shape)),
                                  ref)


@pytest.mark.parametrize("bounds", [(0.0, 1.0), (prng.NORMAL_LO, 1.0),
                                    (-3.0, 5.0)])
def test_uniform_matches_jax(bounds):
    """``[0, 1)`` for the restarts and ``[nextafter(-1, 0), 1)``, the
    bounds ``_normal_real`` passes; both products are exact, and so is a
    general interval whose width is a power of two."""
    key = jax.random.PRNGKey(11)
    ref = np.asarray(jax.random.uniform(key, (40, 301), jnp.float32,
                                        *bounds))
    got = prng.uniform(_key(key), (40, 301), *bounds).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize("seed,shape", [(1, (60, 1000)), (2, (33, 257)),
                                        (2 ** 31 - 1, (8, 2)),
                                        (2 ** 32 + 5, (3, 7, 11))])
def test_normal_matches_jax(seed, shape):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    ref = np.asarray(jax.random.normal(key, shape, jnp.float32))
    got = prng.normal(_key(key), shape).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


def test_normal_transform_matches_jax_on_every_uniform():
    """The uniform -> normal map depends on the 23 bits ``bits >> 9``
    alone; all 2²³ of them give XLA's normals bit for bit."""
    mant = np.arange(2 ** 23, dtype=np.uint32) << 9
    lo = np.float32(prng.NORMAL_LO)

    @jax.jit
    def ref_fn(bits):
        f = jax.lax.bitcast_convert_type(
            (bits >> 9) | np.uint32(0x3F800000), jnp.float32) - 1.0
        u = jax.lax.max(lo, f * (np.float32(1.0) - lo) + lo)
        return np.float32(np.sqrt(2)) * jax.lax.erf_inv(u)
    ref = np.asarray(ref_fn(jnp.asarray(mant)))
    f = prng._unit_from_bits(torch.from_numpy(mant.astype(np.int64)))
    u = torch.maximum(torch.tensor(lo), f * 2.0 + lo)
    got = (prng._xla_erf_inv(u) * prng._SQRT2).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize("shape,cols", [((60, 1000), slice(250, 500)),
                                        ((9, 257), slice(0, 129)),
                                        ((9, 257), slice(128, 257)),
                                        ((4, 10), slice(9, 10))])
def test_column_windows_are_the_full_draws_columns(shape, cols):
    key = prng.fold_in(prng.prng_key(5), 2)
    full = prng.normal(key, shape)
    torch.testing.assert_close(prng.normal(key, shape, cols), full[:, cols],
                               rtol=0, atol=0)
    assert torch.equal(prng.random_bits(key, shape, cols),
                       prng.random_bits(key, shape)[:, cols])


def test_fma32_rounds_once():
    """The emulated fused multiply-add is the float32 nearest the exact
    a·b + c (exact rational arithmetic decides), also where the float64
    sum alone would round twice."""
    from fractions import Fraction
    for av, bv, cv in [(1.0 + 2 ** -23, 1.0 + 2 ** -23, -1.0),
                       (3.0, 1.0 / 3.0, -1.0), (1e-3, 7.0, 2.5),
                       (1.0 + 2 ** -12, 1.0 + 2 ** -12, 2 ** 25)]:
        a = torch.tensor([av], dtype=torch.float32)
        b = torch.tensor([bv], dtype=torch.float32)
        c = torch.tensor([cv], dtype=torch.float32)
        exact = (Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c)))
        got = float(prng.fma32(a, b, c))
        below = np.nextafter(np.float32(got), np.float32(-np.inf))
        above = np.nextafter(np.float32(got), np.float32(np.inf))
        err = abs(Fraction(got) - exact)
        assert err <= abs(Fraction(float(below)) - exact)
        assert err <= abs(Fraction(float(above)) - exact)


# --------------------------------------------------- the call sites' keys --

@pytest.fixture(scope="module")
def small():
    """The small config in both packages, from the same data."""
    _, edge, grad, init = small_problem()
    cfg = rd.make_config(init, grad.shape, **SMALL_KW)
    data = rd.make_data(cfg, jnp.asarray(grad), jnp.asarray(init))
    state0 = rd.init_state(cfg)
    pcfg, pdata, pstate0 = interop.from_reference(
        cfg._asdict(), jax.device_get(data._asdict()),
        jax.device_get(state0._asdict()), device="cpu")
    return dict(cfg=cfg, data=data, state0=state0, pcfg=pcfg, pdata=pdata,
                pstate0=pstate0, rank=pdata.L_prior_unit.shape[1], edge=edge,
                grad=grad, init=init)


def _bits_equal(a, b):
    np.testing.assert_array_equal(a.numpy().view(np.uint32),
                                  b.numpy().view(np.uint32))


@pytest.mark.parametrize("it", [0, 1, 7, 47])
def test_iteration_draws_are_the_jax_packages(small, it):
    """``fold_in(PRNGKey(seed), it + 1)`` split into the prior and noise
    keys (driver.py:394, gpr.py:208,233,238)."""
    pcfg, rank = small["pcfg"], small["rank"]
    for got, ref in zip(pd.StreamDraws(pcfg, rank, "cpu").normals(it),
                        JaxDraws(pcfg, rank).normals(it)):
        _bits_equal(got, ref)


def test_restart_draws_are_the_jax_packages(small):
    """``uniform(fold_in(PRNGKey(seed), 0), (lml_restarts, 3))``
    (driver.py:590,639-640)."""
    pcfg, rank = small["pcfg"], small["rank"]
    _bits_equal(pd.StreamDraws(pcfg, rank, "cpu").restarts(),
                JaxDraws(pcfg, rank).restarts())


@pytest.mark.parametrize("seed", [0, 1, 5])
def test_unfolded_key_draws_are_the_jax_packages(small, seed):
    """``fit_predict_GP(seed=k)`` and ``preview_samples`` take
    ``PRNGKey(k)`` unfolded (models/tracer.py:158, driver.py:720)."""
    pcfg, rank = small["pcfg"], small["rank"]
    got = pd.KeyDraws(pcfg, rank, "cpu", seed)
    ref = JaxKeyDraws(pcfg, rank, jax.random.PRNGKey(seed))
    for a, b in zip(got.sample_normals(pcfg.n_train + 3),
                    ref.sample_normals(pcfg.n_train + 3)):
        _bits_equal(a, b)
    _bits_equal(got.restarts(), ref.restarts())


def test_preview_samples_match_the_jax_package(small):
    """``preview_samples`` with the default draws (``PRNGKey(0)``) against
    the JAX package's, to float32 rounding of the sampling round."""
    ref = np.asarray(rd.preview_samples(small["cfg"], small["data"],
                                        small["state0"]))
    got = pd.preview_samples(small["pcfg"], small["pdata"], small["pstate0"])
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("seed", [0, 3])
def test_fit_predict_gp_samples_match_the_jax_package(small, seed):
    _, _, grad, init = small_problem()
    args = (init, grad, SMALL_KW["kernel_options"], 1, np.array([]), 256, 1,
            6, 0.1, 4, 1, False, True)
    obs = np.array([[10, 20], [40, 25]])
    ref = np.asarray(RefTracer(*args).fit_predict_GP(obs, seed=seed))
    got = gpt.GP_Edge_Tracing(*args, device="cpu").fit_predict_GP(
        obs, seed=seed)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("k", [1, 4])
def test_ensemble_member_draws_are_the_jax_packages(small, k):
    """Member k draws ``PRNGKey(seed + k)`` (sharded.py:127)."""
    pcfg, rank = small["pcfg"], small["rank"]
    member = pd.StreamDraws(pcfg, rank, "cpu", seed=pcfg.seed + k)
    ref = JaxDraws(pcfg._replace(seed=pcfg.seed + k), rank)
    for a, b in zip(member.normals(2), ref.normals(2)):
        _bits_equal(a, b)
    _bits_equal(member.restarts(), ref.restarts())


@pytest.mark.parametrize("seed", [2 ** 32 - 2, -3])
def test_ensemble_members_past_two_to_the_32_are_the_shipped_packages(
        small, seed):
    """Members k = 0-4 of an ensemble at ``seed``, whose ``seed + k``
    crosses 2³² (or 0), draw ``PRNGKey(seed + k)`` as the shipped JAX
    package keys it (x64 off): :class:`FrameDraws` of the port's sources
    (one table of all five members' draws) against :class:`FrameDraws` of
    the JAX package's own draws (stacked one by one), columns too."""
    pcfg, rank = small["pcfg"], small["rank"]
    frames = pd.FrameDraws([pd.StreamDraws(pcfg, rank, "cpu", seed=seed + k)
                            for k in range(5)])
    with jax.enable_x64(False):
        shipped = pd.FrameDraws([JaxDraws(pcfg._replace(seed=seed + k), rank)
                                 for k in range(5)])
    assert frames.tabled and not shipped.tabled
    for cols in ((), (slice(64, 192),)):
        for a, b in zip(frames.normals(3, *cols), shipped.normals(3, *cols)):
            _bits_equal(a, b)
    _bits_equal(frames.restarts(), shipped.restarts())


def _ensemble_table():
    keys = [prng.split(prng.fold_in(prng.prng_key(7 + k), 4))
            for k in range(5)]
    return [prng.Draw("normal", kk[part], (rows, 300), slice(40, 260))
            for kk in keys for part, rows in ((0, 6), (1, 11))]


@pytest.mark.parametrize("table", [
    [prng.Draw("normal", (3, 4), (6, 300)),
     prng.Draw("normal", (5, 6), (11, 300), slice(150, 300)),
     prng.Draw("uniform", (7, 8), (12, 3)),
     prng.Draw("uniform", (9, 10), (5, 40), slice(3, 29), -3.0, 5.0),
     prng.Draw("bits", (11, 12), (2, 3, 50), slice(7, 8))],
    _ensemble_table()], ids=["mixed", "ensemble_K5"])
def test_draw_table_is_its_draws(table):
    """The plain version of a table equals each draw's own plain version,
    returned or written into a stacked tensor's frames (the layout
    ``FrameDraws`` gives the kernel), column windows included."""
    got = prng.draw(table)
    for d, g in zip(table, got):
        assert torch.equal(g, prng.draw_plain(d))
        one = {"normal": prng.normal(d.key, d.shape, d.cols),
               "uniform": prng.uniform(d.key, d.shape, d.minval, d.maxval,
                                       d.cols),
               "bits": prng.random_bits(d.key, d.shape, d.cols)}[d.mode]
        assert torch.equal(g, one)
    if all(d.shape == table[0].shape for d in table[::2]):
        stacks = [prng.empty(d, "cpu", lead=(len(table) // 2,))
                  for d in table[:2]]
        prng.draw(table, out=[s[k] for k in range(len(table) // 2)
                              for s in stacks])
        for i, d in enumerate(table):
            assert torch.equal(stacks[i % 2][i // 2], got[i])


# ---------------- properties the draws keep (carried from the old layout) --

def test_consecutive_seeds_share_no_normals(small):
    pcfg, rank = small["pcfg"], small["rank"]
    z = [pd.StreamDraws(pcfg, rank, "cpu", seed=s).normals(it)[0]
         for s in (1, 2, 3) for it in (0, 1)]
    assert all(not torch.equal(z[a], z[b]) for a in range(len(z))
               for b in range(a))


def test_member_zero_is_the_single_trace_source(small):
    pcfg, rank = small["pcfg"], small["rank"]
    mine = pd.StreamDraws(pcfg, rank, "cpu", seed=pcfg.seed)
    default = pd._default_draws(pcfg, small["pdata"])
    for a, b in zip(mine.normals(3), default.normals(3)):
        assert torch.equal(a, b)
    assert torch.equal(mine.restarts(), default.restarts())


def test_stream_columns_are_the_full_draws_columns(small):
    pcfg, rank = small["pcfg"], small["rank"]
    d = pd.StreamDraws(pcfg, rank, "cpu")
    full = d.normals(2)
    for part, whole in zip(d.normals(2, slice(64, 192)), full):
        assert torch.equal(part, whole[:, 64:192])


def test_a_seeds_draws_repeat(small):
    pcfg, rank = small["pcfg"], small["rank"]
    a = pd.StreamDraws(pcfg, rank, "cpu")
    b = pd.StreamDraws(pcfg, rank, "cpu")
    for x, y in zip(a.normals(5), b.normals(5)):
        assert torch.equal(x, y)
    assert torch.equal(pd.KeyDraws(pcfg, rank, "cpu", 9).restarts(),
                       pd.KeyDraws(pcfg, rank, "cpu", 9).restarts())


def test_no_limits_on_seed_member_or_iterations(small):
    """The JAX stream has no packing limits: an iteration past 1022 draws
    its own normals. A seed past 2³² keys as the shipped JAX package keys
    it, seed mod 2³², so seed 2³² + 1 draws seed 1's normals."""
    pcfg, rank = small["pcfg"], small["rank"]
    far = pd.StreamDraws(pcfg, rank, "cpu", seed=2 ** 32 + 1)
    near = pd.StreamDraws(pcfg, rank, "cpu", seed=1)
    assert torch.equal(far.normals(0)[0], near.normals(0)[0])
    with jax.enable_x64(False):
        shipped = JaxDraws(pcfg._replace(seed=2 ** 32 + 1), rank)
    _bits_equal(far.normals(0)[0], shipped.normals(0)[0])
    z = [near.normals(it)[0] for it in (1021, 1022, 1099)]
    assert not torch.equal(z[0], z[1]) and not torch.equal(z[1], z[2])
    _bits_equal(z[2], JaxDraws(pcfg, rank).normals(1099)[0])


# ------------------------------------------------------ the sklearn GPR --

def _gprs(**kw):
    def kernel(M):
        return (M.ConstantKernel(4.0, "fixed") * M.RBF(1.5, "fixed")
                + M.WeightedWhiteKernel(noise_weight=1.0, noise_level=0.05))
    rng = np.random.RandomState(0)
    X = np.sort(rng.uniform(0, 10, 14)).reshape(-1, 1)
    y = np.sin(X[:, 0]) * 3 + rng.normal(0, 0.1, 14)
    return (P.GaussianProcessRegressor(kernel=kernel(P), device="cpu",
                                       **kw).fit(X, y),
            R.GaussianProcessRegressor(kernel=kernel(R), **kw).fit(X, y))


@pytest.mark.parametrize("random_state", [0, 1, 12])
def test_sklearn_sample_y_is_the_jax_packages_draw(random_state):
    """``sample_y(random_state=k)`` splits ``PRNGKey(k)`` as the JAX
    package's does (sklearn_api.py:428-475): the same draws within the
    float64 normals' bound."""
    ours, ref = _gprs(alpha=1e-8, optimizer=None)
    Xq = np.linspace(0, 10, 25)
    got = ours.sample_y(Xq, n_samples=60, random_state=random_state)
    want = np.asarray(ref.sample_y(Xq, n_samples=60,
                                   random_state=random_state))
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


def test_sklearn_prior_draws_are_the_jax_packages():
    """Before ``fit``: the prior's normals are those of the unfolded key
    (sklearn_api.py:477-478). The eigenvectors of the prior covariance are
    not unique, so the draw is rebuilt from the port's own factor and the
    JAX package's normals."""
    gp = P.GaussianProcessRegressor(
        kernel=P.ConstantKernel(4.0, "fixed") * P.RBF(1.5, "fixed"),
        optimizer=None, device="cpu")
    Xq = np.arange(5.0)
    got = gp.sample_y(Xq, n_samples=40, random_state=3)
    mean, cov = gp.predict(Xq, return_cov=True)
    w, V = torch.linalg.eigh(torch.as_tensor(cov, dtype=torch.float64))
    Fq = (V * torch.sqrt(torch.clamp(w, min=0.0))[None, :]).numpy()
    z = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (5, 40),
                                     jnp.float64))
    np.testing.assert_allclose(got, mean[:, None] + Fq @ z, rtol=1e-9,
                               atol=1e-9)


def test_sklearn_restarts_are_the_jax_packages():
    """The float64 restart uniforms of ``PRNGKey(random_state)``
    (sklearn_api.py:319-321), exactly."""
    for s in (0, 4):
        np.testing.assert_array_equal(
            prng.uniform64_plain(prng.prng_key(s), (8, 3)).numpy(),
            np.asarray(jax.random.uniform(jax.random.PRNGKey(s), (8, 3),
                                          jnp.float64)))


@pytest.mark.parametrize("seed", [0, 1, 2 ** 31 - 1])
def test_float64_normals_within_the_stated_bound(seed):
    key = jax.random.PRNGKey(seed)
    ref = np.asarray(jax.random.normal(key, (200, 300), jnp.float64))
    got = prng.normal64_plain(_key(key), (200, 300)).numpy()
    np.testing.assert_allclose(got, ref, rtol=F64_NORMAL_RTOL, atol=0)


# ----------------------------------------------- whole traces, no injection --

@pytest.fixture(scope="module")
def batched_reference():
    """The JAX package's final fit on its batched path, as the port's
    (the JAX package takes its unbatched path on the CPU otherwise)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(rd, "optimize_lml",
               functools.partial(rd.optimize_lml, use_batched=True))
    yield
    mp.undo()


def test_default_draws_trace_the_jax_packages_edge(small, batched_reference):
    """``run_trace`` with its default draws and nothing injected accepts
    the JAX package's pixels at the same seed, in as many iterations, and
    fits within FINAL_FIT; it is bit for bit the trace replayed from the
    JAX package's own draws."""
    ref = jax.device_get(rd.run_trace(small["cfg"], small["data"],
                                      small["state0"]))
    got = pd.run_trace(small["pcfg"], small["pdata"], small["pstate0"])
    assert got.n_iters == int(ref.n_iters) >= 2
    assert_results_match(got, ref)
    replay = pd.run_trace(small["pcfg"], small["pdata"], small["pstate0"],
                          draws=JaxDraws(small["pcfg"], small["rank"]))
    assert_same_bits(got, replay)


@pytest.mark.parametrize("seed", [2, 3])
def test_gp_edge_tracing_seed_traces_the_jax_packages_edge(seed):
    """The public entry point at other seeds: the same integer trace as
    the JAX package's ``GP_Edge_Tracing`` where its mean lies off a
    rounding boundary, and the same iteration count."""
    _, _, grad, init = small_problem()
    args = (init, grad, SMALL_KW["kernel_options"], 1, np.array([]), 256, 1,
            6, 0.1, 4, seed, False, True)
    mp = pytest.MonkeyPatch()
    mp.setattr(rd, "optimize_lml",
               functools.partial(rd.optimize_lml, use_batched=True))
    try:
        ref = RefTracer(*args)
        want = np.asarray(ref())
    finally:
        mp.undo()
    tracer = gpt.GP_Edge_Tracing(*args, device="cpu")
    got = tracer()
    r = ref.last_result
    assert tracer.last_result.n_iters == int(r.n_iters)
    np.testing.assert_array_equal(tracer.last_result.iter_nobs.numpy(),
                                  np.asarray(r.iter_nobs))
    mean = np.asarray(r.y_mean)
    far = np.abs(mean - np.floor(mean) - 0.5) > 0.1
    np.testing.assert_array_equal(got[far], want[far])


def test_ensemble_member_traces_the_jax_packages_member(small,
                                                        batched_reference):
    """Member 1 of the port's default ensemble is the JAX package's member
    1 (``PRNGKey(seed + 1)``): same pixels and iterations, the final fit
    within FINAL_FIT; and it is the port's single trace of seed + 1."""
    _, ref_all = rs.trace_ensemble(small["cfg"], small["data"],
                                   small["state0"], n_seeds=2,
                                   return_all=True)
    ref1 = jax.tree.map(lambda a: np.asarray(a)[1], ref_all)
    _, every = ps.trace_ensemble(small["pcfg"], small["pdata"],
                                 small["pstate0"], n_seeds=2,
                                 return_all=True)
    got1 = pd.frame_of(every, 1)
    assert got1.n_iters == int(ref1.n_iters)
    assert_results_match(got1, ref1)
    single = pd.run_trace(small["pcfg"]._replace(seed=small["pcfg"].seed + 1),
                          small["pdata"], small["pstate0"])
    for f in ("obs_x", "obs_y", "obs_valid", "iter_nobs", "edge_trace"):
        assert torch.equal(getattr(got1, f), getattr(single, f)), f


# ------------------------------------------ the fixtures chip_smoke reads --

def _fixture(name):
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           name)) as f:
        return json.load(f)


@pytest.mark.parametrize("kind", ["iteration", "restarts", "unfolded",
                                  "unfolded_restarts", "bits"])
def test_stream_fixture_is_the_ports_stream(kind):
    """``tests/jax_stream_fixture.json`` (the JAX package's draws, which
    ``chip_smoke.py`` holds the kernel to) against the port's plain
    version on the CPU: the keys as the port derives them, the first and
    last values and the checksum of each draw's bits; the draws of S = 10⁵
    are left to the card."""
    from torch_jax_fixtures import checksum
    fx = _fixture("jax_stream_fixture.json")
    entries = [e for e in fx["entries"] if e["kind"] == kind
               and np.prod(e["shape"]) <= 2_100_000]
    assert entries
    for e in entries:
        base = prng.prng_key(e["seed"])
        key = {"iteration": lambda: prng.split(prng.fold_in(
                   base, e["it"] + 1))[e["part"] == "noise"],
               "restarts": lambda: prng.fold_in(base, 0),
               "unfolded": lambda: prng.split(base)[e["part"] == "noise"],
               "unfolded_restarts": lambda: base,
               "bits": lambda: base}[kind]()
        assert list(key) == e["key"]
        if kind == "bits":
            bits = prng.random_bits(key, e["shape"]).numpy()
        elif kind.endswith("restarts"):
            bits = prng.uniform(key, e["shape"]).numpy().view(np.uint32)
        else:
            bits = prng.normal(key, e["shape"]).numpy().view(np.uint32)
        bits = bits.astype(np.uint32).reshape(-1)
        assert bits[:fx["edge"]].tolist() == e["head"]
        assert bits[-fx["edge"]:].tolist() == e["tail"]
        assert checksum(bits) == e["checksum"]


def test_trajectory_fixture_demo_seed_1_on_the_cpu():
    """The demo config's seed-1 entry of ``tests/jax_trajectory_fixture.
    json`` against the port's CPU trace with its default draws, as
    ``chip_smoke.py::jax_trajectory_phase`` holds the card to it: every
    iteration's accepted pixels, n_iters and iter_nobs equal, the integer
    trace equal off the rounding boundaries."""
    ref = _fixture("jax_trajectory_fixture.json")["traces"]["demo/1"]
    img, edge = gpt.construct_test_img((500, 500), 200, 4, 0.05,
                                       "sinusoidal", 0.3, gaps=True, seed=1)
    grad = gpt.comp_grad_img(img, gpt.kernel_builder((11, 5), unit=False),
                             device="cpu")
    init = edge[[0, -1]][:, [1, 0]]
    tracer = gpt.GP_Edge_Tracing(
        init, grad, {"kernel": "RBF", "sigma_f": 75, "length_scale": 20}, 1,
        np.array([]), 1000, 1, 5, 0.1, 5, 1, True, True, device="cpu")
    out, _ = tracer()
    cfg, data = tracer.cfg, tracer.data
    state = pd.init_state(cfg, device="cpu")
    inv = pd.loop_invariants(cfg, data)
    accepted, prev = [], None
    while int(state.n_fobs) < cfg.algo_thresh and state.it < cfg.max_iters:
        prev = [state.obs_x.numpy(), state.obs_y.numpy(),
                state.obs_valid.numpy()]
        state, _ = pd.trace_step(cfg, data, state, invariants=inv)
        cur = [state.obs_x.numpy(), state.obs_y.numpy(),
               state.obs_valid.numpy()]
        changed = np.nonzero((cur[0] != prev[0]) | (cur[1] != prev[1])
                             | (cur[2] != prev[2]))[0]
        accepted.append([[int(b), int(cur[0][b]) if cur[2][b] else -1,
                          int(cur[1][b])] for b in changed])
    assert accepted == ref["accepted"]
    res = tracer.last_result
    assert res.n_iters == ref["n_iters"]
    assert res.iter_nobs[:res.n_iters].tolist() == ref["iter_nobs"]
    far = np.ones(ref["E"], bool)
    far[ref["near_boundary"]] = False
    np.testing.assert_array_equal(out[far, 0], np.asarray(ref["trace"])[far])


def test_resume_from_a_jax_checkpoint_draws_the_uninterrupted_stream(
        small, tmp_path):
    """A state the JAX package saved after two iterations resumes in the
    port to the port's uninterrupted trace (its pixels, counts and
    iterations exactly; the first two iterations' curves are the JAX
    package's floats) and to the JAX package's pixels: the draws need the
    seed and the iteration alone."""
    from gaussian_process_edge_trace_torch.trace import checkpoint as pck
    from gaussian_process_edge_trace_tpu.trace import checkpoint as rck
    state = small["state0"]
    for _ in range(2):
        state, _ = rd.trace_step(small["cfg"], small["data"], state)
    path = tmp_path / "jax_state.npz"
    rck.save_state(path, state)
    resumed = pck.resume_trace(small["pcfg"], small["pdata"],
                               pck.load_state(path, device="cpu"))
    whole = pd.run_trace(small["pcfg"], small["pdata"], small["pstate0"])
    assert resumed.n_iters == whole.n_iters
    for f in ("obs_x", "obs_y", "obs_valid", "iter_nobs", "edge_trace"):
        assert torch.equal(getattr(resumed, f), getattr(whole, f)), f
    torch.testing.assert_close(resumed.y_mean, whole.y_mean)
    ref = jax.device_get(rd.run_trace(small["cfg"], small["data"],
                                      small["state0"]))
    for f in ("obs_x", "obs_y", "obs_valid", "iter_nobs"):
        np.testing.assert_array_equal(getattr(resumed, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
