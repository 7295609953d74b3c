"""PyTorch port, batched serving: ``trace_batch``, ``trace_ensemble`` and
``trace_multi_edge`` against the JAX package's ``trace_batch_vmap``,
``trace_ensemble`` and ``trace_multi_edge`` from the same draws; every frame
of a batch against the port's own ``run_trace`` of that frame; the kernels'
plain versions and their CUDA wrappers' launches with a frame axis.

The reference's final fit runs its batched path, as on the TPU and as the
port's does (``optimize_lml(use_batched=True)``; on the CPU the reference
takes its unbatched path otherwise)."""

import contextlib
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_process_edge_trace_torch import interop
from gaussian_process_edge_trace_torch.models import gpr
from gaussian_process_edge_trace_torch.ops import cuda_build
from gaussian_process_edge_trace_torch.ops import cuda_interp as ci
from gaussian_process_edge_trace_torch.ops import sums
from gaussian_process_edge_trace_torch.parallel import sharded as ps
from gaussian_process_edge_trace_torch.trace import cuda_kde as ck
from gaussian_process_edge_trace_torch.trace import driver as pd
from gaussian_process_edge_trace_torch.trace import scoring
from gaussian_process_edge_trace_tpu.parallel import sharded as rs
from gaussian_process_edge_trace_tpu.trace import driver as rd
from gaussian_process_edge_trace_tpu.utils.image import (
    comp_grad_img, kernel_builder)
from gaussian_process_edge_trace_tpu.utils.synthetic import construct_test_img
from torch_parity import (ATOL, FINAL_FIT, RTOL, SMALL_IMG, SMALL_KW,
                          WIDE_IMG, WIDE_KW, JaxDraws, assert_results_match,
                          assert_same_bits, small_problem)

torch.set_num_threads(1)

ODD_IMG = dict(SMALL_IMG, size=(64, 95))


def _frames(img_kw, seeds):
    """(grads (B, M, N), inits (B, 2, 2), edges) of one image per seed."""
    probs = [small_problem(dict(img_kw, seed=s)) for s in seeds]
    return (np.stack([p[2] for p in probs]), np.stack([p[3] for p in probs]),
            [p[1] for p in probs])


def _frame_data(data, f):
    """Frame ``f`` of a batched TracerData (the shared leaves as they are)."""
    own = ("grad_img", "grad_kde", "grad_cols", "init_x", "init_y")
    return pd.TracerData(**{k: v[f] if k in own else v
                            for k, v in data._asdict().items()})


def _batches(img_kw, seeds, kw):
    """The reference's ``trace_batch_vmap`` and the port's ``trace_batch``
    of the same frames from the same draws (the data and states carried
    across by ``interop.from_reference``)."""
    grads, inits, edges = _frames(img_kw, seeds)
    cfg = rd.make_config(inits[0], grads.shape[1:], **kw)
    data = rs.make_batch_data(cfg, jnp.asarray(grads), jnp.asarray(inits))
    states = rs.make_batch_state(cfg, len(seeds))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rd, "optimize_lml",
                   functools.partial(rd.optimize_lml, use_batched=True))
        ref = jax.device_get(rs.trace_batch_vmap(cfg, data, states))
    pcfg, pdata, pstates = interop.from_reference(
        cfg._asdict(), jax.device_get(data._asdict()),
        jax.device_get(states._asdict()), device="cpu")
    draws = JaxDraws(pcfg, pdata.L_prior_unit.shape[1])
    got = ps.trace_batch(pcfg, pdata, pstates, draws)
    return dict(ref=ref, got=got, pcfg=pcfg, pdata=pdata, pstates=pstates,
                draws=draws, edges=edges)


@pytest.fixture(scope="module")
def small_batch():
    """Three frames of the small slice config (image seeds 1-3)."""
    return _batches(SMALL_IMG, (1, 2, 3), SMALL_KW)


def test_batch_matches_reference_batch(small_batch):
    """``trace_batch`` against ``trace_batch_vmap`` on three frames that
    finish at different iterations: the accepted pixels, iteration counts,
    thresholds and integer traces equal, the floats within tolerance."""
    ref, got = small_batch["ref"], small_batch["got"]
    assert len(set(np.asarray(ref.n_iters).tolist())) > 1
    assert got.n_iters.device.type == "cpu"
    assert_results_match(got, ref)


def test_batch_frames_equal_their_single_traces(small_batch):
    """Each frame of the batch equals, bit for bit, the port's ``run_trace``
    of that frame alone: also the frames that finished first, which the
    loop kept unchanged while the others went on."""
    got, pcfg, pdata = (small_batch[k] for k in ("got", "pcfg", "pdata"))
    for f in range(3):
        single = pd.run_trace(pcfg, _frame_data(pdata, f),
                              pd.init_state(pcfg, "cpu"),
                              small_batch["draws"])
        assert_same_bits(pd.frame_of(got, f), single)


def test_interop_carries_batched_data_and_state(small_batch):
    """``from_reference`` keeps the leading frame axis of the JAX package's
    ``make_batch_data``/``make_batch_state`` and makes their per-frame
    ``it`` a tensor; a batch whose active frames stand at different
    iterations is refused."""
    pdata, pst, pcfg = (small_batch[k] for k in ("pdata", "pstates", "pcfg"))
    assert pdata.grad_kde.shape == (3, 64, 96)
    assert pdata.grad_cols.shape == (3, 96, 64)
    assert pdata.init_x.shape == (3, 2) and pdata.L_prior_unit.dim() == 2
    assert torch.equal(pst.it, torch.zeros(3, dtype=torch.int64))
    assert pst.obs_x.shape == (3, pcfg.bins.n_bins)
    skewed = pst._replace(it=torch.tensor([0, 1, 0]))
    with pytest.raises(ValueError, match="iterations"):
        pd.run_loop(pcfg, pdata, skewed, small_batch["draws"])


def test_odd_edge_batch_matches_reference(monkeypatch):
    """Two frames at an odd edge length (E = 95): every iteration scores
    both frames through one interpolation, and the final cost of both
    through one more; the batch matches the reference's."""
    calls = {"interp": 0}
    interp = scoring.column_interp

    def counted(*args, **kwargs):
        calls["interp"] += 1
        return interp(*args, **kwargs)
    monkeypatch.setattr(scoring, "column_interp", counted)
    b = _batches(ODD_IMG, (1, 2), SMALL_KW)
    assert b["got"].edge_trace.shape == (2, 95, 2)
    assert_results_match(b["got"], b["ref"])
    assert calls["interp"] == int(b["got"].n_iters.max()) + 1


def test_wide_batch_equals_single_traces():
    """Two frames of the wide config: S = 8192 (K1's transposed copy and
    the row take of the kept curves) and n_train = 176 (the coarse-to-fine
    final fit over the blocked Cholesky and solves), cut to three
    iterations to keep the CPU time short. Each frame equals its single
    trace bit for bit."""
    grads, inits, _ = _frames(WIDE_IMG, (1, 2))
    cfg = pd.make_config(inits[0], grads.shape[1:], max_iters=3, **WIDE_KW)
    assert cfg.N_samples >= 8192 and cfg.n_train > 160
    data = ps.make_batch_data(cfg, grads, inits, "cpu")
    got = ps.trace_batch(cfg, data, ps.make_batch_state(cfg, 2, "cpu"))
    for f in range(2):
        single = pd.run_trace(cfg, _frame_data(data, f),
                              pd.init_state(cfg, "cpu"))
        assert_same_bits(pd.frame_of(got, f), single)


@pytest.mark.parametrize("n", [1, 3, 104, 208, 10816])
def test_tree_sum_depends_on_the_axis_length_alone(n):
    """``tree_sum``, the final fit's sums on the card: each row of a batch
    sums to the bits of that row summed alone, along either axis, and to
    the float64 sum within the pairwise tree's rounding."""
    rng = np.random.default_rng(n)
    x = torch.tensor(rng.normal(size=(5, n)) * np.exp(rng.normal(size=n)),
                     dtype=torch.float32)
    rows = gpr.tree_sum(x)
    for f in range(5):
        assert torch.equal(rows[f], gpr.tree_sum(x[f:f + 1])[0])
    assert torch.equal(gpr.tree_sum(x.T.contiguous(), dim=0), rows)
    exact = x.double().sum(-1)
    depth = max(n - 1, 1).bit_length()
    bound = depth * 2.0 ** -24 * x.double().abs().sum(-1)
    assert bool(((rows.double() - exact).abs() <= bound).all())


def test_card_final_fit_does_not_depend_on_frames(small_batch, monkeypatch):
    """The final fit's card path (its factors and solves through K5 and K6,
    here their plain versions, and its sums through ``tree_sum``; forced on
    the CPU): three frames fitted at once get, each, the bits of their fit
    alone, and the CPU path's result within the final fit's tolerance."""
    pcfg, pdata, draws = (small_batch[k] for k in ("pcfg", "pdata", "draws"))
    states = pd.run_loop(pcfg, pdata, small_batch["pstates"], draws)
    x, y, mask, noise_w = pd._train_set(pcfg, pdata, states)
    u = draws.restarts()
    cpu = pd._final_fit_buffers(pcfg, pdata, u, x, y, mask, noise_w)
    monkeypatch.setattr(gpr, "_on_card", lambda t: True)
    monkeypatch.setattr(sums, "_on_card", lambda t: True)
    batch = pd._final_fit_buffers(pcfg, pdata, u, x, y, mask, noise_w)
    for f in range(3):
        one = pd._final_fit_buffers(pcfg, _frame_data(pdata, f), u,
                                    x[f:f + 1], y[f:f + 1], mask[f:f + 1],
                                    noise_w)
        for a, b in zip(batch, one):
            assert torch.equal(a[f], b[0])
    for name, a, b in zip(("y_mean", "y_std", "y_s", "theta", "lml"), batch,
                          cpu):
        rtol, atol = FINAL_FIT.get(name, (RTOL, ATOL))
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=rtol,
                                   atol=atol, err_msg=name)


def test_card_sampling_round_runs_frame_by_frame(small_batch, monkeypatch):
    """The sampling round's card path (forced on the CPU): the solve (K6's
    forward and backward solves) and the cross product (K8) each run once
    for all frames, and ``torch.cholesky_solve`` not at all; ``F z`` for
    frames with draws of their own stays one product per member. Each frame
    equals the same frame run as a batch of one, bit for bit, and the
    curves are within float32 rounding of the CPU path's."""
    pcfg, pdata, draws = (small_batch[k] for k in ("pcfg", "pdata", "draws"))
    x, y, mask, noise_w = pd._train_set(pcfg, pdata, small_batch["pstates"])
    z, w = draws.normals(0)
    zs, ws = torch.stack([z] * 3), torch.stack([w] * 3)
    cpu = pd._sample_round(pcfg, pdata, x, y, mask, noise_w, zs, ws)
    calls = []

    def counted(name, fn, frames):
        def run(*args, **kw):
            calls.append((name, frames(*args)))
            return fn(*args, **kw)
        return run
    monkeypatch.setattr(gpr, "_on_card", lambda t: True)
    for name, frames in (("forward_solve_auto", lambda L, R: R.shape[0]),
                         ("backward_solve_auto", lambda L, R: R.shape[0]),
                         ("frames_product", lambda a, b: a.shape[0])):
        monkeypatch.setattr(gpr, name, counted(name, getattr(gpr, name),
                                               frames))
    monkeypatch.setattr(torch, "cholesky_solve",
                        counted("cholesky_solve", torch.cholesky_solve,
                                lambda r, L: r.shape[0]))
    card = pd._sample_round(pcfg, pdata, x, y, mask, noise_w, zs, ws)
    assert sorted(calls) == [("backward_solve_auto", 3),
                             ("forward_solve_auto", 3),
                             ("frames_product", 3)]
    for f in range(3):
        one = pd._sample_round(pcfg, pdata, x[f:f + 1], y[f:f + 1],
                               mask[f:f + 1], noise_w, zs[f:f + 1],
                               ws[f:f + 1])
        assert torch.equal(card[f], one[0])
    torch.testing.assert_close(card, cpu, rtol=1e-5,
                               atol=1e-5 * cpu.abs().max().item())


def test_card_loop_sums_and_blur_run_frame_by_frame(monkeypatch):
    """The loop's other steps whose order would depend on the batch size on
    the card, forced on the CPU: ``frame_sum`` (the sampling round's masked
    mean and std, the kept curves' weights) sums every frame's row in one
    call (K9), and the KDE's two blur products run once each for the whole
    (B, M+2, N+2) grid (K8), the Toeplitz factor shared and its band
    given. Each frame equals the same frame run as a batch of one, bit for
    bit, and both give the CPU path's values."""
    from gaussian_process_edge_trace_torch.trace import kde
    rng = np.random.default_rng(4)
    rows = torch.tensor(rng.normal(size=(3, 104)), dtype=torch.float32)
    y = torch.tensor(rng.uniform(-2, 66, size=(3, 96, 100)),
                     dtype=torch.float32)
    w = torch.softmax(torch.tensor(rng.normal(size=(3, 100)),
                                   dtype=torch.float32), -1)
    cpu_sum, cpu_kde = gpr.frame_sum(rows), kde.curve_kde(y, w, 64, 96, 0)
    calls = []

    def recorded(fn, name):
        def run(*a, **kw):
            calls.append((name, tuple(a[0].shape), tuple(a[1].shape)
                          if len(a) > 1 else None, kw))
            return fn(*a, **kw)
        return run
    monkeypatch.setattr(kde, "frames_product",
                        recorded(kde.frames_product, "product"))
    monkeypatch.setattr(gpr, "row_sum", recorded(gpr.row_sum, "sum"))
    monkeypatch.setattr(gpr, "_on_card", lambda t: True)
    card_sum = gpr.frame_sum(rows)
    card_kde = kde.curve_kde(y, w, 64, 96, 0)
    assert calls == [("sum", (3, 104), None, {}),
                     ("product", (66, 66), (3, 66, 98), {"a_band": 8}),
                     ("product", (3, 66, 98), (98, 98), {"b_band": 8})]
    for f in range(3):
        assert torch.equal(card_sum[f], gpr.frame_sum(rows[f:f + 1])[0])
        assert torch.equal(card_kde[f],
                           kde.curve_kde(y[f:f + 1], w[f:f + 1], 64, 96,
                                         0)[0])
    assert torch.equal(card_sum, cpu_sum)
    torch.testing.assert_close(card_kde, cpu_kde, rtol=1e-6, atol=1e-7)


def test_card_factor_ladder_skips_a_failed_factor(monkeypatch):
    """``safe_cholesky(per_matrix=True)`` on the card: K5 (here its plain
    version) marks a failed factor by a diagonal that is not finite, and
    each matrix takes the first rung of its own that factored."""
    monkeypatch.setattr(gpr, "_on_card", lambda t: True)
    bad = torch.tensor([[1.0, 1.0], [1.0, 1.0 - 1e-7]])   # not PD in f32
    good = torch.tensor([[2.0, 0.5], [0.5, 1.0]])
    L = gpr.safe_cholesky(torch.stack([bad, good]), jitter_scales=(0.0, 1e-3),
                          per_matrix=True)
    torch.testing.assert_close(L[0] @ L[0].T, bad + 1e-3 * bad.diagonal()
                               .mean() * torch.eye(2), rtol=1e-5, atol=1e-6)
    assert torch.equal(L[1], torch.linalg.cholesky(good))


@pytest.fixture(scope="module")
def ensembles():
    """The reference's and the port's best-of-3 on the small image, member
    k drawing from seed + k on both sides."""
    _, _, grad, init = small_problem()
    cfg = rd.make_config(init, grad.shape, **SMALL_KW)
    data = rd.make_data(cfg, jnp.asarray(grad), jnp.asarray(init))
    state0 = rd.init_state(cfg)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rd, "optimize_lml",
                   functools.partial(rd.optimize_lml, use_batched=True))
        ref_best, ref_all = jax.device_get(
            rs.trace_ensemble(cfg, data, state0, n_seeds=3, return_all=True))
    pcfg, pdata, pstate0 = interop.from_reference(
        cfg._asdict(), jax.device_get(data._asdict()),
        jax.device_get(state0._asdict()), device="cpu")
    rank = pdata.L_prior_unit.shape[1]
    draws = [JaxDraws(pcfg._replace(seed=pcfg.seed + k), rank)
             for k in range(3)]
    best, every = ps.trace_ensemble(pcfg, pdata, pstate0, n_seeds=3,
                                    return_all=True, draws=draws)
    return dict(ref_best=ref_best, ref_all=ref_all, best=best, every=every,
                pcfg=pcfg, pdata=pdata, pstate0=pstate0, draws=draws)


def test_ensemble_matches_reference(ensembles):
    """Every member against the reference's, and the same member chosen;
    member 0 is the port's single trace of the config's seed."""
    e = ensembles
    assert_results_match(e["every"], e["ref_all"])
    k = int(np.argmin(np.asarray(e["ref_all"].final_cost)))
    assert float(e["best"].final_cost) == float(e["every"].final_cost[k])
    assert_same_bits(e["best"], pd.frame_of(e["every"], k))
    np.testing.assert_array_equal(e["best"].edge_trace.numpy(),
                                  np.asarray(e["ref_best"].edge_trace))
    single = pd.run_trace(e["pcfg"], e["pdata"], e["pstate0"], e["draws"][0])
    assert_same_bits(pd.frame_of(e["every"], 0), single)


def test_ensemble_never_chooses_a_nan_cost(ensembles, monkeypatch):
    """A member whose final cost is NaN loses: ``torch.argmin`` alone would
    return the NaN's index (sharded.py:131-134 of the reference)."""
    e = ensembles
    costs = e["every"].final_cost
    first, second = torch.argsort(costs)[:2].tolist()
    nan = costs.clone()
    nan[first] = float("nan")
    monkeypatch.setattr(ps, "run_trace",
                        lambda *a: e["every"]._replace(final_cost=nan))
    best = ps.trace_ensemble(e["pcfg"], e["pdata"], e["pstate0"], n_seeds=3,
                             draws=e["draws"])
    assert float(best.final_cost) == float(costs[second])
    with pytest.raises(ValueError):
        ps.trace_ensemble(e["pcfg"], e["pdata"], e["pstate0"], n_seeds=0)


def test_default_member_streams_are_disjoint():
    """The default member sources: member k is the JAX package's stream of
    ``PRNGKey(seed + k)`` (sharded.py:127), so member 0 is
    ``StreamDraws(cfg)`` itself and member k the single trace of seed
    ``seed + k``; the members' normals differ from one another's at every
    iteration checked."""
    _, _, grad, init = small_problem()
    cfg = pd.make_config(init, grad.shape, **SMALL_KW)
    members = [pd.StreamDraws(cfg, 8, "cpu", seed=cfg.seed + k)
               for k in range(5)]
    plain = pd.StreamDraws(cfg, 8, "cpu")
    for a, b in zip(members[0].normals(3), plain.normals(3)):
        assert torch.equal(a, b)
    assert torch.equal(members[0].restarts(), plain.restarts())
    later = pd.StreamDraws(cfg._replace(seed=cfg.seed + 3), 8, "cpu")
    assert torch.equal(members[3].normals(2)[1], later.normals(2)[1])
    firsts = [d.normals(it)[0] for d in members for it in (0, 1)]
    assert all(not torch.equal(firsts[i], firsts[j])
               for i in range(len(firsts)) for j in range(i))


def test_multi_edge_matches_reference():
    """Two boundaries of one image (test_parallel.py:197-203): the port's
    ``trace_multi_edge`` against the reference's, and bit for bit against
    its own ``trace_batch`` of the image tiled twice."""
    size = (96, 96)
    N = size[1]
    img, edge = construct_test_img(size=size, amplitude=14, curvature=2,
                                   noise_level=0.01, ltype="multi-sinusoidal",
                                   intensity=0.3, gaps=False, seed=2)
    edges = [edge[:N], edge[N:2 * N]]
    grad = np.asarray(comp_grad_img(img, kernel_builder((7, 3))),
                      dtype=np.float32)
    inits = np.asarray([[[0, e[0, 0]], [N - 1, e[N - 1, 0]]] for e in edges])
    kw = dict(kernel_options={"kernel": "RBF", "sigma_f": 20,
                              "length_scale": 7},
              noise_y=1, N_samples=96, score_thresh=0.5, delta_x=5,
              keep_ratio=0.25, pixel_thresh=4, seed=3, fix_endpoints=True)
    cfg = rd.make_config(inits[0], size, **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rd, "optimize_lml",
                   functools.partial(rd.optimize_lml, use_batched=True))
        ref = jax.device_get(rs.trace_multi_edge(cfg, jnp.asarray(grad),
                                                 inits))
    pcfg = pd.make_config(inits[0], size, **kw)
    rank = pd.prior_factor(pcfg).shape[1]
    got = ps.trace_multi_edge(pcfg, grad, inits, device="cpu",
                              draws=JaxDraws(pcfg, rank))
    assert got.edge_trace.shape == (2, N, 2)
    assert_results_match(got, ref)
    tiled = ps.trace_batch(
        pcfg, ps.make_batch_data(pcfg, np.stack([grad, grad]), inits, "cpu"),
        ps.make_batch_state(pcfg, 2, "cpu"), JaxDraws(pcfg, rank))
    assert_same_bits(got, tiled)


def _kernel_inputs(name, B, shared):
    """Frames for one kernel's plain version: K1 and K2 (cols, ys) with
    cols of their own or shared, K3 (y, w)."""
    rng = np.random.default_rng(4)
    if name == "K3":
        E, S, M = 37, 33, 29
        y = M / 2 + np.cumsum(rng.normal(0, 1.5, (B, E, S)), axis=1)
        y[:, ::5, 0] = -1.0            # rows just outside the image
        y[:, 1::5, 1] = float(M)
        w = rng.uniform(0.5, 2.0, (B, S))
        return (torch.tensor(y, dtype=torch.float32),
                torch.tensor(w / w.sum(-1, keepdims=True),
                             dtype=torch.float32), M)
    E, M, S = (38, 61, 130) if name == "K1" else (37, 61, 1003)
    cols = rng.random((E, M) if shared else (B, E, M))
    ys = rng.uniform(-5, M + 5, (B, E, S))
    return (torch.tensor(cols, dtype=torch.float32),
            torch.tensor(ys, dtype=torch.float32))


@pytest.mark.parametrize("name,shared", [("K1", False), ("K1", True),
                                         ("K2", False), ("K2", True),
                                         ("K3", False)])
def test_plain_versions_take_frames(name, shared):
    """The plain versions of K1 (with its transposed copy), K2 and K3 with
    a frame axis equal, bit for bit, the frames' single calls stacked."""
    B = 3
    if name == "K3":
        y, w, M = _kernel_inputs(name, B, shared)
        got = [ck.column_binning_plain(y, w, M)]
        each = [[ck.column_binning_plain(y[f], w[f], M)] for f in range(B)]
    else:
        cols, ys = _kernel_inputs(name, B, shared)
        col = (lambda f: cols) if shared else (lambda f: cols[f])
        if name == "K1":
            got = ci.fused_cost_plain(cols, ys, 1e-3, with_transpose=True)
            each = [ci.fused_cost_plain(col(f), ys[f], 1e-3,
                                        with_transpose=True)
                    for f in range(B)]
        else:
            got = [ci.column_interp_plain(cols, ys, 1e-3)]
            each = [[ci.column_interp_plain(col(f), ys[f], 1e-3)]
                    for f in range(B)]
    for g, parts in zip(got, zip(*each)):
        assert torch.equal(g, torch.stack(parts))


class _Recorder:
    """Stands in for the kernel library: records each launcher's arguments
    and returns success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def launcher(*args):
            self.calls.append((name, args))
            return 0
        return launcher


@pytest.fixture
def recorder(monkeypatch):
    """The CUDA wrappers run on CPU tensors against :class:`_Recorder`, so
    that what they would launch can be read here."""
    lib = _Recorder()
    monkeypatch.setattr(cuda_build, "library", lambda: lib)
    monkeypatch.setattr(cuda_build, "check_tensors", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    return lib


# Per launcher: the arguments that fix the order of a frame's sums (shapes
# and plan), and the positions of the frame count and the shared-columns
# flag.
_ORDER_ARGS = {"gpet_fused_cost": (slice(6, 14), 14, 15),
               "gpet_column_interp": (slice(3, 10), 10, 11),
               "gpet_binning_2l": (slice(3, 9), 9, None)}


@pytest.mark.parametrize("name,E,M,S,extra", [
    ("K1", 200, 300, 8200, True), ("K1", 500, 500, 1000, False),
    ("K2", 99, 100, 2000, False), ("K2", 1000, 1000, 1, True),
    ("K3", 300, 400, 1000, False), ("K3", 500, 500, 100, False)])
def test_launches_do_not_depend_on_frames(recorder, name, E, M, S, extra):
    """One launch serves 16 frames with the plan of one: the K1, K2 and K3
    wrappers pass the same plan at B = 1 and B = 16 (``extra``: K1's
    transposed copy; K2's columns shared by the frames), and outputs with
    the frame axis. The inputs are broadcast zeros: nothing is computed."""
    def frames(B, *shape):
        return torch.zeros((1,) + shape).expand((B,) + shape)
    for B in (1, 16):
        if name == "K3":
            H = ck.binning_2l_cuda(frames(B, E, S), frames(B, S), M)
            assert H.shape == (B, M + 2, E)
        else:
            cols = (torch.zeros(E, M) if extra and name == "K2"
                    else frames(B, E, M))
            if name == "K1":
                out = ci.fused_cost_cuda(cols, frames(B, E, S),
                                         with_transpose=extra)
                assert out[0].shape == out[1].shape == (B, S)
                assert not extra or out[2].shape == (B, S, E)
            else:
                out = ci.column_interp_cuda(cols, frames(B, E, S))
                assert out.shape == (B, E, S)
    (n1, one), (n16, many) = recorder.calls
    assert n1 == n16
    plan, frames, shared = _ORDER_ARGS[n1]
    assert one[plan] == many[plan]
    assert (one[frames], many[frames]) == (1, 16)
    if shared is not None:
        assert many[shared] == int(extra and name == "K2")
