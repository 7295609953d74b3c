"""PyTorch port, the sampling stage as a CUDA graph, what the CPU can hold:
``safe_cholesky``'s ladder as device work (the factors bit for bit those of
the ladder copied from the host, each rung taken where it must be), the
stage that the graph captures (its function on the stage's tensors, its key,
the draw sources' shapes and their draws into given buffers) equal to the
stage run op by op, the CPU loop that waits for no ladder and runs every
stage op by op, the counters, and the benchmark's reader of the replayed
share. The capture and the replays themselves run on the card
(``tests/test_torch_cuda.py``)."""

import types

import numpy as np
import pytest
import torch

import gaussian_process_edge_trace_torch as gpt
from gaussian_process_edge_trace_torch.models import gpr
from gaussian_process_edge_trace_torch.parallel import sharded as ps
from gaussian_process_edge_trace_torch.trace import driver as pd
from gaussian_process_edge_trace_torch.trace import stage_graph
from gaussian_process_edge_trace_torch.utils import debug, profiling

torch.set_num_threads(1)

KW = dict(kernel_options={"kernel": "RBF", "sigma_f": 20, "length_scale": 8},
          noise_y=1, N_samples=256, score_thresh=1, delta_x=6,
          keep_ratio=0.1, pixel_thresh=4, seed=1, fix_endpoints=True)


def _ladder_on_the_host(K, jitter_scales, per_matrix):
    """``safe_cholesky`` with its ladder and its fallback index made as
    tensors from the host's values (on the CPU ``per_matrix`` takes the
    same library call)."""
    n = K.shape[-1]
    eye = torch.eye(n, dtype=K.dtype)
    scale = torch.diagonal(K, dim1=-2, dim2=-1).mean(-1)
    ladder = torch.tensor(jitter_scales, dtype=K.dtype)
    candidates = K[..., None, :, :] + (ladder * scale[..., None])[
        ..., None, None] * eye
    Ls, info = torch.linalg.cholesky_ex(candidates)
    ok = info == 0
    last = torch.tensor(len(jitter_scales) - 1)
    idx = torch.where(ok.any(-1), torch.argmax(ok.to(torch.uint8), dim=-1),
                      last)
    return torch.take_along_dim(Ls, idx[..., None, None, None],
                                dim=-3)[..., 0, :, :]


def _ladder_cases(dtype, jitter_scales, n=12, seed=3):
    """One SPD matrix per rung that is the first to factor it (its least
    eigenvalue at −½ of the rung's jitter, or positive for rung 0), and one
    that no rung factors (least eigenvalue −0.5·mean diagonal)."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    mats = []
    for j, s in enumerate(list(jitter_scales) + [1.0]):
        w = rng.uniform(1.0, 2.0, n)
        w[0] = 0.0
        K = (Q * w) @ Q.T
        m = np.trace(K) / n
        K -= np.eye(n) * (0.5 * s * m if j else -0.5 * m)
        mats.append(K)
    return torch.tensor(np.stack(mats), dtype=dtype)


@pytest.mark.parametrize("per_matrix", [False, True])
@pytest.mark.parametrize("jitter_scales", [(0.0, 1e-5, 1e-3), (0.0, 1e-3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ladder_on_the_device_gives_the_same_factors(per_matrix,
                                                     jitter_scales, dtype):
    """Every rung taken where it must be, and the fallback where none
    factors: the factors equal those of the ladder copied from the host,
    bit for bit, and each is the factor of its rung's candidate."""
    K = _ladder_cases(dtype, jitter_scales)
    got = gpr.safe_cholesky(K, jitter_scales, per_matrix=per_matrix)
    want = _ladder_on_the_host(K, jitter_scales, per_matrix)
    assert torch.equal(got.view(-1).view(torch.uint8),
                       want.view(-1).view(torch.uint8))
    J = len(jitter_scales)
    scale = torch.diagonal(K, dim1=-2, dim2=-1).mean(-1)
    eye = torch.eye(K.shape[-1], dtype=dtype)
    tol = 1e-4 if dtype == torch.float32 else 1e-10
    for j in range(J):                   # matrix j first factors at rung j
        cand = K[j] + jitter_scales[j] * scale[j] * eye
        assert torch.linalg.cholesky_ex(cand).info == 0
        if j:
            prev = K[j] + jitter_scales[j - 1] * scale[j] * eye
            assert torch.linalg.cholesky_ex(prev).info != 0
        L = got[j]
        assert torch.allclose(L @ L.T, cand, atol=tol * float(scale[j]))
    last = K[J] + jitter_scales[-1] * scale[J] * eye
    assert torch.linalg.cholesky_ex(last).info != 0


def _image(seed):
    img, edge = gpt.construct_test_img((64, 96), 40, 2, 0.03, "sinusoidal",
                                       0.3, seed=seed)
    grad = gpt.comp_grad_img(img, gpt.kernel_builder((9, 5)), device="cpu")
    return grad, np.array([[0, edge[0, 0]], [95, edge[95, 0]]])


@pytest.fixture(scope="module")
def small():
    grad, init = _image(1)
    cfg = pd.make_config(init, tuple(grad.shape), **KW)
    data = pd.make_data(cfg, grad, init, device="cpu")
    state, _ = pd.trace_step(cfg, data, pd.init_state(cfg, device="cpu"))
    state, _ = pd.trace_step(cfg, data, state)
    return cfg, data, pd._lift(state)


def test_cpu_loop_waits_for_no_ladder_and_runs_each_stage_op_by_op(small):
    """No wait for the jitter ladder or in the selection; on the CPU each of
    an iteration's four stages runs op by op, counted once, and nothing is
    captured."""
    cfg, data, _ = small
    assert "jitter" not in pd.HOST_READS and "select" not in pd.HOST_READS
    profiling.reset_counters()
    state = pd.run_loop(cfg, data, pd.init_state(cfg, device="cpu"))
    assert pd.GRAPHS == dict(capture=0, replay=0, eager=4 * state.it,
                             failed=0)
    assert pd.HOST_READS["active"] == state.it + 1


def test_stage_fn_is_the_stage_op_by_op(small):
    """The function a capture records, on the stage's tensors alone, gives
    the stage's curves bit for bit, as does the stage itself, from a source
    that states its shapes and from one that does not."""
    cfg, data, state = small
    draws = pd.StreamDraws(cfg, data.L_prior_unit.shape[1], "cpu")
    z, w = draws.normals(2)
    x, y, mask, noise_w = pd._train_set(cfg, data, state)
    want = pd._sample_round(cfg, data, x, y, mask, noise_w, z, w)
    tensors = ([getattr(data, f) for f in pd._STAGE_DATA]
               + [getattr(state, f) for f in pd._STAGE_STATE])
    assert torch.equal(pd._stage_fn(cfg)(*tensors, z, w), want)
    shapeless = types.SimpleNamespace(normals=lambda it, *cols: (z, w))
    assert torch.equal(pd._sample_stage(cfg, data, state, shapeless, 2),
                       want)
    got = pd._sample_stage(cfg, data, state, draws, 2)
    assert torch.equal(got, want)


def test_stage_key_reads_the_stage_not_the_seed(small):
    """Requests of one configuration share a key whatever their seed; a
    scalar the stage reads, or a shape, gives another."""
    cfg, data, state = small
    tensors = ([getattr(data, f) for f in pd._STAGE_DATA]
               + [getattr(state, f) for f in pd._STAGE_STATE])
    zw = [((8, 256), torch.float32), ((cfg.n_train, 256), torch.float32)]
    key = pd._stage_key(cfg, tensors, zw)
    assert pd._stage_key(cfg._replace(seed=2 ** 40 + 7), tensors, zw) == key
    for other in (cfg._replace(sigma_l=cfg.sigma_l * 2),
                  cfg._replace(noise_y=2.0),
                  cfg._replace(reference_quirks=False)):
        assert pd._stage_key(other, tensors, zw) != key
    assert pd._stage_key(cfg, tensors, zw[:1] + [((cfg.n_train, 128),
                                                  torch.float32)]) != key
    wide = [t[None].expand((3,) + t.shape) for t in tensors]
    assert pd._stage_key(cfg, wide, zw) != key


@pytest.mark.parametrize("cols", [(), (slice(64, 192),)])
def test_sources_state_their_shapes_and_draw_into_buffers(small, cols):
    """``normal_shapes`` gives the shapes ``normals`` draws, and ``normals``
    with ``out`` writes the same normals into the given tensors: one
    source, and an ensemble's stacked sources."""
    cfg, data, _ = small
    rank = data.L_prior_unit.shape[1]
    one = pd.StreamDraws(cfg, rank, "cpu")
    frames = pd.FrameDraws([pd.StreamDraws(cfg, rank, "cpu", seed=s)
                            for s in (1, 2, 3)])
    for src in (one, frames):
        want = src.normals(4, *cols)
        assert src.normal_shapes(*cols) == tuple(t.shape for t in want)
        out = [torch.full(t.shape, float("nan")) for t in want]
        got = src.normals(4, *cols, out=out)
        assert all(g is o for g, o in zip(got, out))
        assert all(torch.equal(g, t) for g, t in zip(got, want))


def test_untabled_frames_state_no_shapes(small):
    cfg, data, _ = small

    class Plain:
        def __init__(self, seed):
            self.src = pd.StreamDraws(cfg, data.L_prior_unit.shape[1], "cpu",
                                      seed=seed)

        def normals(self, it, *cols):
            return self.src.normals(it, *cols)
    assert pd.FrameDraws([Plain(1), Plain(2)]).normal_shapes() is None


def test_graphs_engage_only_on_the_card_outside_dispatch_modes():
    assert not stage_graph.engaged(torch.device("cpu"))
    with debug.debug_nans():
        assert not stage_graph.engaged(torch.device("cuda"))


def test_batch_loop_counts_one_stage_per_iteration():
    """A batch's loop counts each of its four stages once an iteration, for
    all frames."""
    frames = [_image(s) for s in (1, 2, 3)]
    grads = torch.stack([g for g, _ in frames])
    inits = np.stack([i for _, i in frames])
    cfg = pd.make_config(inits[0], tuple(grads.shape[1:]), **KW)
    data = ps.make_batch_data(cfg, grads, inits, device="cpu")
    profiling.reset_counters()
    res = ps.trace_batch(cfg, data, ps.make_batch_state(cfg, 3,
                                                        device="cpu"))
    assert pd.GRAPHS["eager"] == 4 * int(res.n_iters.max())
    assert pd.GRAPHS["capture"] == pd.GRAPHS["replay"] == 0


# The shapes the loop serves, cut for the CPU where the card's are large:
# (image side, frames, S, right endpoint's column).
_LOOP_SHAPES = {"demo": (500, 1, 1000, 499), "1000": (1000, 1, 2000, 999),
                "1000_oddE": (1000, 1, 2000, 998),
                "demo_B4": (500, 4, 1000, 499)}


def _loop_problem(side, frames, S, right, k=3):
    """A config and data of the README generator at the demo's or the 1000²
    suite's settings (image seeds 1..frames), random-walk curves about the
    edge as the samples, and a batched state at iteration ``k`` with some
    observations and telemetry already written."""
    amp, sf, ls = (200, 75, 20) if side == 500 else (400, 200, 50)
    grads, inits = [], []
    for seed in range(1, frames + 1):
        img, edge = gpt.construct_test_img((side, side), amp, 4, 0.05,
                                           "sinusoidal", 0.3, gaps=True,
                                           seed=seed)
        grads.append(gpt.comp_grad_img(img, gpt.kernel_builder((11, 5)),
                                       device="cpu"))
        inits.append(np.array([[0, edge[0, 0]], [right, edge[right, 0]]]))
    cfg = pd.make_config(inits[0], (side, side), {
        "kernel": "RBF", "sigma_f": sf, "length_scale": ls}, N_samples=S,
        delta_x=5, pixel_thresh=5, seed=1)
    data = ps.make_batch_data(cfg, torch.stack(grads), np.stack(inits),
                              device="cpu")
    state = ps.make_batch_state(cfg, frames, device="cpu")
    g = torch.Generator().manual_seed(side + frames + right)
    E, nb, mi = cfg.edge_length, cfg.bins.n_bins, cfg.max_iters
    walk = torch.cumsum(torch.randn((frames, E, S), generator=g), dim=1)
    samples = (side / 2 + 3.0 * walk).to(torch.float32)
    valid = torch.rand((frames, nb), generator=g) < 0.5
    state = state._replace(
        obs_x=torch.randint(0, side, (frames, nb), generator=g),
        obs_y=torch.randint(0, side, (frames, nb), generator=g),
        obs_valid=valid, n_fobs=valid.sum(-1),
        score_thresh=torch.full((frames,), 0.9),
        it=torch.full((frames,), k),
        iter_curves=torch.rand((frames, mi, E), generator=g),
        iter_costs=torch.rand((frames, mi), generator=g),
        iter_nobs=torch.randint(0, nb, (frames, mi), generator=g),
        iter_thresh=torch.rand((frames, mi), generator=g))
    return cfg, data, state, samples


@pytest.mark.parametrize("shape", sorted(_LOOP_SHAPES))
def test_stage_fns_are_the_inline_stages(shape):
    """Scoring, KDE and selection, each as the function a capture records
    on its stage's tensors, give the stages as the loop ran them inline
    bit for bit: the costs and ranking, the weights and KDE, the selection
    and the telemetry written at the host's column ``k``."""
    cfg, data, state, samples = _loop_problem(*_LOOP_SHAPES[shape])
    blur, consts = pd.loop_invariants(cfg, data)
    k = int(state.it[0])
    from gaussian_process_edge_trace_torch.trace.kde import curve_kde
    from gaussian_process_edge_trace_torch.trace.scoring import (
        best_curves, curve_costs)
    from gaussian_process_edge_trace_torch.trace.select import select_pixels
    costs, samples_t = curve_costs(data.grad_cols, samples,
                                   kde_thresh=cfg.kde_thresh,
                                   return_samples_t=True)
    bc, bcosts = best_curves(samples, costs, cfg.N_keep, samples_t=samples_t)
    inv = 1.0 / bcosts
    kde = curve_kde(bc, inv / gpr.frame_sum(inv)[..., None], cfg.M, cfg.N,
                    cfg.x_st, blur=blur)
    sel = select_pixels(
        kde, data.grad_kde, torch.cat([state.user_x, state.obs_x], -1),
        torch.cat([state.user_y, state.obs_y], -1),
        torch.cat([state.user_valid, state.obs_valid], -1),
        n_pre=state.n_fobs, score_thresh=state.score_thresh, spec=cfg.bins,
        fix_endpoints=cfg.fix_endpoints, kde_thresh=cfg.kde_thresh,
        pixel_thresh=cfg.pixel_thresh, algo_thresh=cfg.algo_thresh,
        max_decays=cfg.max_decays, consts=consts)

    def put(buf, v):
        buf = buf.clone()
        buf[:, k] = v
        return buf
    want = dict(obs_x=sel.obs_x, obs_y=sel.obs_y, obs_valid=sel.obs_valid,
                user_valid=torch.zeros_like(state.user_valid),
                score_thresh=sel.score_thresh, n_fobs=sel.n_fobs,
                it=state.it + 1, iter_curves=put(state.iter_curves, bc[..., 0]),
                iter_costs=put(state.iter_costs, bcosts[..., 0]),
                iter_nobs=put(state.iter_nobs, sel.n_fobs),
                iter_thresh=put(state.iter_thresh, sel.score_thresh))
    assert sel.obs_valid.any()
    profiling.reset_counters()
    got_bc, got_bcosts = pd._score_stage(cfg, data, samples)
    assert _same(got_bc, bc) and _same(got_bcosts, bcosts)
    got_kde = pd._kde_stage(cfg, bc, bcosts, blur)
    assert _same(got_kde, kde)
    *fields, score = pd._select_stage(cfg, data, state, kde, bc, bcosts,
                                      consts)
    assert _same(score, sel.score)
    for name, got in zip(pd._SELECT_OUT, fields):
        assert _same(got, want[name]), name
    assert pd.GRAPHS == dict(capture=0, replay=0, eager=3, failed=0)


def _same(a, b):
    """Bit for bit, NaN equal to the same NaN."""
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(-1).view(torch.uint8),
        b.contiguous().view(-1).view(torch.uint8))


def test_telemetry_goes_to_each_frames_own_column():
    """The telemetry write reads each frame's iteration on the device: it
    writes the column ``buf[:, k] = v`` writes where the frame stands at
    ``k``, and nothing where it stands past the last column."""
    g = torch.Generator().manual_seed(4)
    mi, E = 6, 5
    curves, costs = torch.rand((3, mi, E), generator=g), torch.rand((3, mi))
    v_curves, v_costs = torch.rand((3, E), generator=g), torch.rand(3)
    it = torch.tensor([2, 2, mi])
    at = torch.arange(mi) == it[:, None]
    got_c, got_s = pd._put(curves, v_curves, at), pd._put(costs, v_costs, at)
    want_c, want_s = curves.clone(), costs.clone()
    want_c[:2, 2], want_s[:2, 2] = v_curves[:2], v_costs[:2]
    assert torch.equal(got_c, want_c) and torch.equal(got_s, want_s)
    assert torch.equal(got_c[2], curves[2]) and torch.equal(got_s[2], costs[2])


def test_stage_keys_ignore_the_seed_and_the_iteration(small, monkeypatch):
    """The key each stage looks its graph up by is the same at every
    iteration and for every seed of a configuration: no stage's Python
    reads either. (Graphs engaged on the CPU only as far as the key: the
    lookup finds none and each stage runs op by op.)"""
    cfg, data, _ = small
    keys = []

    def lookup(key, build, name, shared=()):
        keys.append((name, key))
        return None
    monkeypatch.setattr(stage_graph, "engaged", lambda device: True)
    monkeypatch.setattr(stage_graph, "lookup", lookup)
    by_seed = []
    for seed in (1, 2 ** 40 + 7):
        c = cfg._replace(seed=seed)
        d = pd.make_data(c, data.grad_img, np.array(
            [[c.x_st, int(data.init_y[0])], [c.x_en, int(data.init_y[-1])]]),
            device="cpu")
        keys.clear()
        state = pd.run_loop(c, d, pd.init_state(c, device="cpu"))
        assert state.it >= 2 and len(keys) == 4 * state.it
        names = [n for n, _ in keys]
        assert names == ["gpet.sample.replay", "gpet.score.replay",
                         "gpet.kde.replay", "gpet.select.replay"] * state.it
        per_stage = {n: {k for m, k in keys if m == n} for n in names}
        assert all(len(ks) == 1 for ks in per_stage.values())
        by_seed.append(per_stage)
    assert by_seed[0] == by_seed[1]
    for other in (cfg._replace(kde_thresh=2e-3),
                  cfg._replace(pixel_thresh=cfg.pixel_thresh + 1)):
        assert pd._select_key(other) != pd._select_key(cfg)
    assert pd._score_key(cfg._replace(N_keep=cfg.N_keep + 1)) != \
        pd._score_key(cfg)
    assert pd._kde_key(cfg, None) != pd._kde_key(cfg, ((True, True), 8))


def test_loop_state_owns_its_memory_and_stages_run_op_by_op_off_the_card(
        small):
    """Off the card no stage's output is a graph buffer; what the loop
    returns is a state of plain tensors, and ``own`` hands back the tensor
    itself where nothing replays into it."""
    cfg, data, _ = small
    state = pd.run_loop(cfg, data, pd.init_state(cfg, device="cpu"))
    assert not any(stage_graph.produced(v) for v in state
                   if isinstance(v, torch.Tensor))
    t = torch.ones(3)
    assert stage_graph.own(t) is t and stage_graph.own(5) == 5


def test_stage_graph_copies_in_only_what_changed():
    """A stage graph's static buffers take an input unless it is already
    there: the buffer itself, or the tensor copied last time at the same
    version. A tensor written in place, another tensor, or an inference
    tensor (no version counter) is copied. (The buffers are made without
    the card; the capture needs it.)"""
    a, b = torch.arange(4.0), torch.zeros(3)
    g = stage_graph.StageGraph(lambda x, y: x, [a, b], "gpet.test")
    assert g.static[0] is not a and torch.equal(g.static[0], a)
    g.static[0].fill_(-1.0)
    g._load([a, b])
    assert torch.equal(g.static[0], torch.full((4,), -1.0))
    a.add_(1.0)
    c = torch.ones(3)
    g._load([a, c])
    assert torch.equal(g.static[0], a) and torch.equal(g.static[1], c)
    g._load([a, g.static[1]])
    assert torch.equal(g.static[1], c)
    with torch.inference_mode():
        t = torch.full((4,), 7.0)
    for _ in range(2):
        g.static[0].zero_()
        g._load([t, c])
        assert torch.equal(g.static[0], t)


def test_stage_graph_copies_a_graph_output_every_time():
    """A graph's output buffer changes at each replay without a version
    bump, so a stage that holds it copies it in at every call; one taken
    as its static buffer (``shared``) is never copied."""
    a, b = torch.arange(4.0), torch.zeros(3)
    g = stage_graph.StageGraph(lambda x, y: x, [a, b], "gpet.test",
                               shared=(1,))
    assert g.static[1] is b and g.static[0] is not a
    stage_graph._produced[id(a)] = a
    try:
        assert stage_graph.produced(a) and not stage_graph.produced(b)
        for _ in range(2):
            g.static[0].zero_()
            g._load([a, b])
            assert torch.equal(g.static[0], a)
        assert stage_graph.own(a) is not a and torch.equal(
            stage_graph.own(a), a)
    finally:
        stage_graph.clear()
    assert not stage_graph.produced(a)


def test_add_counts_adds_in_place():
    profiling.reset_counters()
    held = pd.GRAPHS
    profiling.add_counts({"GRAPHS.replay": 3, "LAUNCHES.trsm": 2,
                          "GRAPHS.replay_typo": 9})
    assert held is pd.GRAPHS and pd.GRAPHS["replay"] == 3
    assert profiling.counters()["LAUNCHES.trsm"] == 2
    profiling.add_counts({"LAUNCHES.trsm": -2, "GRAPHS.replay": -3})
    assert set(profiling.counters().values()) == {0}


def _record(names):
    """A profiled tail of one request whose host events are ``names``, one
    span each (name, start µs, duration µs)."""
    from gpet_bench import profile
    return {"profile": {"timeline": profile.Timeline([], names, 0.0, 1e3),
                        "requests": [{"n_iters": [2]}]}}


def test_sample_replay_pct_reads_the_replayed_share():
    """The benchmark's reader: replay spans inside ``gpet.iter`` over the
    sampling stages inside them; None without a replay (a program without
    the graph); stages outside the loop are not counted."""
    from gpet_bench import harness
    read = harness.reader("sample_replay_pct")
    loop = [("gpet.iter", 0.0, 100.0), ("gpet.sample", 1.0, 40.0),
            ("gpet.iter", 200.0, 100.0), ("gpet.sample", 201.0, 40.0),
            ("gpet.sample", 500.0, 40.0)]
    assert read(_record(loop)) is None
    one = loop + [("gpet.sample.replay", 210.0, 5.0),
                  ("gpet.sample.replay", 510.0, 5.0)]
    assert read(_record(one)) == pytest.approx(50.0)
    both = one + [("gpet.sample.replay", 10.0, 5.0)]
    assert read(_record(both)) == pytest.approx(100.0)
    assert harness.reader("sample_ms_per_iter")(_record(both)) == \
        pytest.approx(0.04)


def test_loop_replay_pct_reads_the_replayed_share():
    """The benchmark's reader of the scoring, KDE and selection graphs:
    their replay spans inside ``gpet.iter`` over those stages there; None
    without a replay (a program without these graphs)."""
    from gpet_bench import harness
    read = harness.reader("loop_replay_pct")
    loop = [("gpet.iter", 0.0, 100.0), ("gpet.score", 1.0, 10.0),
            ("gpet.kde", 11.0, 10.0), ("gpet.select", 21.0, 10.0),
            ("gpet.iter", 200.0, 100.0), ("gpet.score", 201.0, 10.0),
            ("gpet.kde", 211.0, 10.0), ("gpet.select", 221.0, 10.0),
            ("gpet.sample.replay", 90.0, 5.0)]
    assert read(_record(loop)) is None
    one = loop + [("gpet.score.replay", 202.0, 5.0),
                  ("gpet.kde.replay", 212.0, 5.0),
                  ("gpet.select.replay", 222.0, 5.0),
                  ("gpet.select.replay", 500.0, 5.0)]
    assert read(_record(one)) == pytest.approx(50.0)
    both = one + [(n + ".replay", t + 1.0, 5.0) for n, t, _ in loop[1:4]]
    assert read(_record(both)) == pytest.approx(100.0)
