"""PyTorch port, its tracing on the CPU: the ``gpet.*`` spans of a tiny
single trace and of a 3-frame batch under ``torch.profiler`` (one run, one
loop of ``gpet.iter`` spans with four stages each, one final fit, one
``gpet.wait.<kind>`` span for every counted wait), nothing of the profiler
entered without one, the same bits either way, the module counters'
snapshot and reset, and the waits of one trace's state at the driver's
public edge: none to run it as a batch of one, or to step it, and one to
read a batched state's iteration count."""

import numpy as np
import pytest
import torch

import gaussian_process_edge_trace_torch as gpt
from gaussian_process_edge_trace_torch.ops import collectives
from gaussian_process_edge_trace_torch.ops import cuda_chol as cc
from gaussian_process_edge_trace_torch.ops import cuda_frames as cf
from gaussian_process_edge_trace_torch.ops import cuda_interp as ci
from gaussian_process_edge_trace_torch.ops import prng
from gaussian_process_edge_trace_torch.parallel import sharded as ps
from gaussian_process_edge_trace_torch.trace import cuda_kde as ck
from gaussian_process_edge_trace_torch.trace import driver as pd
from gaussian_process_edge_trace_torch.utils import profiling
from torch_parity import assert_same_bits

torch.set_num_threads(1)

KW = dict(kernel_options={"kernel": "RBF", "sigma_f": 20, "length_scale": 8},
          noise_y=1, N_samples=256, score_thresh=1, delta_x=6,
          keep_ratio=0.1, pixel_thresh=4, seed=1, fix_endpoints=True)
STAGES = ("gpet.sample", "gpet.score", "gpet.kde", "gpet.select")


def _image(seed):
    img, edge = gpt.construct_test_img((64, 96), 40, 2, 0.03, "sinusoidal",
                                       0.3, seed=seed)
    grad = gpt.comp_grad_img(img, gpt.kernel_builder((9, 5)), device="cpu")
    return grad, np.array([[0, edge[0, 0]], [95, edge[95, 0]]])


def _single():
    """A tiny ``GP_Edge_Tracing(...)()``: ``(n_iters per frame, outputs)``."""
    grad, init = _image(1)
    tracer = gpt.GP_Edge_Tracing(
        init, grad, KW["kernel_options"], KW["noise_y"], np.array([]),
        KW["N_samples"], KW["score_thresh"], KW["delta_x"],
        KW["keep_ratio"], KW["pixel_thresh"], KW["seed"], True,
        KW["fix_endpoints"], device="cpu")
    edge, cred = tracer()
    return [tracer.last_result.n_iters], [edge, *cred]


def _batch():
    """A 3-frame ``trace_batch``: ``(n_iters per frame, outputs)``."""
    frames = [_image(s) for s in (1, 2, 3)]
    grads = torch.stack([g for g, _ in frames])
    inits = np.stack([i for _, i in frames])
    cfg = pd.make_config(inits[0], tuple(grads.shape[1:]), **KW)
    data = ps.make_batch_data(cfg, grads, inits, device="cpu")
    states = ps.make_batch_state(cfg, 3, device="cpu")
    res = ps.trace_batch(cfg, data, states)
    return res.n_iters.tolist(), [res.edge_trace, res.cred_interval]


RUNS = {"single": _single, "batch": _batch}


def _problem():
    """The single run's config and data, without the tracer."""
    grad, init = _image(1)
    cfg = pd.make_config(init, tuple(grad.shape), **KW)
    return cfg, pd.make_data(cfg, grad, init, device="cpu")


def _profiled(run):
    """``run()`` under a CPU ``torch.profiler``: its result, its spans as
    ``{name: [(start, end)]}`` sorted, and the counters' change."""
    profiling.reset_counters()
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        out = run()
    spans = {}
    for e in prof.events():
        if e.name.startswith("gpet."):
            spans.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.end))
    return out, {k: sorted(v) for k, v in spans.items()}, \
        profiling.counters()


@pytest.fixture(scope="module", params=sorted(RUNS))
def traced(request):
    return request.param, _profiled(RUNS[request.param])


def test_spans_make_one_tree_per_trace(traced):
    """One ``gpet.run_trace``; one ``gpet.iter`` per loop iteration (the
    longest frame's, for the batch), each holding each stage span once,
    the four covering at least 90% of it; one ``gpet.finish``; one
    ``gpet.wait.<kind>`` span for each wait that ``HOST_READS`` counts;
    no per-frame calls on the CPU; the constructor's span for the single
    trace."""
    name, ((n_iters, _), spans, counts) = traced
    assert len(spans["gpet.run_trace"]) == 1
    iters = spans["gpet.iter"]
    assert len(iters) == max(n_iters)
    for stage in STAGES:
        got = spans[stage]
        assert len(got) == len(iters)
        for (a, b), (s, e) in zip(iters, got):
            assert a <= s and e <= b, stage
    for (a, b), *stages in zip(iters, *(spans[s] for s in STAGES)):
        assert sum(e - s for s, e in stages) >= 0.9 * (b - a)
    (fa, fb), = spans["gpet.finish"]
    (ra, rb), = spans["gpet.run_trace"]
    assert ra <= iters[0][0] and iters[-1][1] <= fa and fb <= rb
    waits = {k[len("gpet.wait."):]: len(v) for k, v in spans.items()
             if k.startswith("gpet.wait.")}
    reads = {k[len("HOST_READS."):]: v for k, v in counts.items()
             if k.startswith("HOST_READS.") and v}
    assert waits == reads
    assert reads["active"] == max(n_iters) + 1
    assert "gpet.frame_by_frame" not in spans
    assert len(spans.get("gpet.construct", [])) == (name == "single")


@pytest.mark.parametrize("name", sorted(RUNS))
def test_no_profiler_enters_no_record_function(name, monkeypatch):
    """Without a profiler no span enters ``record_function``, and the
    results equal the profiled run's bit for bit."""
    (_, want), _, _ = _profiled(RUNS[name])

    def refuse(*a, **kw):
        raise AssertionError("record_function entered without a profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    _, got = RUNS[name]()
    for a, b in zip(got, want):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_span_is_a_shared_null_context_when_off():
    assert profiling.span("gpet.iter") is profiling.span("gpet.kde")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        on = profiling.span("gpet.iter")
    assert isinstance(on, torch.profiler.record_function)


def test_counters_snapshot_and_reset_in_place():
    """``counters()`` holds every key of every module counter dict once;
    ``reset_counters()`` zeroes each dict in place, so the names the
    modules and their callers hold read 0."""
    dicts = {"LAUNCHES": (ci.LAUNCHES, ck.LAUNCHES, cc.LAUNCHES,
                          prng.LAUNCHES, cf.LAUNCHES),
             "BLOCKED": (cc.BLOCKED,), "HOST_READS": (pd.HOST_READS,),
             "HOST_BYTES": (pd.HOST_BYTES,),
             "COLLECTIVES": (collectives.COLLECTIVES,),
             "GRAPHS": (pd.GRAPHS,)}
    want = {f"{n}.{k}" for n, ds in dicts.items() for d in ds for k in d}
    assert set(profiling.counters()) == want
    assert len(want) == sum(len(d) for ds in dicts.values() for d in ds)
    held = pd.HOST_READS
    pd.HOST_READS["consts"] += 3
    ci.LAUNCHES["fused_cost"] += 2
    assert profiling.counters()["HOST_READS.consts"] >= 3
    profiling.reset_counters()
    assert held is pd.HOST_READS is profiling.HOST_READS
    assert set(profiling.counters().values()) == {0}
    assert ci.LAUNCHES["fused_cost"] == 0


def test_to_host_reads_a_tuple_as_one_wait():
    profiling.reset_counters()
    a, b = pd.to_host((torch.arange(3), torch.ones(2, 2)), "result")
    assert torch.equal(a, torch.arange(3)) and b.shape == (2, 2)
    assert pd.HOST_READS["result"] == 1
    assert pd.HOST_BYTES["result"] == 3 * 8 + 4 * 4


@pytest.mark.parametrize("name", sorted(RUNS))
def test_active_reads_bound_what_each_iteration_launched(name):
    """The benchmark ties a device operation to the loop iteration that
    launched it by the loop's reads of its active mask
    (``gpet_bench/metrics/_device.py``): an iteration's operations run
    between the end of the read before its ``gpet.iter`` span and the end
    of the read inside it. Here each ATen operator of a tiny profiled trace
    stands for a launch; a device that runs each iteration's launches just
    before its read returns, long after the stages closed, and every other
    launch at once, gives the reader exactly the iterations' launches. So
    nothing is launched between a read and the next iteration. (Between
    them ``.tolist()`` of the read's host copy resolves its conjugate and
    negative bits: no operator of the device's.)"""
    from gpet_bench import profile as bench_profile
    from gpet_bench.metrics import _device

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        RUNS[name]()
    events = list(prof.events())
    host = [(e.name, float(e.time_range.start),
             float(e.time_range.elapsed_us()))
            for e in events if e.name.startswith("gpet.")]
    iters = sorted((s, s + d) for n, s, d in host if n == "gpet.iter")
    reads = sorted(s + d for n, s, d in host if n == _device.ACTIVE)
    host_only = ("aten::resolve_conj", "aten::resolve_neg")
    launches = sorted(float(e.time_range.start) for e in events
                      if e.name.startswith("aten::")
                      and e.name not in host_only)
    inside = [[t for t in launches if a <= t <= b] for a, b in iters]
    device, want = [], []
    for (a, b), ts in zip(iters, inside):
        end = max(r for r in reads if a < r <= b)
        for i in range(len(ts)):
            name_i = f"void at::native::op_{len(device)}"
            device.append((name_i, "kernel", end - (len(ts) - i) * 1e-3,
                           1e-4))
            want.append(name_i)
    for t in launches:
        if not any(a <= t <= b for a, b in iters):
            device.append((f"void at::native::op_{len(device)}", "kernel",
                           t, 1e-4))
    assert sum(map(len, inside)) > 0 and len(device) == len(launches)
    tl = bench_profile.Timeline(device, host, min(launches),
                                max(launches) + 1.0)
    ops, n = _device.loop_ops({"profile": {"timeline": tl}})
    assert n == len(iters)
    assert [o for o, _, _ in ops] == want


def test_k8_bound_follows_the_programs_blur_rule():
    """The benchmark's K8 bound counts a banded blur product for each axis
    of the (M + 2, N + 2) KDE grid that the program blurs as a matmul, at
    the program's band."""
    from gaussian_process_edge_trace_torch.trace import kde
    from gpet_bench.metrics import K8_roofline

    assert K8_roofline.BLUR_MATMUL_MAX == kde._BLUR_MATMUL_MAX
    assert K8_roofline.BAND == kde.DEFAULT_RADIUS
    for M, N in ((500, 500), (500, 700), (700, 500), (700, 700)):
        mats = kde.blur_matrices(M, N) or (None, None)
        assert [m is not None for m in mats] == [
            s + 2 <= K8_roofline.BLUR_MATMUL_MAX for s in (M, N)]
        if mats[0] is not None or mats[1] is not None:
            assert mats.band == K8_roofline.BAND


def test_single_trace_runs_as_a_batch_of_one_with_no_crossing_wait():
    """One trace's ``run_trace`` runs as a batch of one: nothing lifts its
    state with a wait or reads its iteration count back (its waits are
    the loop's active reads and the final fit's), and its result is frame
    0 of the same trace run as a batch of one, bit for bit."""
    cfg, data = _problem()
    state0 = pd.init_state(cfg, device="cpu")
    profiling.reset_counters()
    got = pd.run_trace(cfg, data, state0)
    assert "lift" not in pd.HOST_READS
    assert {k for k, v in pd.HOST_READS.items() if v} == {
        "active", "consts", "fit", "finish"}
    assert pd.HOST_READS["active"] == got.n_iters + 1
    assert pd.HOST_READS["finish"] == 1
    batch = pd.run_trace(cfg, data, ps.make_batch_state(cfg, 1,
                                                        device="cpu"))
    assert_same_bits(got, pd.frame_of(batch, 0))
    loop = pd.run_loop(cfg, data, state0)
    assert isinstance(loop.it, int) and loop.it == got.n_iters


def test_trace_step_waits_for_nothing_and_steps_to_run_trace():
    """``trace_step`` lifts one trace's state and takes it back out at the
    iteration the host counts: a step waits for nothing, neither for its
    iteration count nor in the selection. Stepped to the end and finished,
    the trace is ``run_trace``'s bit for bit."""
    cfg, data = _problem()
    inv = pd.loop_invariants(cfg, data)
    state = pd.init_state(cfg, device="cpu")
    profiling.reset_counters()
    steps = 0
    while int(state.n_fobs) < cfg.algo_thresh and state.it < cfg.max_iters:
        state, samples = pd.trace_step(cfg, data, state, invariants=inv)
        steps += 1
        assert isinstance(state.it, int) and state.it == steps
        assert samples.shape == (cfg.edge_length, cfg.N_samples)
    assert steps > 1
    assert pd.HOST_READS == dict.fromkeys(pd.HOST_READS, 0)
    draws = pd.StreamDraws(cfg, data.L_prior_unit.shape[1], "cpu")
    assert_same_bits(pd.finish_trace(cfg, data, state, draws),
                     pd.run_trace(cfg, data, pd.init_state(cfg, device="cpu"),
                                  draws))


def test_frame_of_a_batched_state_reads_its_iteration_once():
    """A batched state's iteration count lives on the device, so taking a
    frame out as one trace's state reads it, in one wait of kind
    ``frame``; a batched result's counts are on the host already."""
    cfg, data = _problem()
    state, _ = pd.trace_step(cfg, data, pd.init_state(cfg, device="cpu"))
    batch = pd._lift(state)
    assert batch.it.device.type == "cpu" and batch.it.shape == (1,)
    profiling.reset_counters()
    one = pd.frame_of(batch, 0)
    assert pd.HOST_READS == dict(dict.fromkeys(pd.HOST_READS, 0), frame=1)
    assert isinstance(one.it, int) and one.it == state.it == 1
    for k in pd.TraceState._fields:
        if k != "it":
            assert torch.equal(getattr(one, k), getattr(state, k)), k
    res = pd.run_trace(cfg, data, batch)
    profiling.reset_counters()
    pd.frame_of(res, 0)
    assert set(pd.HOST_READS.values()) == {0}
