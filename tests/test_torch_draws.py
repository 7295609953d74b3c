"""PyTorch port, the default draw layout (``trace/driver.py::TorchDraws``):
one generator seed per (tracer seed, ensemble member, iteration or restart)
stream, packed so that no two streams share one: for seed < 2¹⁶, member <
64 and it < 1022 within the 32 bits the CPU generator keeps, and beyond
that, on the card only, in 64 bits."""

import numpy as np
import pytest
import torch

from gaussian_process_edge_trace_torch.trace import driver as pd
from torch_parity import SMALL_KW, small_problem

torch.set_num_threads(1)


def _cfg(**kw):
    _, _, grad, init = small_problem()
    return pd.make_config(init, grad.shape, **dict(SMALL_KW, **kw))


def _streams(cfg, seed, member):
    """Every generator seed of one tracer seed and member: the restarts and
    iterations 0..max_iters."""
    d = pd.TorchDraws(cfg._replace(seed=seed), 8, "cpu", member=member)
    return [d.restart_seed()] + [d.iteration_seed(it)
                                 for it in range(cfg.max_iters + 1)]


def test_layout_is_injective_over_the_stated_ranges():
    """The streams of one seed (64 members × the restarts and iterations
    0..max_iters) are distinct and below 2¹⁶, and a seed's streams are
    those of seed 0 offset by seed·2¹⁶ for every seed < 2¹⁶: so no two
    (seed, member, stream) triples share a generator seed, and every one
    lies in [0, 2³²)."""
    cfg = _cfg()
    low = [k for m in range(64) for k in _streams(cfg, 0, m)]
    assert len(set(low)) == len(low) == 64 * (cfg.max_iters + 2)
    assert max(low) < 2 ** 16
    rng = np.random.default_rng(0)
    for seed in [1, 2, 2 ** 15, 2 ** 16 - 1] + rng.integers(
            0, 2 ** 16, 40).tolist():
        for m in (0, 1, 63, int(rng.integers(64))):
            assert _streams(cfg, seed, m) == [
                k + seed * 2 ** 16 for k in _streams(cfg, 0, m)]
    top = _streams(cfg, 2 ** 16 - 1, 63)
    assert max(top) < 2 ** 32


def test_consecutive_seeds_share_no_normals():
    """Seed s + 1 does not replay seed s's normals one iteration later, as
    a layout ``seed + it + 1`` would: no stream of one is a stream of the
    other, and their normals differ at every pair of iterations checked."""
    cfg = _cfg()
    for s in (1, 2, 41):
        assert not set(_streams(cfg, s, 0)) & set(_streams(cfg, s + 1, 0))
    a = pd.TorchDraws(cfg, 8, "cpu")
    b = pd.TorchDraws(cfg._replace(seed=cfg.seed + 1), 8, "cpu")
    za = [a.normals(it)[0] for it in range(4)]
    zb = [b.normals(it)[0] for it in range(4)]
    assert not any(torch.equal(x, y) for x in za for y in zb)


def test_member_zero_is_the_single_trace_source():
    """``run_trace``'s default draws are member 0's: the same trace, bit
    for bit."""
    _, _, grad, init = small_problem()
    cfg = pd.make_config(init, grad.shape, **dict(SMALL_KW, max_iters=3))
    data = pd.make_data(cfg, grad, init, "cpu")
    plain = pd.run_trace(cfg, data, pd.init_state(cfg, "cpu"))
    member0 = pd.run_trace(cfg, data, pd.init_state(cfg, "cpu"),
                           pd.TorchDraws(cfg, data.L_prior_unit.shape[1],
                                         "cpu", member=0))
    for f in pd.TraceResult._fields:
        x, y = getattr(plain, f), getattr(member0, f)
        assert (x == y) if not isinstance(x, torch.Tensor) else \
            torch.equal(x, y), f


def test_columns_are_the_full_draws_columns():
    """``normals(it, cols)`` is the slice of the full draws: a sample shard
    draws what one device draws for its samples."""
    d = pd.TorchDraws(_cfg(), 8, "cpu")
    z, w = d.normals(2)
    zs, ws = d.normals(2, slice(64, 128))
    assert torch.equal(zs, z[:, 64:128]) and torch.equal(ws, w[:, 64:128])
    fz, fw = pd.FrameDraws([d, d]).normals(2, slice(0, 64))
    assert torch.equal(fz[1], z[:, :64]) and torch.equal(fw[0], w[:, :64])


def test_layout_bounds_raise():
    """On the CPU, whose generator keeps 32 bits of a seed, a member outside
    [0, 64), or more iterations than the 10 slot bits hold, would reach
    another seed's streams: refused."""
    cfg = _cfg()
    for m in (-1, 64):
        with pytest.raises(ValueError, match="member"):
            pd.TorchDraws(cfg, 8, "cpu", member=m)
    with pytest.raises(ValueError, match="max_iters"):
        pd.TorchDraws(cfg._replace(max_iters=1023), 8, "cpu")
    pd.TorchDraws(cfg._replace(max_iters=1022), 8, "cpu")


def _used_streams(cfg, seed, member):
    """The generator seeds a trace of one tracer seed and member draws:
    the restarts and iterations 0..max_iters-1."""
    d = pd.TorchDraws(cfg._replace(seed=seed), 8, "cpu", member=member)
    return [d.restart_seed()] + [d.iteration_seed(it)
                                 for it in range(cfg.max_iters)]


@pytest.mark.parametrize("max_iters", [48, 1022])
def test_seed_streams_collide_with_no_trace_stream(max_iters):
    """``SeedDraws`` (``fit_predict_GP(seed=k)`` and ``preview_samples``,
    the reference's unfolded ``PRNGKey(k)``) takes slot 1023 of member 0:
    over every seed below 2¹⁶ its generator seeds are distinct, and none is
    a stream of any trace (every member, the restarts and every iteration,
    at the largest ``max_iters`` the layout takes too)."""
    cfg = _cfg(max_iters=max_iters)
    seed_streams = {pd.SeedDraws(cfg, 8, "cpu", s).seed
                    for s in range(2 ** 16)}
    assert len(seed_streams) == 2 ** 16
    assert all(k % 2 ** 16 == pd.SEED_SLOT for k in seed_streams)
    # Trace streams are seed·2¹⁶ plus an offset below 2¹⁶ that depends on
    # the member and the slot alone (test_layout_is_injective_...), so one
    # seed's offsets cover every seed's.
    offsets = {k for m in range(64) for k in _used_streams(cfg, 0, m)}
    assert pd.SEED_SLOT not in offsets
    for s in (1, 2, 2 ** 15, 2 ** 16 - 1):
        assert not seed_streams & set(_used_streams(cfg, s, 0))


def test_seed_draws_of_one_seed_repeat_and_differ_from_another():
    """One seed's draws repeat; another seed's differ; the normals' noise
    rows follow the buffer's length."""
    cfg = _cfg()
    a = pd.SeedDraws(cfg, 8, "cpu", 1)
    z, w = a.sample_normals(24)
    assert z.shape == (8, cfg.N_samples) and w.shape == (24, cfg.N_samples)
    z2, w2 = a.sample_normals(24)
    assert torch.equal(z, z2) and torch.equal(w, w2)
    assert torch.equal(a.restarts(), pd.SeedDraws(cfg, 8, "cpu", 1)
                       .restarts())
    b = pd.SeedDraws(cfg, 8, "cpu", 2)
    assert not torch.equal(b.sample_normals(24)[0], z)
    assert not torch.equal(b.restarts(), a.restarts())


# Generator seeds of the 32-bit packing, s·2¹⁶ + m·2¹⁰ + t, written out:
# (tracer seed, member, iteration or None for the restarts, seed).
IN_RANGE = [(1, 0, 0, 65537), (1, 0, None, 65536), (3, 0, 10, 196619),
            (41, 4, 7, 2691080), (2 ** 16 - 1, 63, 1021, 4294967294),
            (0, 0, 0, 1)]


@pytest.mark.parametrize("s,m,it,want", IN_RANGE)
def test_in_range_streams_keep_their_seeds(s, m, it, want):
    """Every stream of the 32-bit packing keeps the generator seed it had,
    whatever ``max_iters`` is and on either device, and its normals are
    that seed's: the gates and bitwise checks that rest on them hold."""
    for max_iters in (48, 1022):
        cfg = _cfg(seed=s, max_iters=max_iters)
        d = pd.TorchDraws(cfg, 8, "cpu", member=m)
        got = d.restart_seed() if it is None else d.iteration_seed(it)
        assert got == want
        card = pd.TorchDraws(cfg._replace(max_iters=1100), 8, "cuda",
                             member=m)
        assert (card.restart_seed() if it is None
                else card.iteration_seed(it)) == want
    if it is not None:
        g = torch.Generator().manual_seed(want)
        assert torch.equal(d.normals(it)[0],
                           torch.randn((8, cfg.N_samples), generator=g))
    assert pd.SeedDraws(_cfg(), 8, "cpu", s).seed == s * 2 ** 16 + 1023


@pytest.mark.parametrize("kw,member,match", [
    ({"seed": 2 ** 16 + 1}, 0, "tracer seed"), ({}, 64, "member"),
    ({"max_iters": 1023}, 0, "max_iters"), ({"seed": -1}, 0, "tracer seed")])
def test_cpu_refuses_streams_beyond_32_bits(kw, member, match):
    """On the CPU, seed 2¹⁶ + 1, member 64 and ``max_iters`` = 1023 raise
    an error that names the limit, instead of giving seed 1's streams, a
    stream of member 0 of the next seed, or SeedDraws' stream; so does a
    negative seed, on either device. The card takes the first three."""
    cfg = _cfg(**kw)
    with pytest.raises(ValueError, match=match):
        pd.TorchDraws(cfg, 8, "cpu", member=member)
    if kw.get("seed", 0) >= 0:
        pd.TorchDraws(cfg, 8, "cuda", member=member)
    if "seed" in kw:
        with pytest.raises(ValueError, match="tracer seed"):
            pd.SeedDraws(cfg, 8, "cpu", kw["seed"])


def test_wide_layout_is_injective():
    """Every stream of both packings, over seeds, members and slots at and
    around each limit, with SeedDraws' seeds, takes a generator seed of its
    own; those of the 64-bit packing lie at 2³² and above, within 64 bits.
    (The layout is integer arithmetic: no draw is made here.)"""
    seeds = [0, 1, 2, 2 ** 16 - 1, 2 ** 16, 2 ** 16 + 1, 2 ** 31 - 1]
    members = [0, 1, 63, 64, 65, 2 ** 16 - 1]
    its = [0, 1, 1020, 1021, 1022, 1023, 2 ** 16 - 3]
    got, wide = [], []
    for s in seeds:
        cfg = _cfg(seed=s, max_iters=2 ** 16 - 2)
        for m in members:
            d = pd.TorchDraws(cfg, 8, "cuda", member=m)
            row = [d.restart_seed()] + [d.iteration_seed(it) for it in its]
            got += row
            narrow = s < 2 ** 16 and m < 64
            wide += [k for k, it in zip(row, [-1] + its)
                     if not (narrow and it < 1022)]
        got.append(pd.SeedDraws(cfg, 8, "cuda", s).seed)
    assert len(set(got)) == len(got)
    assert all(2 ** 32 <= k < 2 ** 64 for k in wide)
    with pytest.raises(ValueError, match="max_iters"):
        pd.TorchDraws(_cfg(max_iters=2 ** 16 - 1), 8, "cuda")
    with pytest.raises(ValueError, match="member"):
        pd.TorchDraws(_cfg(), 8, "cuda", member=2 ** 16)
