"""PyTorch port, warm-started frame sequences: ``_compact_warm_obs``,
``init_state``'s warm-start valid mask and ``trace_sequence`` against the
JAX package's, from the reference's draws; each sequence frame against the
port's own ``run_trace`` from the handed-off state, bitwise.

The reference's final fit runs its batched path, as on the TPU and as the
port's does (``optimize_lml(use_batched=True)``)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_process_edge_trace_torch import interop
from gaussian_process_edge_trace_torch.parallel import sharded as ps
from gaussian_process_edge_trace_torch.trace import driver as pd
from gaussian_process_edge_trace_torch.utils import profiling
from gaussian_process_edge_trace_tpu.parallel import sharded as rs
from gaussian_process_edge_trace_tpu.trace import driver as rd
from torch_parity import (PARALLEL_FINAL_FIT, PARALLEL_KW, JaxDraws,
                          assert_results_match, assert_same_bits,
                          parallel_frames)

torch.set_num_threads(1)


def _compact_both(x, y, valid, U):
    ref_xy, ref_v = rs._compact_warm_obs(jnp.asarray(x), jnp.asarray(y),
                                         jnp.asarray(valid), U)
    got_xy, got_v = ps._compact_warm_obs(torch.tensor(x), torch.tensor(y),
                                         torch.tensor(valid), U)
    return (np.asarray(ref_xy), np.asarray(ref_v), got_xy.numpy(),
            got_v.numpy())


def test_compact_warm_obs_matches_reference_on_its_test_inputs():
    """The JAX test's buffers (test_parallel.py:254-276): over capacity,
    valid entries first in their order; under capacity, padded with
    invalid slots; bitwise the JAX function's."""
    x = np.arange(12, dtype=np.int64)
    y = 100 + np.arange(12, dtype=np.int64)
    valid = np.array([0, 1, 1, 0, 1, 1, 1, 1, 0, 1, 1, 1], bool)
    for n in (12, 3):
        ref_xy, ref_v, got_xy, got_v = _compact_both(x[:n], y[:n],
                                                     valid[:n], 8)
        assert got_xy.shape == (8, 2) and got_v.shape == (8,)
        np.testing.assert_array_equal(got_xy, ref_xy)
        np.testing.assert_array_equal(got_v, ref_v)
    np.testing.assert_array_equal(
        _compact_both(x, y, valid, 8)[2],
        np.stack([x[valid][:8], y[valid][:8]], axis=1))


@pytest.mark.parametrize("n,U", [(40, 24), (24, 24), (17, 24), (0, 8)])
def test_compact_warm_obs_matches_reference_on_random_buffers(n, U):
    """Seeded random buffers over, at and under capacity, bitwise the JAX
    function's."""
    rng = np.random.default_rng(n + U)
    x = rng.integers(0, 500, n)
    y = rng.integers(0, 500, n)
    valid = rng.random(n) < 0.6
    ref_xy, ref_v, got_xy, got_v = _compact_both(x, y, valid, U)
    np.testing.assert_array_equal(got_xy, ref_xy)
    np.testing.assert_array_equal(got_v, ref_v)


def test_warm_state_valid_mask_and_interop():
    """``init_state(..., user_obs_valid)``: ``n_fobs`` counts the valid
    slots, as in the reference (driver.py:294-322), tensors stay tensors,
    and ``from_reference`` carries the reference's warm state with its
    mask."""
    grads, inits = parallel_frames(1)
    cfg = rd.make_config(inits[0], grads.shape[1:], n_user_obs=8,
                         **PARALLEL_KW)
    xy = np.stack([np.arange(8) * 7, 30 + np.arange(8)], axis=1)
    valid = np.array([1, 1, 0, 1, 0, 0, 1, 0], bool)
    ref = rd.init_state(cfg, user_obs_xy=jnp.asarray(xy),
                        user_obs_valid=jnp.asarray(valid))
    data = rd.make_data(cfg, jnp.asarray(grads[0]), jnp.asarray(inits[0]))
    pcfg, _, carried = interop.from_reference(
        cfg._asdict(), jax.device_get(data._asdict()),
        jax.device_get(ref._asdict()), device="cpu")
    mine = pd.init_state(pcfg, "cpu", torch.tensor(xy), torch.tensor(valid))
    assert int(mine.n_fobs) == 4 == int(ref.n_fobs)
    for f in pd.TraceState._fields:
        a, b = getattr(mine, f), getattr(carried, f)
        assert (a == b) if f == "it" else torch.equal(a, b), f
    with pytest.raises(ValueError, match="user_obs_valid"):
        pd.init_state(pcfg, "cpu", xy, valid[:5])


@pytest.fixture(scope="module")
def sequences():
    """The JAX package's and the port's ``trace_sequence`` of three 64²
    frames (test_parallel.py:280-295), the port from the reference's draws:
    ``JaxDraws`` built for the cold config on frame 0 and for the warm
    config on the rest."""
    grads, inits = parallel_frames(3)
    cfg = rd.make_config(inits[0], grads.shape[1:], **PARALLEL_KW)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rd, "optimize_lml",
                   functools.partial(rd.optimize_lml, use_batched=True))
        ref = rs.trace_sequence(cfg, grads, inits)
    pcfg = interop.from_reference(cfg._asdict(), jax.device_get(
        rd.make_data(cfg, jnp.asarray(grads[0]),
                     jnp.asarray(inits[0]))._asdict()), device="cpu")[0]
    rank = pd.prior_factor(pcfg).shape[1]
    made = []

    def draws(c):
        made.append(c)
        return JaxDraws(c, rank)
    got = ps.trace_sequence(pcfg, grads, inits, device="cpu", draws=draws)
    return dict(ref=ref, got=got, cfg=cfg, pcfg=pcfg, grads=grads,
                inits=inits, made=made, rank=rank)


def test_sequence_matches_reference(sequences):
    """Frame by frame, the accepted pixels, iteration counts, observation
    buffers and integer traces equal the reference's, the floats within
    ``test_torch_batch.py``'s tolerances (the final cost within
    ``PARALLEL_FINAL_FIT``'s); the cold config serves frame 0
    and the warm one (n_user_obs = round_up(n_bins, 8)) the rest."""
    ref, got, made = sequences["ref"], sequences["got"], sequences["made"]
    assert len(got) == 3
    cold, warm = ps._sequence_configs(sequences["pcfg"])
    assert made == [cold, warm, warm]
    assert cold.n_user_obs == 0 and warm.n_user_obs % 8 == 0
    assert warm.n_user_obs >= cold.bins.n_bins
    for r, g in zip(ref, got):
        assert g.obs_x.shape == np.asarray(r.obs_x).shape
        assert_results_match(g, jax.device_get(r), PARALLEL_FINAL_FIT)
    assert got[2].n_iters <= got[0].n_iters + 1


def test_partial_warm_start_matches_reference(sequences):
    """A warm frame handed three valid pixels, the other slots masked, is
    too far from convergence to skip the loop: it iterates with the masked
    warm slots in its training set, and the port's ``run_trace`` from that
    state matches the reference's, from the reference's draws."""
    cfg, pcfg, grads, inits = (sequences[k] for k in ("cfg", "pcfg", "grads",
                                                      "inits"))
    first = jax.device_get(sequences["ref"][0])
    keep = np.flatnonzero(np.asarray(first.obs_valid))[:3]
    _, warm = ps._sequence_configs(pcfg)
    U = warm.n_user_obs
    xy = np.zeros((U, 2), np.int64)
    xy[:3] = np.stack([np.asarray(first.obs_x)[keep],
                       np.asarray(first.obs_y)[keep]], axis=1)
    valid = np.arange(U) < 3
    rwarm = cfg._replace(n_user_obs=U, n_train=warm.n_train)
    rdata = rd.make_data(rwarm, jnp.asarray(grads[1]), jnp.asarray(inits[1]))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rd, "optimize_lml",
                   functools.partial(rd.optimize_lml, use_batched=True))
        ref = jax.device_get(rd.run_trace(rwarm, rdata, rd.init_state(
            rwarm, user_obs_xy=jnp.asarray(xy),
            user_obs_valid=jnp.asarray(valid))))
    got = pd.run_trace(warm, pd.make_data(warm, grads[1], inits[1], "cpu"),
                       pd.init_state(warm, "cpu", torch.tensor(xy),
                                     torch.tensor(valid)),
                       JaxDraws(warm, sequences["rank"]))
    assert got.n_iters > 0
    assert_results_match(got, ref, PARALLEL_FINAL_FIT)


def test_sequence_frames_equal_their_runs_from_the_handoff(sequences):
    """Each frame equals, bit for bit, the port's ``run_trace`` of that
    frame from the state handed off by the frame before it."""
    got, pcfg = sequences["got"], sequences["pcfg"]
    cold, warm = ps._sequence_configs(pcfg)
    for f in range(3):
        c = cold if f == 0 else warm
        data = pd.make_data(c, sequences["grads"][f], sequences["inits"][f],
                            "cpu")
        if f == 0:
            state = pd.init_state(c, "cpu")
        else:
            prev = got[f - 1]
            xy, valid = ps._compact_warm_obs(prev.obs_x, prev.obs_y,
                                             prev.obs_valid, c.n_user_obs)
            state = pd.init_state(c, "cpu", xy, valid)
            assert int(state.n_fobs) == int(prev.obs_valid.sum())
        single = pd.run_trace(c, data, state,
                              JaxDraws(c, sequences["rank"]))
        assert_same_bits(got[f], single)


def test_sequence_default_draws_and_host_reads(sequences):
    """With its default draws, each frame reads the host once before its
    loop, once after each iteration and once in ``finish_trace``, and
    waits for every other blocking copy where its code path makes one:
    its init points to the device, its state's scalars (the warm frames
    count their hand-off on the device), the selection's tables once, the
    final fit's bounds, grid and step sizes; the prior factor once for the
    sequence. The jitter ladders of the sampling round and of the final fit
    and the selection wait for nothing, and on the CPU each of an
    iteration's four stages runs op by op."""
    profiling.reset_counters()
    res = ps.trace_sequence(sequences["pcfg"], torch.tensor(
        sequences["grads"]), sequences["inits"], device="cpu")
    n = sum(r.n_iters for r in res)
    assert pd.HOST_READS == dict(
        dict.fromkeys(pd.HOST_READS, 0), active=n + 3, finish=3, data=4,
        init=4, consts=3, fit=12)
    assert pd.GRAPHS == dict(capture=0, replay=0, eager=4 * n, failed=0)
    assert all(r.edge_trace.shape == (64, 2) for r in res)
