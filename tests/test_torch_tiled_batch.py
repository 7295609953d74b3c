"""PyTorch port against the JAX package's tiled batch: 16 frames, which
``trace_batch_vmap`` runs as two tiles of 8 through ``lax.map``, each tile
ending its loop when its own slowest frame is done
(``parallel/sharded.py:309-370`` of the JAX package). The port runs one
lockstep loop over all 16 frames until the slowest is done and keeps each
finished frame as it was, so both must give every frame the same result:
the reference's tiling moves when a frame stops, not what it computes.

The reference's final fit runs its batched path, as on the TPU and as the
port's does."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_process_edge_trace_torch import interop
from gaussian_process_edge_trace_torch.parallel import sharded as ps
from gaussian_process_edge_trace_torch.trace import driver as pd
from gaussian_process_edge_trace_tpu.parallel import sharded as rs
from gaussian_process_edge_trace_tpu.trace import driver as rd
from torch_parity import (SMALL_IMG, SMALL_KW, JaxDraws,
                          assert_results_match, assert_same_bits,
                          small_problem)

torch.set_num_threads(1)

# Image seeds of the 16 frames, from the port's iteration counts over image
# seeds 1-80 at these draws: the first tile's frames stop after 3 or 4
# iterations (seed 2: 4), the second's after 3 or 2 (seed 68: 2), so each
# tile holds frames that stop apart and the second tile ends its loop one
# iteration before the first (checked below).
SEEDS = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 13, 14, 15, 16, 17, 68)
TILE = 8
# log σn² below which the final fit's noise level is not identified: the
# LML Gram's diagonal is σn²·w + 1e-6 with weights w <= 1
# (``models/gpr.py::_batched_lml``), so there σn² adds under 1% of the
# jitter and the LML is flat in it. On image seed 8 the two packages' fits
# stop at log σn² = -20.5 (port) and -41.4 (reference), at LMLs 1.6e-5
# apart and mean curves 2.6e-4 px apart.
NOISE_FLOOR = float(np.log(1e-8))


def _frame_data(data, f):
    """Frame ``f`` of a batched TracerData (the shared leaves as they are)."""
    own = ("grad_img", "grad_kde", "grad_cols", "init_x", "init_y")
    return pd.TracerData(**{k: v[f] if k in own else v
                            for k, v in data._asdict().items()})


@pytest.fixture(scope="module")
def tiled():
    """The reference's ``trace_batch_vmap`` of 16 frames (two tiles) and
    the port's ``trace_batch`` of the same frames from the same draws."""
    probs = [small_problem(dict(SMALL_IMG, seed=s)) for s in SEEDS]
    grads = np.stack([p[2] for p in probs])
    inits = np.stack([p[3] for p in probs])
    cfg = rd.make_config(inits[0], grads.shape[1:], **SMALL_KW)
    data = rs.make_batch_data(cfg, jnp.asarray(grads), jnp.asarray(inits))
    states = rs.make_batch_state(cfg, len(SEEDS))
    assert rs._batch_tile(len(SEEDS)) == TILE
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rd, "optimize_lml",
                   functools.partial(rd.optimize_lml, use_batched=True))
        ref = jax.device_get(rs.trace_batch_vmap(cfg, data, states))
    pcfg, pdata, pstates = interop.from_reference(
        cfg._asdict(), jax.device_get(data._asdict()),
        jax.device_get(states._asdict()), device="cpu")
    draws = JaxDraws(pcfg, pdata.L_prior_unit.shape[1])
    got = ps.trace_batch(pcfg, pdata, pstates, draws)
    return dict(ref=ref, got=got, pcfg=pcfg, pdata=pdata, draws=draws)


def test_tiled_batch_matches_reference(tiled):
    """Every frame of the port's lockstep batch against the reference's
    tiled batch: the accepted pixels, iteration counts, thresholds and
    integer traces equal, the floats within ``torch_parity``'s tolerance.
    In each tile the frames stop at different iterations, and the two
    tiles' slowest frames at different ones, so the reference's tiles end
    their loops apart while the port's one loop runs to the batch's
    slowest frame. A noise level that neither fit can identify (both below
    ``NOISE_FLOOR``) is not compared."""
    ref, got = tiled["ref"], tiled["got"]
    n = np.asarray(ref.n_iters)
    tiles = [n[t:t + TILE] for t in range(0, len(SEEDS), TILE)]
    assert all(len(set(t.tolist())) > 1 for t in tiles), n
    assert len({int(t.max()) for t in tiles}) > 1, n
    np.testing.assert_array_equal(got.n_iters.numpy(), n)
    # Where both fits put σn² below NOISE_FLOOR, log σn² is not compared;
    # elsewhere θ is held as every other field.
    ref_theta, theta = np.asarray(ref.theta), got.theta.clone()
    low = (ref_theta[:, 2] < NOISE_FLOOR) & (theta[:, 2].numpy() < NOISE_FLOOR)
    theta[torch.from_numpy(low), 2] = torch.from_numpy(ref_theta[low, 2]).to(
        theta.dtype)
    assert_results_match(got._replace(theta=theta), ref)


def test_tiled_batch_frames_equal_their_single_traces(tiled):
    """Each of the 16 frames is bit for bit the port's ``run_trace`` of
    that frame alone, whichever tile and iteration it stopped at."""
    got, pcfg, pdata = (tiled[k] for k in ("got", "pcfg", "pdata"))
    for f in range(len(SEEDS)):
        single = pd.run_trace(pcfg, _frame_data(pdata, f),
                              pd.init_state(pcfg, "cpu"), tiled["draws"])
        assert_same_bits(pd.frame_of(got, f), single)
