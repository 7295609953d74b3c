"""The port's batches at an odd edge length against the JAX package's tiled
batch and against their own single traces.

At an odd E the curve cost runs unfused in both packages: the column
interpolation, then the Simpson sums over E with their even-count tail
(``ops/cuda_interp.py::line_and_arc``), in every loop iteration and in the
final cost. 16 frames make the JAX package's ``trace_batch_vmap`` run two
tiles of 8 through ``lax.map`` (``parallel/sharded.py:309-370`` of the JAX
package), each ending its loop when its own slowest frame is done; the port
runs one lockstep loop over all 16. On the card the port's sums over E are
``ops/sums.py::fixed_sum``'s fixed tree, whose order does not depend on the
number of frames; here it is forced on the CPU. Last, ``chip_smoke.py``'s
comparison of a batch frame with its single trace covers every
``TraceResult`` field.
"""

import functools
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_process_edge_trace_torch import interop
from gaussian_process_edge_trace_torch.ops import cuda_interp as ci
from gaussian_process_edge_trace_torch.ops import sums
from gaussian_process_edge_trace_torch.parallel import sharded as ps
from gaussian_process_edge_trace_torch.trace import driver as pd
from gaussian_process_edge_trace_torch.trace import scoring
from gaussian_process_edge_trace_tpu.parallel import sharded as rs
from gaussian_process_edge_trace_tpu.trace import driver as rd
from torch_parity import (SMALL_IMG, SMALL_KW, JaxDraws,
                          assert_results_match, assert_same_bits,
                          small_problem)

sys.path.append(str(pathlib.Path(__file__).resolve().parents[1]))

torch.set_num_threads(1)

ODD_IMG = dict(SMALL_IMG, size=(64, 95))        # E = 95
# Image seeds of the 16 frames, from the port's iteration counts over image
# seeds 1-800 at these draws (every frame stops after 3 iterations but 27,
# which stop after 2): the first tile holds frames that stop after 3 and 2
# iterations (seed 260: 2), the second only frames that stop after 2, so
# the second tile ends its loop one iteration before the first (checked
# below) while the port's loop runs to the batch's slowest frame.
SEEDS = (1, 2, 3, 4, 5, 6, 7, 260, 34, 54, 124, 176, 204, 213, 233, 235)
TILE = 8
# The fixed tree and torch.sum round the same sums apart (each within
# log2(E) roundings of the exact sum): the relative tolerance between the
# card's sums over E and the CPU's.
TREE_RTOL = 1e-6


def _frame_data(data, f):
    """Frame ``f`` of a batched TracerData (the shared leaves as they are)."""
    own = ("grad_img", "grad_kde", "grad_cols", "init_x", "init_y")
    return pd.TracerData(**{k: v[f] if k in own else v
                            for k, v in data._asdict().items()})


@pytest.fixture(scope="module")
def tiled():
    """The reference's ``trace_batch_vmap`` of 16 odd-E frames (two tiles)
    and the port's ``trace_batch`` of the same frames from the same
    draws."""
    probs = [small_problem(dict(ODD_IMG, seed=s)) for s in SEEDS]
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
    return dict(ref=ref, got=got, pcfg=pcfg, pdata=pdata, pstates=pstates,
                draws=draws)


def test_odd_tiled_batch_matches_reference_and_single_traces(tiled):
    """16 frames at E = 95: the port's lockstep batch against the
    reference's two tiles, the tiles ending their loops at different
    iterations, and each frame bit for bit the port's ``run_trace`` of
    that frame alone.

    Against the reference, the loop's fields (accepted pixels, iteration
    counts, thresholds, the per-iteration curves and costs) and, at the
    reference's optimum θ, the final fit's (the mean and its integer
    trace, the intervals, the final cost) are held by
    ``torch_parity.assert_results_match``. Where the final fit's float32
    polish stops on the LML's flat ridge is not held here: from the same
    training sets, frames of image seeds 3, 54 and 233 stop apart (mean
    curves 0.08-0.17 px apart, LMLs up to 0.12 apart, the port's the higher
    on seed 54). That gap belongs to both packages' polish, and
    ``test_torch_branches.py::test_polish_agrees_in_float64`` is its
    witness (ROADMAP queue 3)."""
    ref, got, pcfg, pdata = (tiled[k] for k in ("ref", "got", "pcfg",
                                                "pdata"))
    assert got.edge_trace.shape == (len(SEEDS), 95, 2)
    n = np.asarray(ref.n_iters)
    tiles = [n[t:t + TILE] for t in range(0, len(SEEDS), TILE)]
    assert len(set(tiles[0].tolist())) > 1, n
    assert len({int(t.max()) for t in tiles}) > 1, n
    np.testing.assert_array_equal(got.n_iters.numpy(), n)
    # The port's loop finished by its final fit at the reference's θ (the
    # reference's LML beside it).
    theta = torch.tensor(np.array(ref.theta), dtype=torch.float32)
    lml = torch.tensor(np.array(ref.lml), dtype=torch.float32)
    state = pd.run_loop(pcfg, pdata, tiled["pstates"], tiled["draws"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pd, "optimize_lml", lambda *a, **k: (theta, lml))
        at_ref = pd.finish_trace(pcfg, pdata, state, tiled["draws"])
    for f in ("iter_curves", "iter_costs", "obs_x", "obs_y", "obs_valid"):
        assert torch.equal(getattr(at_ref, f), getattr(got, f)), f
    assert_results_match(at_ref, ref)
    for f in range(len(SEEDS)):
        single = pd.run_trace(pcfg, _frame_data(pdata, f),
                              pd.init_state(pcfg, "cpu"), tiled["draws"])
        assert_same_bits(pd.frame_of(got, f), single)


def _curves(rng, B, E, M, S):
    """(cols (B, E, M), ys (B, E, S)): gradient columns and random-walk
    curves inside the image, like a sampling round's."""
    cols = torch.tensor(rng.uniform(0.0, 1.0, (B, E, M)), dtype=torch.float32)
    walk = np.cumsum(rng.normal(0.0, 0.7, (B, E, S)), axis=1)
    ys = np.clip(M / 2 + walk, 0, M - 1)
    return cols, torch.tensor(ys, dtype=torch.float32)


@pytest.mark.parametrize("E", [95, 96])
def test_card_cost_sums_do_not_depend_on_frames(E, monkeypatch):
    """The curve cost's sums over E on the card (forced on the CPU): for E
    odd and even, ``line_and_arc`` over a (3, E, S) batch and the final
    cost (``curve_costs`` at S = 1) give each frame the bits of that frame
    run as a (1, E, S) batch, through the fixed tree; and they agree with
    the CPU path's ``torch.sum`` within ``TREE_RTOL``."""
    rng = np.random.default_rng(E)
    cols, ys = _curves(rng, 3, E, 64, 200)

    def costs():
        grad = ci.column_interp(cols, ys, add_const=1e-3)
        line, arc = ci.line_and_arc(grad, ys)
        final = scoring.curve_costs(cols, ys[..., :1])[..., 0]
        return line, arc, final

    def frame(f):
        grad = ci.column_interp(cols[f:f + 1], ys[f:f + 1], add_const=1e-3)
        line, arc = ci.line_and_arc(grad, ys[f:f + 1])
        final = scoring.curve_costs(cols[f:f + 1], ys[f:f + 1, :, :1])
        return line[0], arc[0], final[0, 0]

    cpu = costs()
    trees = []

    def counted(x, dim=-1):
        trees.append(x.shape[dim])
        return tree(x, dim)
    tree = sums.tree_sum
    monkeypatch.setattr(sums, "tree_sum", counted)
    monkeypatch.setattr(sums, "_on_card", lambda t: True)
    card = costs()
    # The line's pair windows and the arc's weighted steps, in the loop's
    # costs and in the final cost: four sums, over the E - 3 windows of an
    # odd point count E - 1 (E - 4 where the last interval takes the
    # even-count tail) and the E - 1 steps.
    assert len(trees) == 4 and set(trees) <= {E - 4, E - 3, E - 1}, trees
    for f in range(3):
        for a, b in zip(card, frame(f)):
            assert torch.equal(a[f], b)
    for a, b in zip(card, cpu):
        torch.testing.assert_close(a, b, rtol=TREE_RTOL, atol=0.0)


def test_smoke_compares_every_result_field():
    """``chip_smoke.py`` holds a batch frame to its single trace on every
    ``TraceResult`` field: a change of any one field, in one element or
    one bit (-0.0 against 0.0), is found in that field alone, with its
    gaps for a float field; a NaN equals a NaN of the same bits; and the
    loop's fields are fields of the result."""
    import chip_smoke as cs
    rng = np.random.default_rng(0)
    E, U, it = 7, 3, 5
    f32 = dict(dtype=torch.float32)
    res = pd.TraceResult(
        edge_trace=torch.tensor(rng.integers(0, 9, (E, 2))),
        y_mean=torch.tensor(rng.normal(size=E), **f32),
        y_std=torch.tensor(rng.uniform(size=E), **f32),
        cred_interval=torch.tensor(rng.normal(size=(2, E)), **f32),
        cred_interval_px=torch.tensor(rng.normal(size=(2, E)), **f32),
        n_iters=it, converged=True,
        theta=torch.tensor(rng.normal(size=3), **f32),
        lml=torch.tensor(rng.normal(), **f32),
        final_cost=torch.tensor(float("nan"), **f32),
        iter_curves=torch.tensor(rng.normal(size=(it, E)), **f32),
        iter_costs=torch.tensor(rng.normal(size=it), **f32),
        iter_nobs=torch.tensor(rng.integers(0, 9, it)),
        iter_thresh=torch.zeros(it, **f32),
        obs_x=torch.tensor(rng.integers(0, 9, U)),
        obs_y=torch.tensor(rng.integers(0, 9, U)),
        obs_valid=torch.tensor([True, False, True]))
    assert set(cs.LOOP_FIELDS) <= set(pd.TraceResult._fields)
    assert cs.differing_fields(res, res._replace()) == []
    for field in pd.TraceResult._fields:
        v = getattr(res, field)
        if not isinstance(v, torch.Tensor):
            changed = not v if isinstance(v, bool) else v + 1
        elif v.dtype == torch.bool:
            changed = v.clone()
            changed.view(-1)[0] = ~changed.view(-1)[0]
        elif v.is_floating_point():
            changed = v.clone()
            flat = changed.view(-1)
            flat[0] = (-0.0 if float(flat[0]) == 0.0
                       else 1.0 if torch.isnan(flat[0])
                       else torch.nextafter(flat[0], torch.tensor(np.inf)))
        else:
            changed = v.clone()
            changed.view(-1)[0] += 1
        other = res._replace(**{field: changed})
        assert cs.differing_fields(res, other) == [field], field
        gaps = cs.field_gaps(other, res, [field])
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            assert set(gaps) == {field}
            assert set(gaps[field]) == {"max_abs", "max_rel"}
        else:
            assert gaps == {}
