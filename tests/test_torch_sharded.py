"""PyTorch port, the sharded batch: ``sharded_trace_batch`` on (data,
sample) meshes of gloo processes on the CPU against the port's own
``trace_batch`` and the JAX package's sharded and vmapped batches; the
collective counts, the argument checks, ``kde_normalise`` and K1's launch
plan at shard widths.

The ranks are spawned with ``torch.multiprocessing`` (one torch thread
each) and meet through a ``file://`` rendezvous in the test's temporary
directory (``tests/torch_sharded_worker.py``)."""

import functools
import time
import types

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from gaussian_process_edge_trace_torch.ops import collectives
from gaussian_process_edge_trace_torch.ops import cuda_interp as ci
from gaussian_process_edge_trace_torch.parallel import sharded as ps
from gaussian_process_edge_trace_torch.trace import driver as pd
from gaussian_process_edge_trace_torch.trace import kde as pk
from gaussian_process_edge_trace_tpu.parallel import sharded as rs
from gaussian_process_edge_trace_tpu.trace import driver as rd
from gaussian_process_edge_trace_tpu.trace import kde as rk
from torch_parity import (ATOL, EXACT, PARALLEL_FINAL_FIT, PARALLEL_KW,
                          RTOL, JaxDraws, assert_results_match, j32,
                          parallel_frames)
from torch_sharded_worker import ReplayDraws, reference_draws, run_rank

torch.set_num_threads(1)

MESHES = ((1, 2), (2, 1), (2, 2))
N_FRAMES = 4
# The loop's fields: the trajectory, equal exactly, and its floats.
LOOP_EXACT = ("n_iters", "converged", "iter_nobs", "iter_thresh", "obs_x",
              "obs_y", "obs_valid")
LOOP_FLOATS = ("iter_curves", "iter_costs")


def _spawn(tmp_path, mesh_shape, problem, timeout_s=180):
    """Every rank's saved results of ``problem`` on a ``mesh_shape`` mesh
    of gloo processes; fails, with every rank stopped, after
    ``timeout_s``."""
    world = mesh_shape[0] * mesh_shape[1]
    out = tmp_path / f"mesh_{mesh_shape[0]}x{mesh_shape[1]}"
    out.mkdir()
    ranks = mp.start_processes(
        run_rank, args=(world, str(out / "rendezvous"), mesh_shape, problem,
                        str(out)), nprocs=world, join=False,
        start_method="spawn")
    deadline = time.monotonic() + timeout_s
    while not ranks.join(timeout=1):
        if time.monotonic() > deadline:
            for p in ranks.processes:
                p.kill()
            pytest.fail(f"the {mesh_shape} mesh did not finish in "
                        f"{timeout_s} s")
    return [torch.load(out / f"rank{r}.pt") for r in range(world)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four frames through ``sharded_trace_batch`` on each mesh, from
    the reference's draws and from the default ones, and the port's
    ``trace_batch`` of the same frames from the same draws."""
    grads, inits = parallel_frames(N_FRAMES)
    cfg = pd.make_config(inits[0], grads.shape[1:], **PARALLEL_KW)
    rank = pd.prior_factor(cfg).shape[1]
    replay = reference_draws(JaxDraws(cfg, rank), cfg.max_iters)
    problem = {"cfg_args": (inits[0], grads.shape[1:]), "cfg_kw": PARALLEL_KW,
               "grads": grads, "inits": inits,
               "draws": {"reference": replay, "default": None}}
    tmp = tmp_path_factory.mktemp("sharded")
    data = ps.make_batch_data(cfg, grads, inits, "cpu")
    batch = {name: ps.trace_batch(cfg, data, ps.make_batch_state(
        cfg, N_FRAMES, "cpu"), None if d is None else ReplayDraws(*d))
        for name, d in problem["draws"].items()}
    return dict(cfg=cfg, grads=grads, inits=inits, replay=replay,
                batch=batch, meshes={m: _spawn(tmp, m, problem)
                                     for m in MESHES})


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("draws", ["reference", "default"])
def test_sharded_equals_trace_batch(runs, mesh, draws):
    """Every rank returns all four frames, bit for bit the same as every
    other rank; the selected fields equal ``trace_batch``'s exactly, the
    rest agree at the JAX package's tolerance for the same comparison
    (test_parallel.py:103-134): the ranks' (E, S/k) samples round apart
    from one (E, S) product's in f32. From the reference's draws the
    frames finish at different iterations, so the data ranks part."""
    want = runs["batch"][draws]
    ranks = [r[draws]["result"] for r in runs["meshes"][mesh]]
    if draws == "reference":
        assert len(set(want.n_iters.tolist())) > 1
    for got in ranks:
        for f in pd.TraceResult._fields:
            assert torch.equal(got[f], ranks[0][f]), f
            w, g = getattr(want, f), got[f]
            assert g.shape == w.shape and g.device == w.device, f
            if f in EXACT:
                assert torch.equal(g, w), f
            else:
                np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=RTOL,
                                           atol=ATOL, err_msg=f)


@pytest.mark.parametrize("mesh", MESHES)
def test_collectives_per_iteration(runs, mesh):
    """One ``all_gather`` and one ``all_reduce`` per loop iteration of the
    rank's sample group, and one ``all_gather`` over its data group at the
    end: the footprint ``benchmarks/sharded_row.py:78-91`` pins in the
    JAX package's HLO."""
    per = N_FRAMES // mesh[0]
    for r in runs["meshes"][mesh]:
        for draws in ("reference", "default"):
            n = r[draws]["result"]["n_iters"]
            d = r["data_coord"]
            loops = int(n[d * per:(d + 1) * per].max())
            assert r[draws]["collectives"] == {"all_gather": loops + 1,
                                               "all_reduce": loops}


@pytest.fixture(scope="module")
def reference(runs):
    """The JAX package's ``sharded_trace_batch`` on a (2, 2) mesh of the
    virtual CPU devices (its final fit on its CPU path: the batched one
    does not trace under ``shard_map``'s varying-manifest checks there),
    and its ``trace_batch_vmap`` with the batched final fit."""
    grads, inits = runs["grads"], runs["inits"]
    cfg = rd.make_config(inits[0], grads.shape[1:], **PARALLEL_KW)
    data = rs.make_batch_data(cfg, grads, inits)
    states = rs.make_batch_state(cfg, N_FRAMES)
    sharded = jax.device_get(rs.sharded_trace_batch(
        cfg, data, states, rs.make_mesh(2, 2, jax.devices()[:4]),
        n_frames=N_FRAMES))
    with pytest.MonkeyPatch.context() as monkey:
        monkey.setattr(rd, "optimize_lml",
                       functools.partial(rd.optimize_lml, use_batched=True))
        vmap = jax.device_get(rs.trace_batch_vmap(cfg, data, states))
    return dict(sharded=sharded, vmap=vmap)


def test_sharded_matches_reference_sharded(runs, reference):
    """The port's (2, 2) mesh from the reference's draws, each shard taking
    its columns of them, against the JAX package's (2, 2) mesh: the same
    trajectory (accepted pixels, thresholds, iteration counts), the loop's
    floats at the JAX package's tolerance; and the whole result, the final
    fit too (its final cost as ``PARALLEL_FINAL_FIT`` says), against the
    reference's vmapped batch, which the JAX tests pin to its sharded one
    on the trajectory (test_parallel.py:107-135)."""
    ref = reference["sharded"]
    got = runs["meshes"][(2, 2)][0]["reference"]["result"]
    for f in LOOP_EXACT:
        np.testing.assert_array_equal(got[f].numpy(), np.asarray(
            getattr(ref, f)), err_msg=f)
    for f in LOOP_FLOATS:
        np.testing.assert_allclose(got[f].numpy(), np.asarray(
            getattr(ref, f)), rtol=RTOL, atol=ATOL, err_msg=f)
    assert_results_match(pd.TraceResult(**got), reference["vmap"],
                         PARALLEL_FINAL_FIT)


def test_one_by_one_mesh_in_process_equals_trace_batch(runs, tmp_path):
    """A (1, 1) mesh in this process, the layout the single card runs:
    each iteration's gather and reduce are over one rank, and the result
    is ``trace_batch``'s bit for bit."""
    cfg = runs["cfg"]
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rv",
                            world_size=1, rank=0)
    try:
        mesh = ps.make_mesh(1, 1, "cpu")
        data = ps.make_batch_data(cfg, runs["grads"], runs["inits"], "cpu")
        collectives.COLLECTIVES.update(all_gather=0, all_reduce=0)
        got = ps.sharded_trace_batch(
            cfg, data, ps.make_batch_state(cfg, N_FRAMES, "cpu"), mesh,
            N_FRAMES, ReplayDraws(*runs["replay"]))
    finally:
        dist.destroy_process_group()
    want = runs["batch"]["reference"]
    for f in pd.TraceResult._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    loops = int(want.n_iters.max())
    assert collectives.COLLECTIVES == {"all_gather": loops + 1,
                                       "all_reduce": loops}


def test_sharded_argument_checks(runs):
    """The reference's asserts (sharded.py:228-229) as ValueErrors, and a
    mesh on another device type than the data's."""
    cfg = runs["cfg"]
    data = ps.make_batch_data(cfg, runs["grads"], runs["inits"], "cpu")
    states = ps.make_batch_state(cfg, N_FRAMES, "cpu")

    def mesh(n_data, n_sample, device_type="cpu"):
        return types.SimpleNamespace(size=lambda d: (n_data, n_sample)[d],
                                     device_type=device_type)
    for m, n, match in ((mesh(3, 1), N_FRAMES, "data ranks"),
                        (mesh(1, 3), N_FRAMES, "sample ranks"),
                        (mesh(1, 1), 2, "n_frames"),
                        (mesh(1, 1, "cuda"), N_FRAMES, "cuda mesh")):
        with pytest.raises(ValueError, match=match):
            ps.sharded_trace_batch(cfg, data, states, m, n)


def test_kde_normalise_matches_reference():
    """``kde_normalise`` against the JAX function (kde.py:196), on one grid
    and on frames, each scaled by its own range."""
    raw = np.random.default_rng(4).gamma(2.0, 1.0, (3, 40, 56))
    raw = raw.astype(np.float32)
    for a in (raw[0], raw):
        got = pk.kde_normalise(torch.tensor(a))
        want = (np.stack([np.asarray(rk.kde_normalise(j32(f))) for f in a])
                if a.ndim == 3 else np.asarray(rk.kde_normalise(j32(a))))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
        assert float(got.min()) == 0.0 and float(got.max()) == 1.0


@pytest.mark.parametrize("E,M,S,k", [(1000, 1000, 10000, 2),
                                     (1000, 1000, 10000, 4),
                                     (1000, 1000, 10000, 32),
                                     (500, 500, 1000, 2), (64, 64, 64, 2)])
def test_k1_plan_at_shard_width(E, M, S, k):
    """A shard's K1 launch over S/k samples planned on the group's S takes
    the full launch's chunks (so the same sums per sample) and covers its
    own samples. Planned on its own width, a 1000² shard of 312 samples
    would take chunks of 4 pair windows where the full launch takes 8."""
    full = ci.k1_launch_plan(E, M, S)
    shard = ci.k1_launch_plan(E, M, S // k, plan_samples=S)
    for key in ("pairs_per_chunk", "n_chunks", "smem_bytes"):
        assert shard[key] == full[key], key
    assert shard["sample_groups"] * shard["samples_per_block"] >= S // k
    assert ci.k1_launch_plan(E, M, S, plan_samples=S) == full
    if k == 32:
        alone = ci.k1_launch_plan(E, M, S // k)
        assert (alone["pairs_per_chunk"], full["pairs_per_chunk"]) == (4, 8)
