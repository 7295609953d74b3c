"""PyTorch port at ten times the sample count the traces had run: the
launch plans of K1 and K3 at the 1000² config's S = 10⁵ row
(``benchmarks/suite.py`` config 4, BASELINE.md:40) and at its S = 10³ row,
and a whole trace above K1's transposed-copy threshold replayed from the
JAX package's draws on a small image.

The plans are checked as the card's launchers read them: every pair window,
row, column and sample covered exactly once, one block within the card's
shared memory and every grid dimension and 32-bit index within its limit.
The kernels themselves run only on the card (``chip_smoke.py`` holds them
to their plain versions at these shapes)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_process_edge_trace_torch import interop
from gaussian_process_edge_trace_torch.ops import cuda_build
from gaussian_process_edge_trace_torch.ops import cuda_interp as ci
from gaussian_process_edge_trace_torch.trace import cuda_kde as ck
from gaussian_process_edge_trace_torch.trace import driver as pd
from gaussian_process_edge_trace_tpu.trace import driver as rd
from torch_parity import (SMALL_IMG, SMALL_KW, JaxDraws,
                          assert_results_match, small_problem)

INT_MAX = 2 ** 31 - 1
GRID_YZ = 65535


def _k1_covers(plan, E, S):
    """Every pair window of (E-2)/2 in exactly one chunk, every row of
    ``samples_t`` written by exactly one chunk, every sample in exactly one
    block of whole thread tiles."""
    P = (E - 2) // 2
    windows = np.zeros(P, int)
    rows = np.zeros(E, int)
    for c in range(plan["n_chunks"]):
        j0 = c * plan["pairs_per_chunk"]
        j1 = min(P, j0 + plan["pairs_per_chunk"])
        assert j0 < j1
        windows[j0:j1] += 1
        rows[2 * j0:E if j1 == P else 2 * j1] += 1
    assert (windows == 1).all() and (rows == 1).all()
    spb = plan["samples_per_block"]
    assert spb == plan["threads"] * plan["samples_per_thread"]
    samples = np.zeros(S, int)
    for g in range(plan["sample_groups"]):
        samples[g * spb:(g + 1) * spb] += 1
    assert (samples == 1).all()


def _k1_fits(plan, S, frames):
    """One block in shared memory (two per SM where the plan aims for
    two), the grids of both launches and the kernel's int sample index."""
    per_sm = cuda_build.SMEM_PER_SM // ci._K1_BLOCKS_PER_SM - 1024
    assert plan["smem_bytes"] <= min(per_sm, cuda_build.SMEM_LIMIT)
    assert plan["sample_groups"] <= INT_MAX and plan["n_chunks"] <= GRID_YZ
    assert frames <= GRID_YZ and -(-2 * S // 32) <= INT_MAX
    assert plan["sample_groups"] * plan["samples_per_block"] <= INT_MAX


@pytest.mark.parametrize("S,transpose,frames", [
    (100000, True, 1),     # the S = 10⁵ trace, with its transposed copy
    (100000, False, 1),
    (1000, False, 1),      # the S = 10³ trace
    (1000, False, 256),    # the widest demo batch's frames at E = 1000
])
def test_k1_plan_at_the_new_sample_counts(S, transpose, frames):
    """K1 at (E, M) = (1000, 1000): 63 chunks of 8 pair windows at every
    S (the chunks do not depend on the copy), S = 10⁵ in 4 groups of 98
    samples per thread; each plan covers its windows, rows and samples once
    and fits the card. The partial sums, frames × n_chunks × 2 × S floats,
    are 50.4 MB per frame at S = 10⁵."""
    plan = ci.k1_launch_plan(1000, 1000, S, transpose)
    _k1_covers(plan, 1000, S)
    _k1_fits(plan, S, frames)
    assert (plan["pairs_per_chunk"], plan["n_chunks"]) == (8, 63)
    if S == 100000:
        assert (plan["sample_groups"], plan["samples_per_thread"]) == (4, 98)
        assert 4 * plan["n_chunks"] * 2 * S == 50_400_000
    other = ci.k1_launch_plan(1000, 1000, S, not transpose)
    for key in ("pairs_per_chunk", "n_chunks", "samples_per_block"):
        assert other[key] == plan[key], key


@pytest.mark.parametrize("k", [2, 4])
def test_k1_shard_plans_at_s_1e5(k):
    """A shard of S = 10⁵ / k samples planned on the group's S takes the
    full launch's chunks (so each sample's sums are bitwise those of the
    full launch) and covers its own samples once."""
    S = 100000
    full = ci.k1_launch_plan(1000, 1000, S)
    shard = ci.k1_launch_plan(1000, 1000, S // k, plan_samples=S)
    for key in ("pairs_per_chunk", "n_chunks", "smem_bytes"):
        assert shard[key] == full[key], key
    _k1_covers(shard, 1000, S // k)
    _k1_fits(shard, S // k, 1)


@pytest.mark.parametrize("S,M,warps", [
    (10000, 1000, 3),      # S = 10⁵'s kept curves: 313 batches of 32
    (100, 1000, 2),        # S = 10³'s kept curves
])
def test_k3_plan_at_the_new_kept_curve_counts(S, M, warps):
    """K3 at E = 1000: every column in one block, every kept curve of a
    column in exactly one warp's batches of 32 (no warp without samples),
    at most 8 warps per column and 1024 threads per block, one block in the
    card's shared memory, the grid and the kernel's int sample index within
    their limits, also for 256 frames."""
    E = 1000
    plan = ck.k3_launch_plan(E, S, M)
    assert plan["warps_per_col"] == warps <= 8
    assert plan["smem_bytes"] <= cuda_build.SMEM_LIMIT
    assert plan["threads"] == 32 * plan["cols"] * plan["warps_per_col"] <= 1024
    assert plan["blocks"] <= INT_MAX and 256 <= GRID_YZ
    cols = np.zeros(E, int)
    for b in range(plan["blocks"]):
        e = np.arange(b * plan["cols"], (b + 1) * plan["cols"])
        cols[e[e < E]] += 1
    assert (cols == 1).all()
    span = 32 * plan["batches_per_warp"]
    samples = np.zeros(S, int)
    for p in range(plan["warps_per_col"]):
        assert p * span < S
        samples[p * span:(p + 1) * span] += 1
    assert (samples == 1).all()
    assert plan["warps_per_col"] * span <= INT_MAX


def test_trace_above_the_copy_threshold_replays_reference(monkeypatch):
    """The small config (64×96) at S = 2·10⁴ samples, above K1's
    transposed-copy threshold of 8192, so every iteration ranks its kept
    curves as rows of the transposed samples; its KDE bins 2000 kept
    curves. Given the JAX package's draws, the port's ``run_trace``
    accepts the reference's pixels in the reference's iterations (the
    selected fields equal), and its floats lie within ``torch_parity``'s
    tolerances. The reference's final fit takes its batched path, as on
    the TPU."""
    monkeypatch.setattr(rd, "optimize_lml",
                        functools.partial(rd.optimize_lml, use_batched=True))
    _, edge, grad, init = small_problem(SMALL_IMG)
    kw = dict(SMALL_KW, N_samples=20000)
    cfg = rd.make_config(init, grad.shape, **kw)
    assert cfg.N_samples >= ci._TRANSPOSE_MIN_S and cfg.N_keep == 2000
    data = rd.make_data(cfg, jnp.asarray(grad), jnp.asarray(init))
    state0 = rd.init_state(cfg)
    ref = jax.device_get(rd.run_trace(cfg, data, state0))
    pcfg, pdata, pstate0 = interop.from_reference(
        cfg._asdict(), jax.device_get(data._asdict()),
        jax.device_get(state0._asdict()), device="cpu")
    rows_taken = []
    best = pd.best_curves

    def recorded(y, costs, n_keep, samples_t=None):
        rows_taken.append(samples_t is not None
                          and samples_t.shape[-2:] == y.shape[-1:]
                          + y.shape[-2:-1])
        return best(y, costs, n_keep, samples_t=samples_t)
    monkeypatch.setattr(pd, "best_curves", recorded)
    got = pd.run_trace(pcfg, pdata, pstate0,
                       draws=JaxDraws(pcfg, pdata.L_prior_unit.shape[1]))
    assert got.n_iters == int(ref.n_iters) >= 2
    assert rows_taken == [True] * got.n_iters
    assert_results_match(got, ref)
    assert got.edge_trace.shape == (pcfg.edge_length, 2)
    assert torch.isfinite(got.y_mean).all()
