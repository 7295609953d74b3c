"""One rank of a sharded trace on the CPU, for ``test_torch_sharded.py``.

``run_rank`` is the target of a ``torch.multiprocessing`` spawn: it joins a
gloo process group through a ``file://`` rendezvous, builds the
(data, sample) mesh, traces the batch with ``sharded_trace_batch`` for each
draw source asked for and saves what it got, with its collective counts,
to ``<out>/rank<r>.pt``. It imports no JAX: the reference's draws come in
precomputed (:class:`ReplayDraws`).
"""

from __future__ import annotations

import datetime

import numpy as np
import torch
import torch.distributed as dist

from gaussian_process_edge_trace_torch.ops import collectives
from gaussian_process_edge_trace_torch.parallel import sharded as ps
from gaussian_process_edge_trace_torch.trace import driver as pd


class ReplayDraws:
    """A draw source that serves precomputed draws: ``z`` (T, r, S) and
    ``w`` (T, n_train, S) normals of iterations 0..T-1 and the (R, 3)
    restart uniforms, each iteration's by columns ``cols``."""

    def __init__(self, z, w, restarts):
        self.z, self.w, self.u = z, w, restarts

    def normals(self, it, cols=slice(None)):
        return (torch.tensor(self.z[it][:, cols]),
                torch.tensor(self.w[it][:, cols]))

    def restarts(self):
        return torch.tensor(self.u)


def run_rank(rank, world, rendezvous, mesh_shape, problem, out):
    """Trace ``problem`` (a dict: ``cfg_args``, ``cfg_kw``, ``grads``,
    ``inits``, and ``draws``, a dict of sources by name, None for the
    default) on a ``mesh_shape`` mesh as rank ``rank`` of ``world``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh = ps.make_mesh(*mesh_shape, device_type="cpu")
        cfg = pd.make_config(*problem["cfg_args"], **problem["cfg_kw"])
        grads, inits = problem["grads"], problem["inits"]
        data = ps.make_batch_data(cfg, grads, inits, "cpu")
        got = {}
        for name, draws in problem["draws"].items():
            src = None if draws is None else ReplayDraws(*draws)
            collectives.COLLECTIVES.update(all_gather=0, all_reduce=0)
            res = ps.sharded_trace_batch(
                cfg, data, ps.make_batch_state(cfg, len(grads), "cpu"), mesh,
                len(grads), src)
            got[name] = {"result": res._asdict(),
                         "collectives": dict(collectives.COLLECTIVES)}
        got["data_coord"] = mesh.get_local_rank(ps.DATA_AXIS)
        torch.save(got, f"{out}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def reference_draws(jax_draws, n_iters):
    """``(z, w, restarts)`` numpy arrays of a ``torch_parity.JaxDraws``
    for iterations 0..n_iters-1, to hand to the ranks."""
    zw = [jax_draws.normals(it) for it in range(n_iters)]
    return (np.stack([z.numpy() for z, _ in zw]),
            np.stack([w.numpy() for _, w in zw]),
            jax_draws.restarts().numpy())
