"""The collectives of the sharded trace, counted.

Counterpart of the ``all_gather`` and ``psum`` that
``gaussian_process_edge_trace_tpu/trace/driver.py`` (:395-429) and
``parallel/sharded.py`` place with ``shard_map``: here they are
``torch.distributed`` calls over the process groups of a
``DeviceMesh`` (NCCL on the card, gloo on the CPU). ``COLLECTIVES`` counts
the calls, one per wrapper call, as ``LAUNCHES`` counts the kernels'.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

COLLECTIVES = {"all_gather": 0, "all_reduce": 0}


class SampleShard(NamedTuple):
    """A rank's place in its sample group: the group, and the columns
    [offset, offset + width) of the iteration's S samples it holds."""
    group: object
    offset: int
    width: int

    @property
    def cols(self) -> slice:
        return slice(self.offset, self.offset + self.width)


def all_gather_stack(t, group):
    """One ``all_gather`` of ``t`` over ``group``: the members' tensors
    stacked on a new leading axis, in group-rank order."""
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t.contiguous(), group=group)
    COLLECTIVES["all_gather"] += 1
    return torch.stack(out)


def all_reduce_sum(t, group):
    """One ``all_reduce(SUM)`` of ``t`` over ``group``, in place."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    COLLECTIVES["all_reduce"] += 1
    return t
