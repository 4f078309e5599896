"""The collectives of the sharded path, in one place.

``all_gather_cat`` concatenates every rank's slice along a dimension in
rank order (the column strategy's gather); ``all_reduce_sum`` sums every
rank's tensor (the row strategy's psum and the pod-axis gradient
reduction).  Both go through ``torch.distributed`` on the given process
group as they are: gloo takes CUDA tensors for both (it stages them
through host memory itself), so two ranks sharing one card run them over
gloo on ``cuda:0``.  ``COUNTS`` counts the calls of each, which the
tests and the smoke read beside the kernel launches.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist

COUNTS: Dict[str, int] = {"all_gather": 0, "all_reduce": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def all_gather_cat(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``x`` (one shape on every rank), concatenated along
    ``dim`` in the group's rank order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    COUNTS["all_gather"] += 1
    return torch.cat(parts, dim=dim)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group's ranks of ``x`` (a new tensor).  With two
    ranks every rank gets a + b, the same in either order."""
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    COUNTS["all_reduce"] += 1
    return out
