"""GPipe pipeline parallelism over a process group.

Port of ``repro.dist.pipeline``: ``pipeline_apply`` runs a stage function
over a microbatched input with the GPipe schedule.  With S stages (the
group's ranks, rank s holding stage s) and M microbatches, tick t has
stage s processing microbatch t - s, and each tick's output hops one
stage down the pipe by ``batch_isend_irecv`` (the JAX ``ppermute``).
M + S - 1 ticks drain the pipe; the LAST rank holds the final outputs
(callers broadcast them if they need them everywhere).
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

__all__ = ["pipeline_apply"]


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   params: Any, xs: torch.Tensor, group=None) -> torch.Tensor:
    """Run ``stage_fn`` as a GPipe pipeline over ``group``.

    params: THIS rank's stage parameters; xs: [M, ...] microbatches, the
    same on every rank; ``stage_fn`` keeps a microbatch's shape.  Returns
    [M, ...] stage-(S-1) outputs, valid on the last rank (zeros elsewhere).
    """
    n_stages = dist.get_world_size(group)
    stage = dist.get_rank(group)
    m = xs.shape[0]

    def peer(s):
        return s if group is None else dist.get_global_rank(group, s)

    recv = torch.zeros_like(xs[0])
    out = torch.zeros_like(xs)
    for t in range(m + n_stages - 1):
        mb = t - stage                      # microbatch index at this rank
        active = 0 <= mb < m
        # stage 0 pulls from the microbatch stream; later stages from the
        # previous stage's wire
        x_in = xs[min(t, m - 1)] if stage == 0 else recv
        y = stage_fn(params, x_in)
        if not active:
            y = torch.zeros_like(y)
        elif stage == n_stages - 1:
            out[mb] = y                     # the last stage banks it
        # one hop down the pipe (the first stage receives nothing: zeros)
        ops = []
        if stage < n_stages - 1:
            ops.append(dist.P2POp(dist.isend, y.contiguous(),
                                  peer(stage + 1), group))
        nxt = torch.zeros_like(recv)
        if stage > 0:
            ops.append(dist.P2POp(dist.irecv, nxt, peer(stage - 1), group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        recv = nxt
    return out
