"""Pipeline parallelism: GPipe microbatch scheduling over ranks — the port
of ``sitewhere_tpu/ops/pipeline_parallel.py``.

n stages, one a rank of an ``Axis`` (``parallel/dist.py``); m microbatches
stream through in m + n - 1 ticks, each stage's activation handed to the
next rank by ``Axis.ppermute_next``; the last stage banks the finished
microbatches and a psum gives every rank the output. The schedule is the
reference's. Where the reference computes every tick branchless and masks
an idle stage's result (the bubble, (n - 1) / (m + n - 1) of the ticks),
an idle rank here sends zeros and computes nothing: what it would have
computed reaches only ranks that are idle at the next tick, so the outputs
are the same.
"""

from __future__ import annotations

from typing import Callable

import torch

from sitewhere_tpu_torch.models.common import tree_leaves, tree_map


def pipeline_apply_local(stage_params, x: torch.Tensor, stage_fn: Callable, axis) -> torch.Tensor:
    """The per-rank body: ``stage_params`` this rank's stage, x [m, B, ...]
    the microbatched input (every rank holds it), ``stage_fn(params,
    activation [B, ...]) -> [B, ...]`` -> the output [m, B, ...] on every
    rank."""
    n, s = axis.size, axis.rank
    m = x.shape[0]
    current = torch.zeros_like(x[0])
    out = torch.zeros_like(x)
    for t in range(m + n - 1):
        mb = t - s  # the microbatch this rank works on at tick t
        if 0 <= mb < m:
            y = stage_fn(stage_params, x[mb] if s == 0 else current)
            if s == n - 1:  # the last stage banks its finished microbatch
                out[mb] = y
        else:
            y = torch.zeros_like(current)
        if t < m + n - 2:
            (current,) = axis.ppermute_next(y)
    # only the last stage banked non-zero microbatches: the psum hands them
    # to every rank
    return axis.psum(out)


def pipeline_apply(stage_params_stacked, x: torch.Tensor, stage_fn: Callable, axis,
                   microbatches: int = 4) -> torch.Tensor:
    """Run x [B, ...] (every rank holds it) through n pipelined stages:
    ``stage_params_stacked``'s leaves carry a leading stage dim of n, one
    stage a rank; the output is the full batch on every rank."""
    n = axis.size
    n_stages = tree_leaves(stage_params_stacked)[0].shape[0]
    if n_stages != n:
        # a mismatch would silently drop stages
        raise ValueError(f"{n_stages} stacked stages but {n} ranks on the axis")
    b = x.shape[0]
    if b % microbatches:
        raise ValueError(f"batch {b} must divide into {microbatches} microbatches")
    xm = x.reshape(microbatches, b // microbatches, *x.shape[1:])
    params = tree_map(lambda a: a[axis.rank], stage_params_stacked)
    out = pipeline_apply_local(params, xm, stage_fn, axis)
    return out.reshape(b, *out.shape[2:])
