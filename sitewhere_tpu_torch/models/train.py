"""The train form shared by the recurrent families' BPTT kernels (KB for
LSTM-AD, KR for DeepAR), as ``models/flush.py`` holds the flush form KS and
KD share.

A family's ``loss_stacked`` takes stacked params and a tenant plane and
returns the per-row teacher-forced loss f32[S, B] (the reference's
``loss_stacked`` contract, ``sitewhere_tpu/models/lstm_ad.py:202``,
``deepar.py:165``). On CUDA tensors it is ``TrainLoss``, a
``torch.autograd.Function`` whose forward and backward launch the family's
kernel: the forward writes the loss and saves the gate activations, cell
and hidden states; the backward takes the seed ``g_row`` f32[S, B] of
whatever reduces the loss (the train step's masked per-slot mean) and
returns every weight leaf's gradient. The recurrent weight gradient,
``dWh[s] = sum_{t,b} h_{t-1}^T dgates_t``, is ``torch.bmm`` here (per
slot, ``[steps, H, B] x [steps, B, G]``, the steps summed in float32), as
the JAX package leaves that dense product to XLA; the recurrence and the
elementwise backward run in the kernel.

Two input modes: windows mode (windows f32[S, B, W], the contract) and ring
mode, which gathers every stream's window from the rings ``[S, streams, W]``
inside the kernel (``ops/windows.py`` ``gather_windows`` with ``ids =
arange(streams)``), so the train step reads no materialized windows.

The kernels take float32 master weights (the reference trains the
masters; a scorer's bf16/int8 serving view is derived from them at
``commit_swap``). Each family's kernel has two forms, chosen by shape before
any launch (``flush.train_route``): the templated one (``lstm_train``,
``gru_train``: hidden 8, 16, 32 or 64, 32 rows a block, a tile's windows
and wh^T in shared memory) while its tiles fit, the wide one
(``lstm_train_wide``, ``gru_train_wide``: any hidden and window, R rows a
block, wh streamed from L1/L2, windows read from global memory) for every
other shape whose block state fits shared memory (hidden up to 784 for
KB, 1,017 for KR), and the global one (``lstm_train_global``,
``gru_train_global``: the wide kernels with the block state in a scratch
in global memory, ``train_buffers``' ``state``) for every wider hidden.
All write the same saves in the same layouts, so the dWh product and the
gradients' assembly are one code path. CPU tensors take the family's
plain version under autograd.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple

import torch

from sitewhere_tpu_torch import kernels
from sitewhere_tpu_torch.models.common import Params
from sitewhere_tpu_torch.models.flush import (
    GLOBAL_WAVE,
    WIDE_ROWS,
    gather_stacked,
    global_scratch,
    scan_weights,
    state_stride,
    train_route,
    train_state_floats,
)
from sitewhere_tpu_torch.ops.windows import WindowState


@dataclass(frozen=True)
class TrainForm:
    """What differs between KB and KR. ``leaves`` are the weight leaves in
    the kernel's argument order; ``gates`` the gate columns per hidden unit
    (the recurrent product's width G = gates * H); ``heads`` the loss
    derivatives saved per (row, step); ``cell`` whether the cell state is
    saved (LSTM); ``n_partials`` the per-slot sums the kernel reduces
    (P); ``grads`` maps (reduced f32[S, P], dWh f32[S, H, G]) to the leaves'
    gradients in ``leaves`` order."""

    name: str
    label: str
    leaves: Tuple[Tuple[str, str], ...]
    gates: int
    heads: int
    cell: bool
    n_partials: Callable[[int], int]
    grads: Callable[[torch.Tensor, torch.Tensor, int], Sequence[torch.Tensor]]


def _check(form: TrainForm, params: Params, cfg, w: int) -> list:
    sw = scan_weights(
        params, cfg, form.leaves, form.label, formats=("f32",),
        why=" (the train form reads the f32 masters, as the reference trains them)",
    )
    train_route(form, sw.hidden, w)
    return list(sw.tensors[:len(form.leaves)])


def _hidden(weights) -> int:
    """The width of a train form's weights (wh [S, H, G], the third)."""
    return weights[2].shape[1]


def train_buffers(form: TrainForm, save_dtype, t_slots: int, b: int, w: int, h: int,
                  device, mode: int) -> dict:
    """What the train form allocates: the forward's (``mode`` 0: the
    per-row loss, the saves ``act`` [S, steps, B, 4H] (the LSTM's i, f, g,
    o; the GRU's r, z, n, nh), ``cst`` (LSTM) and ``hst`` [S, steps, B, H]
    in the compute dtype, ``dhead`` f32[S, B, steps, heads]) or the
    backward's (``mode`` 1: ``dgates`` [S, steps, B, G], the per-tile
    ``partials`` f32[S, tiles, P] at the route's rows a tile, ``reduced``
    f32[S, P], and for the wide and global forms ``wt``, the slots' wh^T
    f32[S, G, H]); for the global form also the mode's ``state``, the
    block state's scratch (``flush.global_scratch``)."""
    steps, g = w - 1, form.gates * h
    route, rows = train_route(form, h, w, (t_slots, b))
    tiles = -(-b // rows)

    def new(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=device)

    state = (global_scratch(train_state_floats(form, h, rows, mode), t_slots * tiles, device)
             if route == "global" else None)
    if mode == 0:
        return {
            "per_row": new((t_slots, b)),
            "act": new((t_slots, steps, b, 4 * h), save_dtype),
            "cst": new((t_slots, steps, b, h), save_dtype) if form.cell else None,
            "hst": new((t_slots, steps, b, h), save_dtype),
            "dhead": new((t_slots, b, steps, form.heads)),
            "state": state,
        }
    n_p = form.n_partials(h)
    return {
        "dgates": new((t_slots, steps, b, g), save_dtype),
        "partials": new((t_slots, tiles, n_p)),
        "reduced": new((t_slots, n_p)),
        "wt": new((t_slots, g, h)) if route != "block" else None,
        "state": state,
    }


def _launch(form: TrainForm, mode: int, weights, bf16: int, *, ring, windows,
            t_slots: int, b: int, w: int, bufs: dict) -> None:
    p = kernels.ptr
    h = _hidden(weights)
    route, rows = train_route(form, h, w, (t_slots, b))
    extra = () if route == "block" else (rows, p(bufs.get("wt")))
    if route == "global":
        extra += (p(bufs.get("state")), GLOBAL_WAVE)
    kernels.launch(
        form.name if route == "block" else f"{form.name}_{route}", mode,
        *[p(x) for x in weights],
        None if ring is None else p(ring.values),
        None if ring is None else p(ring.pos),
        None if ring is None else p(ring.count),
        0 if ring is None else ring.values.shape[1],
        p(windows), t_slots, b, w, h, bf16,
        *[p(bufs.get(k)) for k in ("per_row", "act", "cst", "hst", "dhead",
                                   "g_row", "dgates", "partials", "reduced")],
        *extra, kernels.stream_handle(weights[0].device), variant=f"h{h}",
    )


class TrainLoss(torch.autograd.Function):
    """The kernel's loss under autograd: ``apply(form, cfg, ring, windows,
    *weights)`` -> per-row loss f32[S, B]. Exactly one of ``ring`` (a
    WindowState) and ``windows`` is given."""

    @staticmethod
    def forward(ctx, form: TrainForm, cfg, ring: Optional[WindowState],
                windows: Optional[torch.Tensor], *weights):
        dev = weights[0].device
        if ring is not None:
            t_slots, b, w = ring.values.shape
            for x in ring:
                if not x.is_contiguous():
                    raise ValueError(f"{form.label} takes contiguous rings")
            if ring.values.dtype != torch.float32:
                raise TypeError(f"{form.label} reads float32 rings")
        else:
            windows = windows.to(torch.float32).contiguous()
            t_slots, b, w = windows.shape
        h = _hidden(weights)
        save_dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
        bufs = train_buffers(form, save_dtype, t_slots, b, w, h, dev, 0)
        bf16 = 1 if cfg.dtype == "bfloat16" else 0
        _launch(form, 0, weights, bf16, ring=ring, windows=windows, t_slots=t_slots,
                b=b, w=w, bufs=bufs)
        bufs.pop("state")  # the forward's block state is not kept for the backward
        ctx.form, ctx.bf16, ctx.shape = form, bf16, (t_slots, b, w)
        ctx.ring, ctx.windows, ctx.bufs = ring, windows, bufs
        ctx.weights = weights
        return bufs["per_row"]

    @staticmethod
    def backward(ctx, g_row):
        form, (t_slots, b, w) = ctx.form, ctx.shape
        h = _hidden(ctx.weights)
        bufs = dict(ctx.bufs, g_row=g_row.to(torch.float32).contiguous())
        bufs.update(train_buffers(form, bufs["hst"].dtype, t_slots, b, w, h, g_row.device, 1))
        _launch(form, 1, ctx.weights, ctx.bf16, ring=ctx.ring, windows=ctx.windows,
                t_slots=t_slots, b=b, w=w, bufs=bufs)
        # dWh[s] = sum over steps t >= 1 and rows of h_{t-1}^T dgates_t: per
        # slot one product a step over the B rows, the steps summed in f32
        # (one product over all T*B rows lost accuracy in cuBLAS's f32 path:
        # 1e-4 against float64 at the train plane, 100x the per-step form's)
        dwh = torch.stack([
            torch.bmm(bufs["hst"][s, :-1].transpose(1, 2), bufs["dgates"][s, 1:])
            .sum(0, dtype=torch.float32)
            for s in range(t_slots)
        ])
        ctx.bufs = ctx.weights = ctx.ring = ctx.windows = None
        return (None, None, None, None, *form.grads(bufs["reduced"], dwh, h))


def loss_stacked_kernel(form: TrainForm, params: Params, cfg, windows: torch.Tensor):
    """Windows mode on the card: windows f32[S, B, W] -> per-row loss
    f32[S, B] (differentiable in ``params``)."""
    weights = _check(form, params, cfg, windows.shape[-1])
    return TrainLoss.apply(form, cfg, None, windows, *weights)


def loss_ring_kernel(form: TrainForm, params: Params, cfg, state: WindowState):
    """Ring mode on the card: every stream of every slot of the rings
    ``state`` [S, streams, W] -> per-row loss f32[S, streams]."""
    weights = _check(form, params, cfg, state.values.shape[-1])
    return TrainLoss.apply(form, cfg, state, None, *weights)


def ring_windows(state: WindowState) -> torch.Tensor:
    """Every stream's window of every slot, gathered from the rings
    (the plain version of ring mode's gather): f32[S, streams, W]."""
    t_slots, s = state.values.shape[:2]
    ids = torch.arange(s, dtype=torch.int32, device=state.values.device)
    windows, _ = gather_stacked(state, ids[None].expand(t_slots, s))
    return windows


def train_bytes_per_row(form: TrainForm, cfg, window: int) -> int:
    """Device bytes the kernel's train form holds a row (one stream's
    window) between its forward and its backward (``train_buffers`` less
    the per-row loss and the per-slot ``reduced`` and ``wt``): per step the
    saved gate activations (4H), cell (LSTM) and hidden states and the
    backward's gate gradients in the compute dtype and the heads'
    derivatives in f32, and the row's share of the per-tile partial sums
    (P floats a tile of the route's rows, rounded up to whole bytes); for
    the global form, whose rows a block the plane sets, the partials' and
    the backward block state's shares at 8 rows a block, the most a row
    can take (the forward's smaller state is freed before the backward
    allocates)."""
    h, size = cfg.hidden, (2 if cfg.dtype == "bfloat16" else 4)
    per_step = (4 * h + (h if form.cell else 0) + h + form.gates * h) * size + 4 * form.heads
    route, rows = train_route(form, h, window)
    if route == "global":
        rows = WIDE_ROWS[-1]
    held = (window - 1) * per_step + -(-4 * form.n_partials(h) // rows)
    if route == "global":
        held += -(-4 * state_stride(train_state_floats(form, h, rows, 1)) // rows)
    return held
