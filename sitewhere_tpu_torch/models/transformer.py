"""Decoder-only transformer forecaster — the port of
``sitewhere_tpu/models/transformer.py``.

Tokens are the normalized values of a window, embedded to ``dim`` (a dense
layer from 1) plus a learned position table; ``depth`` pre-LN causal blocks
and a final LayerNorm lead to a (mu, raw sigma) head. As a scorer the score
is the Gaussian NLL of the newest sample in nats (it can be negative); rows
with fewer than 4 real samples score 0. As a forecaster it re-encodes a
fixed-size rolling context each step and samples one path per series.

Serving paths and their kernels (all CUDA C++ in ``csrc/``):

- ``score_stacked`` (the fused megabatch contract) and ``tf_score`` (the
  scoring flush's form): KE ``tf_embed`` (window gather from the rings or
  given windows, normalization, embed + pos), per block KL ``layernorm``
  (ln1, ln2), the q/k/v/o projections as batched matmuls over the slot
  dim, KA ``attention``, fc1's product, KU ``bias_gelu``, fc2, then KN
  ``tf_head`` (ln_f and the head on the last K positions, softplus, the
  NLL, the cold-start mask and, in the flush, the column select, row mask
  and wire cast).
- ``forecast``: per horizon step KE (context mode; the first step also
  normalizes the raw history, past 4,096 values through KE's raw form
  ``tf_embed_raw``, any length), the same blocks, and KN in forecast mode
  (emit, sample, un-normalize, shift the context into a second buffer).
  Its noise ``eps f32[horizon, B]`` is an input, drawn from a
  ``torch.Generator`` when not given.

Each path is one composition (``_score_stacked``, ``_tf_score``,
``_forecast`` over ``_blocks``) of the kernels' wrappers, which take their
plain versions (the reference's math and rounding points,
``models/common.py``) on CPU tensors and launch the kernels on CUDA
tensors; the ``*_plain`` entry points run the same composition over the
plain versions on any device (the card's plain twin). The legacy
per-tenant ``score`` on the CPU keeps the reference's per-tenant
composition (``_backbone``).
The serving paths read the tree as the tenant's ``param_dtype`` stored it
(``quantize_params``: f32 masters, bf16, or int8 ``qw`` with per-slot,
per-channel f32 ``scale``): KE and KN read the embed and head weights in
their format (``csrc/common.cuh`` ``wload``), the projections read theirs
through ``dequant_weight`` (KQ ``dequant`` for int8, a cast for bf16). The
per-tenant ``score`` and ``forecast`` read each dense layer's ``w``, as the
reference's ``dense`` does: a bf16 tree serves, an int8 tree raises. The
train form reads the f32 masters only.

The sequence-parallel long-context path (``backbone_sharded``,
``forecast_seed_sharded``) runs over the ranks of a
``parallel.dist.Axis``: each rank embeds its block of the context and runs
the blocks' token-local ops on it (KL, the projections, KU), and attention
as a ring of KA's ring step (``ops/ring_attention.py``).

Training (the train loss is the Gaussian NLL at every position, its row
mean per window, ``transformer.py:272``): ``loss_stacked`` and
``loss_ring`` are ``TrainLoss``, an autograd Function whose forward runs
KE in its train mode (the whole normalized window kept), the blocks with
their saves (``models.common.blocks_train_forward``: KL, KA, KU) and KN's
train mode (``tf_head_train``), and whose backward runs KN's train
backward, ln_f's KL backward (``layernorm_bwd``), the blocks in reverse
(KU's, KA's and KL's backward kernels; the projections' gradients as
batched matmuls) and KE's backward (``tf_embed_bwd``). CPU tensors take
the same composition over the plain versions (``TRAIN_PLAIN_OPS``, also
``loss_stacked_plain``, the card's plain twin). ``loss`` and
``train_step`` are the per-tenant forms.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from sitewhere_tpu_torch import kernels
from sitewhere_tpu_torch.models.common import (
    ACT_KINDS,
    BLOCK_TRAIN_KERNELS,
    BLOCK_TRAIN_PLAIN,
    DTYPES,
    BlockTrainOps,
    Params,
    attention,
    attention_plain,
    bias_gelu,
    bias_gelu_plain,
    blocks_stacked,
    blocks_train_backward,
    blocks_train_forward,
    check_kernel_params,
    clamp_fuse_k,
    dense,
    dense_init,
    dense_stacked,
    dequant_weight,
    gaussian_nll,
    has_int8,
    kernel_weight,
    kstep_mask,
    layernorm,
    layernorm_init,
    layernorm_rows,
    layernorm_rows_plain,
    layernorm_stacked,
    normalize_windows,
    softplus,
    transformer_block,
    transformer_block_init,
    leaves_like,
    tree_leaves,
    tree_map,
    value_and_grad,
    wide,
)
from sitewhere_tpu_torch.models.flush import (
    WEIGHT_FORMATS,
    dense_format,
    dense_leaf,
    gather_stacked,
    select_scores,
)
from sitewhere_tpu_torch.models.train import ring_windows
from sitewhere_tpu_torch.ops import adam as optim
from sitewhere_tpu_torch.ops.ring_attention import (
    ring_attention_local,
    ring_step,
    ring_step_plain,
)
from sitewhere_tpu_torch.ops.windows import ID_KINDS, VAL_KINDS, WindowState

# the longest raw history KE's context mode (csrc/tf_embed.cu mode 2)
# normalizes in shared memory; longer ones go to its raw form
# (csrc/tf_embed_raw.cu), ke_raw_route
KE_MAX_RAW = 4096
# rows a block of KE's backward and of KN's train backward sums (their
# per-tile partials: csrc/tf_embed_bwd.cu, csrc/tf_head.cu)
KE_BWD_TILE_ROWS = 256
KN_TRAIN_TILE_ROWS = 64
# why the train form takes f32 master weights only
TRAIN_MASTERS = ("it differentiates them, as the reference's train step does "
                 "(parallel/sharded.py:1111); a scorer trains its masters and re-derives its "
                 "bf16/int8 view at commit_swap")


@dataclass(frozen=True)
class TransformerForecasterConfig:
    context: int = 256
    horizon: int = 24
    dim: int = 128
    depth: int = 4
    heads: int = 4
    dtype: str = "bfloat16"

    @property
    def compute_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]


def init(gen: torch.Generator, cfg: TransformerForecasterConfig, device="cuda") -> Params:
    pos = torch.randn((cfg.context, cfg.dim), generator=gen, dtype=torch.float32) * 0.02
    return {
        "embed": dense_init(gen, 1, cfg.dim, device=device),
        "pos": pos.to(device),
        "blocks": [
            transformer_block_init(gen, cfg.dim, cfg.heads, device=device)
            for _ in range(cfg.depth)
        ],
        "ln_f": layernorm_init(cfg.dim, device),
        "head": dense_init(gen, cfg.dim, 2, device=device),  # (mu, raw_sigma)
    }


# -- the per-tenant composition (legacy ``score``) -----------------------------

def _backbone(params: Params, normed: torch.Tensor, cfg) -> torch.Tensor:
    """normed f32[B, T] -> features [B, T, D] (after ln_f), one tenant's
    params: the legacy ``score``'s composition (the stacked paths run
    ``_blocks``)."""
    dtype = cfg.compute_dtype
    t = normed.shape[1]
    x = dense(params["embed"], normed[..., None].to(dtype), dtype)
    x = x + params["pos"][:t].to(dtype)[None]
    for blk in params["blocks"]:
        x = transformer_block(blk, x, cfg.heads, causal=True, dtype=dtype)
    return layernorm(params["ln_f"], x)


def _emit(params: Params, feats: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    out = dense(params["head"], feats, cfg.compute_dtype).to(wide(cfg.compute_dtype))
    return out[..., 0], softplus(out[..., 1]) + 1e-4


# -- kernel KE: embedding -----------------------------------------------------------

def _embed_stacked(params: Params, normed: torch.Tensor, dtype) -> torch.Tensor:
    """normed f32[S, B, T] -> tokens [S, B, T, D]: the embed dense, then the
    pos add (a raw [S, context, D] table), each rounded."""
    t = normed.shape[-1]
    x = dense_stacked(params["embed"], normed[..., None].to(dtype), dtype)
    return x + params["pos"][:, :t].to(dtype)[:, None]


def _context(normed: torch.Tensor, context: int) -> torch.Tensor:
    """The last ``context`` normalized values of each row, a short row
    left-padded with its first value (``transformer.py:208-211``)."""
    ctx = normed[:, -context:]
    pad = context - ctx.shape[1]
    if pad > 0:
        ctx = torch.cat([ctx[:, :1].expand(-1, pad), ctx], dim=1)
    return ctx


def tf_embed_plain(
    params: Params, cfg, k: int = 1, *, state: Optional[WindowState] = None,
    ids=None, windows=None, n_valid=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of KE's score modes: rows ``ids`` [S, B] of the
    post-update rings ``state`` (or given windows f32[S, B, W] and
    n_valid) -> (tokens [S, B, W-1, D] in the compute dtype, normalized
    targets f32[S, B, K] of the last K positions, n_valid i32[S, B])."""
    if state is not None:
        windows, n_valid = gather_stacked(state, ids)
    k = clamp_fuse_k(k, windows.shape[-1])
    normed, _, _ = normalize_windows(windows)
    x = _embed_stacked(params, normed[..., :-1], cfg.compute_dtype)
    return x, normed[..., -k:].contiguous(), n_valid.to(torch.int32)


def tf_embed_context_plain(
    params: Params, cfg, ctx: Optional[torch.Tensor] = None,
    raw: Optional[torch.Tensor] = None,
):
    """Plain version of KE's context modes (one slot): tokens [1, B, C, D]
    of a normalized context f32[B, C]; or, given raw windows f32[B, L],
    (tokens, ctx f32[B, C], mu_n f32[B], sigma_n f32[B]) after normalizing
    them and taking the last C values (left-padded when L < C)."""
    if raw is None:
        return _embed_stacked(params, ctx[None], cfg.compute_dtype)
    normed, mu_n, sigma_n = normalize_windows(raw)
    ctx = _context(normed, cfg.context).contiguous()
    x = _embed_stacked(params, ctx[None], cfg.compute_dtype)
    return x, ctx, mu_n[:, 0].contiguous(), sigma_n[:, 0].contiguous()


def _embed_weights(params: Params):
    """KE's weights: (the embed's format, [w as stored, its int8 scales or
    None, b, pos])."""
    fmt = dense_format(params, ("embed",), "KE")
    w, scale = dense_leaf(params["embed"], fmt, "KE", "embed")
    return fmt, [w, scale, params["embed"]["b"].contiguous(), params["pos"].contiguous()]


def _launch_embed(params, cfg, mode, *, ring=None, ids=None, windows=None,
                  n_valid=None, src=None, x, targets=None, nv_out=None,
                  ctx_out=None, mu_out=None, sigma_out=None, t_slots, b, w, k,
                  tokens, rows) -> None:
    p = kernels.ptr
    fmt, (ew, es, eb, pos) = _embed_weights(params)
    kernels.launch(
        "tf_embed", p(ew), p(es), WEIGHT_FORMATS[fmt], p(eb), p(pos), pos.shape[-2],
        None if ring is None else p(ring.values),
        None if ring is None else p(ring.pos),
        None if ring is None else p(ring.count),
        0 if ring is None else ring.values.shape[1],
        p(ids), 0 if ids is None else ID_KINDS[ids.dtype],
        p(windows), p(n_valid), p(src), 0 if src is None else src.shape[-1],
        p(x), p(targets), p(nv_out), p(ctx_out), p(mu_out), p(sigma_out),
        mode, t_slots, b, w, cfg.dim, k, tokens, rows,
        ACT_KINDS[cfg.compute_dtype], kernels.stream_handle(x.device), variant=fmt,
    )


def tf_embed(
    params: Params, cfg, k: int = 1, *, state: Optional[WindowState] = None,
    ids=None, windows=None, n_valid=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel KE (``csrc/tf_embed.cu``) in its score modes: ring mode
    (``state`` + ``ids``, the flush) or windows mode (``windows`` +
    ``n_valid``, the ``score_stacked`` contract). Outputs as
    ``tf_embed_plain``."""
    dev_t = ids if state is not None else windows
    if not dev_t.is_cuda:
        return tf_embed_plain(params, cfg, k, state=state, ids=ids, windows=windows,
                              n_valid=n_valid)
    if state is not None:
        t_slots, b = ids.shape
        w = state.values.shape[-1]
        ids = ids.contiguous()
        windows = n_valid = None
    else:
        t_slots, b, w = windows.shape
        windows = windows.to(torch.float32).contiguous()
        n_valid = n_valid.to(torch.int32).contiguous()
    _check_tokens(cfg, w - 1)
    k = clamp_fuse_k(k, w)
    dev = dev_t.device
    x = torch.empty((t_slots, b, w - 1, cfg.dim), dtype=cfg.compute_dtype, device=dev)
    targets = torch.empty((t_slots, b, k), dtype=torch.float32, device=dev)
    nv = torch.empty((t_slots, b), dtype=torch.int32, device=dev)
    _launch_embed(params, cfg, 0, ring=state, ids=ids, windows=windows,
                  n_valid=n_valid, x=x, targets=targets, nv_out=nv,
                  t_slots=t_slots, b=b, w=w, k=k, tokens=w - 1, rows=16)
    return x, targets, nv


def ke_raw_route(length: int) -> str:
    """Which form of KE normalizes a raw history of ``length`` values,
    decided before any launch: "context" (``csrc/tf_embed.cu`` mode 2, the
    row in shared memory: every length it took before, up to
    ``KE_MAX_RAW``) or "raw" (``csrc/tf_embed_raw.cu``: a block's
    reduction over the history in global memory, any length)."""
    return "context" if length <= KE_MAX_RAW else "raw"


def tf_embed_raw(params: Params, cfg, raw: torch.Tensor):
    """KE's raw form (``csrc/tf_embed_raw.cu``, one slot): raw histories
    f32[B, L] of any length -> outputs as ``tf_embed_context_plain`` with
    ``raw``. ``tf_embed_context`` sends it the lengths past ``KE_MAX_RAW``;
    called directly it takes any (to time the two forms side by side)."""
    if not raw.is_cuda:
        return tf_embed_context_plain(params, cfg, raw=raw)
    c = cfg.context
    _check_tokens(cfg, c)
    src = raw.to(torch.float32).contiguous()
    b, length = src.shape
    if length < 1:
        raise ValueError("KE normalizes raw histories of at least one value")
    dev = src.device
    x = torch.empty((1, b, c, cfg.dim), dtype=cfg.compute_dtype, device=dev)
    ctx_out = torch.empty((b, c), dtype=torch.float32, device=dev)
    mu = torch.empty((b,), dtype=torch.float32, device=dev)
    sigma = torch.empty((b,), dtype=torch.float32, device=dev)
    fmt, (ew, es, eb, pos) = _embed_weights(params)
    p = kernels.ptr
    kernels.launch("tf_embed_raw", p(ew), p(es), WEIGHT_FORMATS[fmt], p(eb), p(pos),
                   pos.shape[-2], p(src), length, p(x), p(ctx_out), p(mu), p(sigma), b,
                   cfg.dim, c, ACT_KINDS[cfg.compute_dtype], kernels.stream_handle(dev),
                   variant=fmt)
    return x, ctx_out, mu, sigma


def tf_embed_context(params: Params, cfg, ctx=None, raw=None):
    """Kernel KE in its context modes (the forecast, one slot): outputs as
    ``tf_embed_context_plain``. Raw histories go to the form
    ``ke_raw_route`` gives their length."""
    src = raw if raw is not None else ctx
    if not src.is_cuda:
        return tf_embed_context_plain(params, cfg, ctx=ctx, raw=raw)
    if raw is not None and ke_raw_route(raw.shape[-1]) == "raw":
        return tf_embed_raw(params, cfg, raw)
    c = cfg.context
    _check_tokens(cfg, c)
    src = src.to(torch.float32).contiguous()
    b, length = src.shape
    if raw is None and length != c:
        raise ValueError(f"the context must be f32[B, {c}], got {tuple(src.shape)}")
    dev = src.device
    x = torch.empty((1, b, c, cfg.dim), dtype=cfg.compute_dtype, device=dev)
    if raw is None:
        _launch_embed(params, cfg, 1, src=src, x=x, t_slots=1, b=b, w=0, k=1,
                      tokens=c, rows=1)
        return x
    ctx_out = torch.empty((b, c), dtype=torch.float32, device=dev)
    mu = torch.empty((b,), dtype=torch.float32, device=dev)
    sigma = torch.empty((b,), dtype=torch.float32, device=dev)
    _launch_embed(params, cfg, 2, src=src, x=x, ctx_out=ctx_out, mu_out=mu,
                  sigma_out=sigma, t_slots=1, b=b, w=0, k=1, tokens=c, rows=1)
    return x, ctx_out, mu, sigma


def _check_tokens(cfg, tokens: int) -> None:
    if not 1 <= tokens <= cfg.context:
        raise ValueError(
            f"{tokens} tokens do not fit the position table of context {cfg.context}"
        )


# -- kernel KN: head ----------------------------------------------------------------

def tf_head_plain(
    params: Params, cfg, h: torch.Tensor, targets, n_valid, k: int, later=None,
    active=None, counts=None, mask=None, out_dtype=torch.float32,
) -> torch.Tensor:
    """Plain version of KN's score modes over the final residual stream h
    [S, B, T, D]: ln_f and the head on the last K positions, the NLL
    against ``targets`` f32[S, B, K] and the cold-start mask -> f32[S, B,
    K]; with ``later`` given, the flush epilogue on top -> [S, B] in
    ``out_dtype``."""
    feats = layernorm_stacked(params["ln_f"], h[..., -k:, :])
    out = dense_stacked(params["head"], feats, cfg.compute_dtype).to(wide(cfg.compute_dtype))
    nll = gaussian_nll(targets, out[..., 0], softplus(out[..., 1]) + 1e-4)
    sk = torch.where(kstep_mask(n_valid, k), nll, 0.0).to(torch.float32)
    if later is None:
        return sk
    return select_scores(sk, later, active, counts, mask, out_dtype)


def tf_head_forecast_plain(
    params: Params, cfg, h, ctx, ctx_next, eps_t, mu_n, sigma_n, samples, means,
    step: int,
) -> None:
    """Plain version of KN's forecast mode (one slot): from h [1, B, C, D]
    emit (mu, sigma) at the last position, ``x = mu + sigma * eps_t``,
    write column ``step`` of ``samples`` and ``means`` f32[B, horizon] in
    raw units and ``ctx[:, 1:] ++ x`` into ``ctx_next``."""
    feats = layernorm_stacked(params["ln_f"], h[:, :, -1:, :])
    out = dense_stacked(params["head"], feats, cfg.compute_dtype).to(wide(cfg.compute_dtype))[0, :, 0]
    mu, sigma = out[:, 0], softplus(out[:, 1]) + 1e-4
    x_next = mu + sigma * eps_t
    samples[:, step] = x_next * sigma_n + mu_n
    means[:, step] = mu * sigma_n + mu_n
    ctx_next[:, :-1] = ctx[:, 1:]
    ctx_next[:, -1] = x_next


def _head_weights(params: Params):
    """KN's weights: (the head's format, [ln_f scale, ln_f bias, w as
    stored, its int8 scales or None, b])."""
    fmt = dense_format(params, ("head",), "KN")
    w, scale = dense_leaf(params["head"], fmt, "KN", "head")
    return fmt, [params["ln_f"]["scale"].contiguous(), params["ln_f"]["bias"].contiguous(),
                 w, scale, params["head"]["b"].contiguous()]


def _launch_head(params, *args, stream) -> None:
    """KN's score and forecast modes: its weights in their format, then
    ``args`` (h onwards)."""
    fmt, (ls, lb, w, scale, b) = _head_weights(params)
    p = kernels.ptr
    kernels.launch("tf_head", p(ls), p(lb), p(w), p(scale), WEIGHT_FORMATS[fmt], p(b), *args,
                   stream, variant=fmt)


def tf_head(
    params: Params, cfg, h: torch.Tensor, targets, n_valid, k: int, later=None,
    active=None, counts=None, mask=None, out_dtype=torch.float32,
) -> torch.Tensor:
    """Kernel KN (``csrc/tf_head.cu``) in its score modes: outputs as
    ``tf_head_plain``. It reads only the last K positions of h: LayerNorm
    is per position, so ln_f there equals the reference's ln_f over all
    positions read at the last K."""
    if not h.is_cuda:
        return tf_head_plain(params, cfg, h, targets, n_valid, k, later, active,
                             counts, mask, out_dtype)
    h = h.contiguous()
    t_slots, b, t, _ = h.shape
    targets = targets.to(torch.float32).contiguous()
    n_valid = n_valid.to(torch.int32).contiguous()
    if later is None:
        out = torch.empty((t_slots, b, k), dtype=torch.float32, device=h.device)
    else:
        if (counts is None) == (mask is None):
            raise ValueError("pass exactly one of counts and mask")
        later = later.to(torch.int32).contiguous()
        active = active.to(torch.bool).contiguous()
        counts = None if counts is None else counts.to(torch.int32).contiguous()
        mask = None if mask is None else mask.to(torch.bool).contiguous()
        out = torch.empty((t_slots, b), dtype=out_dtype, device=h.device)
    p = kernels.ptr
    _launch_head(
        params, p(h), p(targets), p(n_valid), p(later), p(active), p(counts), p(mask), p(out),
        VAL_KINDS[out.dtype], None, None, None, None, None, None, None, 0, 0,
        t_slots, b, t, cfg.dim, k, ACT_KINDS[h.dtype], stream=kernels.stream_handle(h.device),
    )
    return out


def tf_head_forecast(
    params: Params, cfg, h, ctx, ctx_next, eps_t, mu_n, sigma_n, samples, means,
    step: int,
) -> None:
    """Kernel KN in forecast mode, one launch per horizon step: writes as
    ``tf_head_forecast_plain``."""
    if not h.is_cuda:
        return tf_head_forecast_plain(params, cfg, h, ctx, ctx_next, eps_t, mu_n,
                                      sigma_n, samples, means, step)
    h = h.contiguous()
    _, b, t, _ = h.shape
    for name, a in (("ctx", ctx), ("ctx_next", ctx_next), ("samples", samples),
                    ("means", means), ("eps_t", eps_t), ("mu_n", mu_n),
                    ("sigma_n", sigma_n)):
        if a.dtype != torch.float32 or not a.is_contiguous():
            raise ValueError(f"KN's forecast mode takes a contiguous f32 {name}")
    horizon = samples.shape[1]
    p = kernels.ptr
    _launch_head(
        params, p(h), None, None, None, None, None, None, None, 0, p(eps_t), p(mu_n), p(sigma_n),
        p(samples), p(means), p(ctx), p(ctx_next), step, horizon, 1, b, t, cfg.dim, 1,
        ACT_KINDS[h.dtype], stream=kernels.stream_handle(h.device),
    )


# -- the kernel path ------------------------------------------------------------------

class _Ops(NamedTuple):
    """The device functions a composition calls: the kernels' wrappers
    (which take the plain version on CPU tensors) or, for the plain twin on
    the card, the plain versions themselves."""
    embed: Callable
    embed_context: Callable
    layernorm: Callable
    attention: Callable
    bias_gelu: Callable
    head: Callable
    head_forecast: Callable
    weight: Callable  # the projections' weights: KQ for int8, or kernel_weight
    ring: Callable  # KA's ring step (the sequence-parallel backbone's attention)


KERNEL_OPS = _Ops(tf_embed, tf_embed_context, layernorm_rows, attention, bias_gelu,
                  tf_head, tf_head_forecast, dequant_weight, ring_step)
PLAIN_OPS = _Ops(tf_embed_plain, tf_embed_context_plain, layernorm_rows_plain,
                 attention_plain, bias_gelu_plain, tf_head_plain, tf_head_forecast_plain,
                 kernel_weight, ring_step_plain)


def _blocks(params: Params, x: torch.Tensor, cfg, ops: _Ops = KERNEL_OPS) -> torch.Tensor:
    """The causal blocks over tokens x [S, B, T, D] -> the final residual
    stream (before ln_f, which KN applies): the blocks of the reference's
    ``_backbone_stacked`` (``transformer.py:229``) as the shared
    composition ``models.common.blocks_stacked`` runs them (KL, KA, KU)."""
    return blocks_stacked(params["blocks"], x, cfg.heads, True, cfg.compute_dtype, ops)


def _score_stacked(params, cfg, windows, n_valid, k: int, ops: _Ops) -> torch.Tensor:
    k = clamp_fuse_k(k, windows.shape[-1])
    x, targets, nv = ops.embed(params, cfg, k, windows=windows, n_valid=n_valid)
    return ops.head(params, cfg, _blocks(params, x, cfg, ops), targets, nv, k)


def _tf_score(params, cfg, state, ids, later, active, counts, mask, k, out_dtype,
              ops: _Ops) -> torch.Tensor:
    k = clamp_fuse_k(k, state.values.shape[-1])
    x, targets, nv = ops.embed(params, cfg, k, state=state, ids=ids)
    return ops.head(params, cfg, _blocks(params, x, cfg, ops), targets, nv, k, later,
                    active, counts, mask, out_dtype)


def _forecast(params, cfg, windows, eps, ops: _Ops) -> Tuple[torch.Tensor, torch.Tensor]:
    stacked = tree_map(lambda x: x[None], params)
    x, ctx, mu_n, sigma_n = ops.embed_context(stacked, cfg, raw=windows)
    nxt = torch.empty_like(ctx)
    b = windows.shape[0]
    samples = torch.empty((b, cfg.horizon), dtype=torch.float32, device=windows.device)
    means = torch.empty_like(samples)
    for step in range(cfg.horizon):
        if step:
            x = ops.embed_context(stacked, cfg, ctx=ctx)
        h = _blocks(stacked, x, cfg, ops)
        ops.head_forecast(stacked, cfg, h, ctx, nxt, eps[step], mu_n, sigma_n,
                          samples, means, step)
        ctx, nxt = nxt, ctx
    return samples, means


# -- plain versions: the same compositions over the kernels' plain versions ----

def score_stacked_plain(
    params: Params, cfg, windows: torch.Tensor, n_valid: torch.Tensor, k: int = 1,
) -> torch.Tensor:
    """Plain version of ``score_stacked``: f32[S, B, K], column j the NLL
    at window position W-K+j (j = K-1 is the newest)."""
    return _score_stacked(params, cfg, windows, n_valid, k, PLAIN_OPS)


def tf_score_plain(
    params: Params, cfg, state: WindowState, ids, later, active, counts=None,
    mask=None, k: int = 1, out_dtype=torch.float32,
) -> torch.Tensor:
    """Plain version of the flush form: scores [T, B] in ``out_dtype``."""
    return _tf_score(params, cfg, state, ids, later, active, counts, mask, k, out_dtype,
                     PLAIN_OPS)


def forecast_plain(
    params: Params, cfg, windows: torch.Tensor, eps: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``forecast``: windows f32[B, L], eps f32[horizon,
    B] -> (samples, means) f32[B, horizon] in raw units."""
    return _forecast(params, cfg, windows, eps, PLAIN_OPS)


# -- entry points -----------------------------------------------------------------------

def score_stacked(
    params: Params, cfg, windows: torch.Tensor, n_valid: torch.Tensor, k: int = 1,
) -> torch.Tensor:
    """Fused NLL scoring over a stacked tenant plane: windows f32[S, B, W],
    n_valid i32[S, B] -> f32[S, B, K]. CPU tensors take the plain version;
    CUDA tensors launch KE, the blocks' KL/KA/KU and KN."""
    if not windows.is_cuda:
        return score_stacked_plain(params, cfg, windows, n_valid, k=k)
    check_kernel_params(params, cfg, "the transformer's kernel path")
    return _score_stacked(params, cfg, windows, n_valid, k, KERNEL_OPS)


def _check_per_tenant(params: Params, label: str) -> None:
    """The per-tenant paths read each dense layer's ``w``, as the
    reference's ``dense`` (``common.py:31``) does: a bf16 tree serves, an
    int8 tree (``qw`` and ``scale``, no ``w``) raises, as it does there."""
    if has_int8(params):
        raise ValueError(
            f"{label} reads each dense layer's w, as the reference's dense "
            "(common.py:31) does; an int8 tree has qw and scale instead (score it "
            "through score_stacked or a ShardedScorer)")


def score(params: Params, cfg, windows: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """Anomaly-score adapter (the legacy per-tenant scorer): the NLL of the
    newest sample; rows with fewer than 4 samples score 0. On CUDA tensors
    it is the kernel path over one slot. Reads f32 or bf16 trees."""
    _check_per_tenant(params, "the transformer's per-tenant score")
    if windows.is_cuda:
        stacked = tree_map(lambda x: x[None], params)
        return score_stacked(stacked, cfg, windows[None], n_valid[None])[0, :, 0]
    normed, _, _ = normalize_windows(windows)
    mu, sigma = _emit(params, _backbone(params, normed[:, :-1], cfg)[:, -1], cfg)
    nll = gaussian_nll(normed[:, -1], mu, sigma)
    return torch.where(n_valid >= 4, nll, 0.0).to(torch.float32)


def tf_score(
    params: Params, cfg, state: WindowState, ids, later, active, counts=None,
    mask=None, k: int = 1, out_dtype=torch.float32,
) -> torch.Tensor:
    """The scoring flush's form (``models/flush.py``): scores [T, B] in
    ``out_dtype`` for rows ``ids`` [T, B] of the post-update rings. CPU
    tensors take ``tf_score_plain``; CUDA tensors launch KE (ring mode),
    the blocks' kernels and KN (flush mode)."""
    if not ids.is_cuda:
        return tf_score_plain(params, cfg, state, ids, later, active, counts, mask,
                              k, out_dtype)
    check_kernel_params(params, cfg, "the transformer's kernel path")
    return _tf_score(params, cfg, state, ids, later, active, counts, mask, k, out_dtype,
                     KERNEL_OPS)


def forecast(
    params: Params, cfg, windows: torch.Tensor,
    generator: Optional[torch.Generator] = None, eps: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Autoregressive forecast over the horizon, one sampled path per
    series: windows f32[B, L] raw history -> (samples f32[B, horizon],
    means f32[B, horizon]) in raw units. The context is the last
    ``cfg.context`` normalized values (left-padded when shorter), shifted
    by one sample each step. The noise is drawn from ``generator`` (on the
    windows' device) as eps f32[horizon, B], or pass ``eps`` itself. CPU
    tensors take ``forecast_plain``; CUDA tensors launch KE, the blocks'
    kernels and KN each step. Reads f32 or bf16 trees."""
    if (generator is None) == (eps is None):
        raise ValueError("pass exactly one of generator and eps")
    _check_per_tenant(params, "the transformer's forecast")
    b = windows.shape[0]
    if eps is None:
        eps = torch.randn((cfg.horizon, b), generator=generator, dtype=torch.float32,
                          device=windows.device)
    if tuple(eps.shape) != (cfg.horizon, b):
        raise ValueError(f"eps must be f32[{cfg.horizon}, {b}], got {tuple(eps.shape)}")
    if not windows.is_cuda:
        return forecast_plain(params, cfg, windows, eps)
    check_kernel_params(params, cfg, "the transformer's forecast")
    return _forecast(params, cfg, windows, eps.to(torch.float32).contiguous(), KERNEL_OPS)


# -- the sequence-parallel long-context path (the reference's transformer.py:83
# _backbone_local, :118 backbone_sharded, :156 forecast_seed_sharded) -----------

def _ring_ops(ops: _Ops, axis) -> _Ops:
    """``ops`` with the blocks' attention as the ring over ``axis``: q, k,
    v [B, Tl, D] (one slot) reshaped to heads and cast to f32 (the
    reference's ``transformer.py:108-110``), ``ring_attention_local`` over
    ``ops.ring``, the output cast back to the compute dtype."""
    def ring(q, k, v, heads, causal=True):
        b, t, d = q.shape
        dtype = q.dtype
        q, k, v = (a.reshape(b, t, heads, -1).to(torch.float32) for a in (q, k, v))
        out = ring_attention_local(q, k, v, axis, causal=causal, step=ops.ring)
        return out.reshape(b, t, d).to(dtype)

    return ops._replace(attention=ring)


def _backbone_local(params: Params, normed_local: torch.Tensor, cfg, axis,
                    ops: _Ops = KERNEL_OPS) -> torch.Tensor:
    """The per-rank body: normed_local f32[B, Tl], this rank's block of the
    context -> its features [B, Tl, D] (after ln_f). The token-local ops
    run on the block: the embed as a matmul, then ``_blocks`` on one slot
    (KL, the projections, KU); only attention crosses ranks, as the ring
    (``_ring_ops``)."""
    dtype = cfg.compute_dtype
    b, tl = normed_local.shape
    x = dense(params["embed"], normed_local[..., None].to(dtype), dtype)
    x = x + params["pos"][axis.rank * tl:(axis.rank + 1) * tl].to(dtype)[None]
    one = tree_map(lambda a: a[None], {"blocks": params["blocks"], "ln_f": params["ln_f"]})
    x = _blocks(one, x[None], cfg, _ring_ops(ops, axis))
    ln_f, d = one["ln_f"], x.shape[-1]
    return ops.layernorm(x.reshape(-1, d), ln_f["scale"], ln_f["bias"], b * tl).reshape(b, tl, d)


def backbone_sharded(params: Params, cfg, normed: torch.Tensor, axis,
                     ops: _Ops = KERNEL_OPS) -> torch.Tensor:
    """Sequence-parallel backbone over the ranks of ``axis``
    (``parallel/dist.py``): normed f32[B, T] (every rank holds it; T a
    multiple of the rank count) -> features [B, T, D] on every rank. Each
    rank holds T/n tokens and the full params; attention runs as a ring.
    CUDA tensors launch KL, KU and KA's ring step; CPU tensors take their
    plain versions."""
    t, n = normed.shape[1], axis.size
    if t > cfg.context:
        # fail loudly: the position slice of the trailing ranks would run
        # past the table
        raise ValueError(f"context {t} exceeds cfg.context {cfg.context}; truncate first")
    if t % n:
        raise ValueError(f"context {t} must divide across {n} ranks")
    _check_per_tenant(params, "the sequence-parallel backbone")
    if normed.is_cuda:
        check_kernel_params(params, cfg, "the sequence-parallel backbone")
    feats = _backbone_local(params, axis.block(normed, 1).contiguous(), cfg, axis, ops)
    return axis.all_gather(feats, 1)


def forecast_seed_sharded(params: Params, cfg, windows: torch.Tensor, axis,
                          ops: _Ops = KERNEL_OPS) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mu, sigma) f32[B] of the NEXT step after a long raw history
    windows f32[B, T], in raw units: the last ``cfg.context`` values
    normalized, the sequence-parallel backbone over ``axis``, the head on
    the last position."""
    windows = windows[:, -cfg.context:]
    normed, mu_n, sigma_n = normalize_windows(windows)
    feats = backbone_sharded(params, cfg, normed, axis, ops)
    mu, sigma = _emit(params, feats[:, -1:], cfg)
    return mu[:, 0] * sigma_n[:, 0] + mu_n[:, 0], sigma[:, 0] * sigma_n[:, 0]


# -- the train form: KE's train mode and backward, KN's train mode, the blocks'
# backward kernels ------------------------------------------------------------------

def tf_embed_train_plain(params: Params, cfg, *, state: Optional[WindowState] = None,
                         windows=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of KE's train mode: every stream's window of the rings
    ``state`` [S, streams, W] (or given windows f32[S, B, W]) -> (tokens
    [S, B, W-1, D] in the compute dtype, the normalized windows f32[S, B,
    W]: KN's train mode reads their next values, KE's backward their
    inputs)."""
    if state is not None:
        windows = ring_windows(state)
    normed, _, _ = normalize_windows(windows)
    return _embed_stacked(params, normed[..., :-1], cfg.compute_dtype), normed


def tf_embed_train(params: Params, cfg, *, state: Optional[WindowState] = None,
                   windows=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel KE in its train mode (score mode with K = W: the whole
    normalized window is written): outputs as ``tf_embed_train_plain``.
    Ring mode gathers every stream of every slot (ids ``arange(streams)``)."""
    dev_t = state.values if state is not None else windows
    if not dev_t.is_cuda:
        return tf_embed_train_plain(params, cfg, state=state, windows=windows)
    if state is not None:
        t_slots, b, w = state.values.shape
        ids = torch.arange(b, dtype=torch.int32, device=dev_t.device)[None].expand(t_slots, b)
        ids, windows, n_valid = ids.contiguous(), None, None
    else:
        t_slots, b, w = windows.shape
        windows = windows.to(torch.float32).contiguous()
        n_valid = torch.full((t_slots, b), w, dtype=torch.int32, device=dev_t.device)
        ids = None
    _check_tokens(cfg, w - 1)
    dev = dev_t.device
    x = torch.empty((t_slots, b, w - 1, cfg.dim), dtype=cfg.compute_dtype, device=dev)
    normed = torch.empty((t_slots, b, w), dtype=torch.float32, device=dev)
    nv = torch.empty((t_slots, b), dtype=torch.int32, device=dev)
    _launch_embed(params, cfg, 0, ring=state, ids=ids, windows=windows, n_valid=n_valid, x=x,
                  targets=normed, nv_out=nv, t_slots=t_slots, b=b, w=w, k=w, tokens=w - 1,
                  rows=16)
    return x, normed


def tf_embed_bwd_plain(dx: torch.Tensor, normed: torch.Tensor, context: int):
    """Plain version of KE's backward: the tokens' cotangent dx [S, B, T,
    D] in the compute dtype and the normalized windows f32[S, B, W] (token
    t of a row is its value t, cast to the compute dtype) -> (d embed.w
    [S, 1, D], d embed.b [S, D], d pos [S, context, D], zero at rows T and
    past), each summed in f32 and rounded to the compute dtype once, as
    the reference's bf16 dot and reductions before the casts to the f32
    params."""
    dt, wd = dx.dtype, wide(dx.dtype)
    s, _, t, d = dx.shape
    v = normed[..., :t].to(dt).to(wd)
    g = dx.to(wd)
    dw = torch.einsum("sbt,sbtd->sd", v, g).to(dt).to(wd)[:, None, :]
    db = g.sum((1, 2)).to(dt).to(wd)
    dpos = torch.zeros((s, context, d), dtype=wd, device=dx.device)
    dpos[:, :t] = g.sum(1).to(dt).to(wd)
    return dw, db, dpos


def tf_embed_bwd(dx: torch.Tensor, normed: torch.Tensor, context: int):
    """Kernel KE's backward (``csrc/tf_embed_bwd.cu``): outputs as
    ``tf_embed_bwd_plain``; the per-slot sums are deterministic."""
    if not dx.is_cuda:
        return tf_embed_bwd_plain(dx, normed, context)
    dx, normed = dx.contiguous(), normed.to(torch.float32).contiguous()
    if dx.dtype not in ACT_KINDS:
        raise TypeError(f"KE's backward takes float32 or bfloat16 tokens, got {dx.dtype}")
    s, b, t, d = dx.shape
    w = normed.shape[-1]
    if normed.shape[:2] != (s, b) or not t <= w or not t <= context:
        raise ValueError(f"KE's backward: tokens {tuple(dx.shape)}, windows {tuple(normed.shape)}")
    dev = dx.device
    part = torch.empty((s, (b + KE_BWD_TILE_ROWS - 1) // KE_BWD_TILE_ROWS, 2 * t * d),
                       dtype=torch.float32, device=dev)
    red = torch.empty((s, 2 * t * d), dtype=torch.float32, device=dev)
    dw = torch.empty((s, 1, d), dtype=torch.float32, device=dev)
    db = torch.empty((s, d), dtype=torch.float32, device=dev)
    dpos = torch.empty((s, context, d), dtype=torch.float32, device=dev)
    p = kernels.ptr
    kernels.launch(
        "tf_embed_bwd", p(dx), p(normed), p(part), p(red), p(dw), p(db), p(dpos), s, b, t, d,
        w, context, ACT_KINDS[dx.dtype], kernels.stream_handle(dev),
    )
    return dw, db, dpos


def tf_head_train_plain(params: Params, cfg, h: torch.Tensor, normed: torch.Tensor):
    """Plain version of KN's train mode (forward): from the final residual
    stream h [S, B, T, D], ln_f and the head at every position, softplus +
    1e-4 and the Gaussian NLL against the next normalized values
    ``normed[..., 1:]`` -> (the per-row mean f32[S, B], the head outputs
    (mu, raw sigma) f32[S, B, T, 2] the backward reads)."""
    t = h.shape[-2]
    feats = layernorm_stacked(params["ln_f"], h)
    out = dense_stacked(params["head"], feats, cfg.compute_dtype).to(wide(cfg.compute_dtype))
    nll = gaussian_nll(normed[..., 1:t + 1], out[..., 0], softplus(out[..., 1]) + 1e-4)
    return nll.sum(-1) * (1.0 / t), out


TWO_PI_F32 = 6.2831855  # 2 * pi as the reference's f32 constant


def tf_head_train_bwd_plain(params: Params, cfg, h, normed, out, g_row):
    """Plain version of KN's train mode (backward): the seed g_row f32[S,
    B] -> (d feats [S, B, T, D] in the compute dtype, ln_f's output
    cotangent; d head.w f32[S, D, 2]; d head.b f32[S, 2]). The NLL's
    derivatives in f32 in the reference's grad HLO's order, rounded to the
    compute dtype; the head's gradients summed in f32 and rounded once."""
    dt, wd = cfg.compute_dtype, wide(cfg.compute_dtype)
    s, b, t, d = h.shape
    g = g_row.to(wd)[..., None]
    gm, hm = g * (1.0 / t), g * (0.5 / t)
    mu, raw = out[..., 0], out[..., 1]
    sp = softplus(raw)
    sg = sp + 1e-4
    dd = normed[..., 1:t + 1] - mu
    s2 = sg * sg
    two_s2, two_s = s2 * 2.0, sg * 2.0
    dmu = -((gm / two_s2) * (dd * 2.0))
    dsig = (-((gm * (1.0 / (two_s2 * two_s2))) * (dd * dd)) * 2.0) * two_s + (
        (hm / (s2 * TWO_PI_F32)) * TWO_PI_F32) * two_s
    dout = torch.stack([dmu, dsig * torch.exp(raw - sp)], -1).to(dt)
    feats = layernorm_stacked(params["ln_f"], h)
    w = kernel_weight(params["head"], dt)
    dfeats = torch.bmm(dout.reshape(s, -1, 2), w.transpose(1, 2)).reshape(h.shape)
    dw = torch.bmm(feats.reshape(s, -1, d).transpose(1, 2).to(wd),
                   dout.reshape(s, -1, 2).to(wd)).to(dt).to(wd)
    db = dout.to(wd).sum((1, 2)).to(dt).to(wd)
    return dfeats, dw, db


def _launch_head_train(params, cfg, mode, h, normed, out, per_row=None, g_row=None,
                       dfeats=None, part=None, red=None) -> None:
    t_slots, b, t, d = h.shape
    _, (ls, lb, w, _, hb) = _head_weights(params)
    if w.dtype != torch.float32:
        raise TypeError(f"KN's train mode reads the f32 head weight, got {w.dtype}")
    p = kernels.ptr
    kernels.launch(
        "tf_head_train", mode, p(ls), p(lb), p(w), p(hb), p(h), p(normed), p(out),
        p(per_row), p(g_row), p(dfeats), p(part), p(red), t_slots, b, t, d, normed.shape[-1],
        ACT_KINDS[h.dtype], kernels.stream_handle(h.device), variant=("fwd", "bwd")[mode],
    )


def tf_head_train(params: Params, cfg, h: torch.Tensor, normed: torch.Tensor):
    """Kernel KN in its train mode, forward (``csrc/tf_head.cu``
    ``sw_tf_head_train``): outputs as ``tf_head_train_plain``."""
    if not h.is_cuda:
        return tf_head_train_plain(params, cfg, h, normed)
    h, normed = h.contiguous(), normed.to(torch.float32).contiguous()
    t_slots, b, t, _ = h.shape
    if normed.shape != (t_slots, b, t + 1):
        raise ValueError(f"KN's train mode takes windows f32[{t_slots}, {b}, {t + 1}]")
    out = torch.empty((t_slots, b, t, 2), dtype=torch.float32, device=h.device)
    per_row = torch.empty((t_slots, b), dtype=torch.float32, device=h.device)
    _launch_head_train(params, cfg, 0, h, normed, out, per_row=per_row)
    return per_row, out


def tf_head_train_bwd(params: Params, cfg, h, normed, out, g_row):
    """Kernel KN in its train mode, backward: outputs as
    ``tf_head_train_bwd_plain``; the head's gradient sums deterministic."""
    if not h.is_cuda:
        return tf_head_train_bwd_plain(params, cfg, h, normed, out, g_row)
    h, normed = h.contiguous(), normed.to(torch.float32).contiguous()
    out, g_row = out.contiguous(), g_row.to(torch.float32).contiguous()
    t_slots, b, t, d = h.shape
    dfeats = torch.empty_like(h)
    part = torch.empty((t_slots, (b + KN_TRAIN_TILE_ROWS - 1) // KN_TRAIN_TILE_ROWS, 2 * d + 32),
                       dtype=torch.float32, device=h.device)
    red = torch.empty((t_slots, 2 * d + 32), dtype=torch.float32, device=h.device)
    _launch_head_train(params, cfg, 1, h, normed, out, g_row=g_row, dfeats=dfeats, part=part,
                       red=red)
    return dfeats, red[:, :2 * d].reshape(t_slots, 2, d).transpose(1, 2), red[:, 2 * d:2 * d + 2]




class _TrainOps(NamedTuple):
    """The device functions of the train form: KE's train mode and
    backward, KN's train mode (forward, backward) and the blocks'
    (``models.common.BlockTrainOps``); the kernels' wrappers or the plain
    versions (the plain twin)."""
    embed: Callable
    embed_bwd: Callable
    head: Callable
    head_bwd: Callable
    blocks: BlockTrainOps


TRAIN_KERNEL_OPS = _TrainOps(tf_embed_train, tf_embed_bwd, tf_head_train, tf_head_train_bwd,
                             BLOCK_TRAIN_KERNELS)
TRAIN_PLAIN_OPS = _TrainOps(tf_embed_train_plain, tf_embed_bwd_plain, tf_head_train_plain,
                            tf_head_train_bwd_plain, BLOCK_TRAIN_PLAIN)


class TrainLoss(torch.autograd.Function):
    """The train loss under autograd: ``apply(cfg, ops, params, state,
    windows, *tree_leaves(params))`` -> per-row loss f32[S, B] (one of
    ``state`` and ``windows`` given). The forward runs KE's train mode,
    the blocks keeping what their backward reads, and KN's train mode; the
    backward, from the seed of whatever reduces the loss, runs KN's train
    backward, ln_f's KL backward, the blocks in reverse and KE's backward,
    and returns every leaf's gradient."""

    @staticmethod
    def forward(ctx, cfg, ops: _TrainOps, params, state, windows, *leaves):
        dtype = cfg.compute_dtype
        x, normed = ops.embed(params, cfg, state=state, windows=windows)
        h, saved = blocks_train_forward(params["blocks"], x, cfg.heads, True, dtype, ops.blocks)
        per_row, out = ops.head(params, cfg, h, normed)
        ctx.cfg, ctx.ops, ctx.params = cfg, ops, params
        ctx.normed, ctx.saved, ctx.h, ctx.out = normed, saved, h, out
        return per_row

    @staticmethod
    def backward(ctx, g_row):
        cfg, ops, params, h = ctx.cfg, ctx.ops, ctx.params, ctx.h
        dtype = cfg.compute_dtype
        s, b, t, d = h.shape
        dfeats, dw_head, db_head = ops.head_bwd(params, cfg, h, ctx.normed, ctx.out, g_row)
        dh, dsf, dbf = ops.blocks.layernorm_bwd(h.reshape(-1, d), params["ln_f"]["scale"],
                                                dfeats.reshape(-1, d), b * t)
        dx, block_grads = blocks_train_backward(params["blocks"], ctx.saved, dh.reshape(h.shape),
                                                cfg.heads, True, dtype, ops.blocks)
        dew, deb, dpos = ops.embed_bwd(dx, ctx.normed, params["pos"].shape[-2])
        grads = {
            "embed": {"w": dew, "b": deb}, "pos": dpos, "blocks": block_grads,
            "ln_f": {"scale": dsf, "bias": dbf}, "head": {"w": dw_head, "b": db_head},
        }
        ctx.params = ctx.normed = ctx.saved = ctx.h = ctx.out = None
        return (None,) * 5 + tuple(leaves_like(params, grads))


def _train_loss(params: Params, cfg, ops: _TrainOps, *, state=None, windows=None):
    w = (state.values if state is not None else windows).shape[-1]
    _check_tokens(cfg, w - 1)
    return TrainLoss.apply(cfg, ops, params, state, windows, *tree_leaves(params))


def loss_stacked_plain(params: Params, cfg, windows: torch.Tensor) -> torch.Tensor:
    """Plain version of ``loss_stacked``: the train form over the plain
    versions (differentiable in ``params``; the card's plain twin)."""
    return _train_loss(params, cfg, TRAIN_PLAIN_OPS, windows=windows)


def loss_stacked(params: Params, cfg, windows: torch.Tensor) -> torch.Tensor:
    """Per-row causal next-step Gaussian NLL over a stacked plane: windows
    f32[S, B, W] -> f32[S, B], the mean over the W-1 positions,
    differentiable in ``params`` (``transformer.py:272``). CPU tensors take
    the plain version; CUDA tensors launch KE (train mode), the blocks'
    KL, KA, KU, KN's train mode and, under backward, their backward
    kernels."""
    if not windows.is_cuda:
        return loss_stacked_plain(params, cfg, windows)
    check_kernel_params(params, cfg, "the transformer's train form", TRAIN_MASTERS)
    return _train_loss(params, cfg, TRAIN_KERNEL_OPS, windows=windows)


def loss_ring(params: Params, cfg, state: WindowState) -> torch.Tensor:
    """``loss_stacked`` over every stream of the rings ``state`` [S,
    streams, W] -> f32[S, streams]. CPU tensors take the plain version on
    the gathered windows; CUDA tensors launch the kernels, KE gathering
    each stream's window from the rings."""
    if not state.values.is_cuda:
        return loss_stacked_plain(params, cfg, ring_windows(state))
    check_kernel_params(params, cfg, "the transformer's train form", TRAIN_MASTERS)
    for x in state:
        if not x.is_contiguous():
            raise ValueError("the train form takes contiguous rings")
    return _train_loss(params, cfg, TRAIN_KERNEL_OPS, state=state)


def loss(params: Params, cfg, windows: torch.Tensor) -> torch.Tensor:
    """Causal next-step Gaussian NLL over the window, one tenant's params:
    windows f32[B, W] -> the scalar mean (``transformer.py:185``). On CPU
    tensors the reference's per-tenant composition under autograd; on CUDA
    tensors ``loss_stacked`` over one slot, the mean of its per-row means
    (every row has W-1 positions, so it is the same mean)."""
    if windows.is_cuda:
        stacked = tree_map(lambda x: x[None], params)
        return loss_stacked(stacked, cfg, windows[None])[0].mean()
    normed, _, _ = normalize_windows(windows)
    mu, sigma = _emit(params, _backbone(params, normed[:, :-1], cfg), cfg)
    return gaussian_nll(normed[:, 1:], mu, sigma).mean()


def train_step(params: Params, opt_state, windows: torch.Tensor, cfg, optimizer):
    """One optimizer step on ``loss``: (params, opt_state, loss).
    ``optimizer`` has optax's ``update(grads, state, params)`` surface; the
    port's Adam (``ops.adam.scale_by_adam()``, ``adam(lr)``) runs as KO on
    CUDA tensors, in place (``ops.adam.apply_step``)."""
    value, grads = value_and_grad(lambda p: loss(p, cfg, windows), params)
    params, opt_state = optim.apply_step(optimizer, params, grads, opt_state)
    return params, opt_state, value


def train_bytes_per_row(cfg, window: int) -> int:
    """Device bytes the kernel train form holds a row (one stream's window)
    between its forward and backward, with one block's backward in flight:
    16 D values a token a block saved in the compute dtype (the block input,
    ln1's output, q, k, v, the attention output, the residual, ln2's
    output, fc1's product and the GELU output), ~14 D a token of cotangents
    in flight, the head outputs and the normalized window in f32."""
    t = window - 1
    size = torch.tensor([], dtype=cfg.compute_dtype).element_size()
    return t * cfg.dim * size * (16 * cfg.depth + 14) + 8 * t + 4 * window
