"""ViT-B/16 frame classifier — the port of ``sitewhere_tpu/models/vit.py``.

Standard ViT (patch embed -> [CLS] + learned positions -> pre-LN blocks ->
ln_f -> head), params as a plain dict tree with the reference's keys. The
default config is the real B/16 (224, patch 16, dim 768, depth 12, 12
heads, 1000 classes; bf16 compute, f32 params); the tests use a tiny one.

Serving paths and their kernels (all CUDA C++ in ``csrc/``):

- frames (u8, normalized on the device, or pre-normalized f32): KP
  ``frame_patches`` (normalize, patchify, cast);
- the compressed wire's zigzag DCT coefficients: KJ ``dct_patches``
  (``ops/dct.py``: decode, normalize, patchify, cast);
- then the patch projection (``torch.matmul``), KV ``vit_embed`` (the
  projection's bias, [CLS], positions), the blocks
  (``models.common.blocks_stacked``, non-causal, the block params as one
  slot: KL, the projections, KA, KU) and KT ``vit_head`` (ln_f on the CLS
  row, the head, the f32 softmax and the top-k at any 0 <= k <= C, lower
  index first on ties as ``jax.lax.top_k``).

The serving paths read an f32 master tree or a bf16-stored one
(``quantize_params(params, "bf16")``: KT reads the head weight as stored,
the projections read theirs through ``kernel_weight``); an int8 tree
raises on any device, as the reference's ``dense`` cannot run it
(``INT8_TREE``). The train form reads f32 masters only.

Each path is one composition (``_classify``, ``_classify_dct`` over
``_encode``) of the kernels' wrappers, which take their plain versions on
CPU tensors and launch the kernels on CUDA tensors; ``classify_plain`` and
``classify_dct_plain`` run the same compositions over the plain versions
on any device (the card's plain twin; ``apply`` is ``classify``'s
logits). ``shard_params_tp`` and ``apply_tp`` are the tensor-parallel
forward over the ranks of a ``parallel.dist.Axis``: the same kernels, each
block at the rank's heads with two psums
(``models.common.transformer_block_tp``).

Training (``vit.py:121`` ``loss``, ``:127`` ``train_step``): ``loss`` is
``ViTTrainLoss``, an autograd Function whose forward runs KP on the f32
frames, the patch projection, KV, the blocks with their saves
(``models.common.blocks_train_forward``: KL, KA, KU; non-causal, one slot)
and KT's train mode (``vit_head_train``: ln_f, the head, log_softmax and
the mean NLL at the labels), and whose backward runs KT's train backward
(dlogits, the head's gradients, ln_f's backward on the [CLS] rows, fused),
the blocks in reverse (KU's, KA's and KL's backward kernels; the
projections' gradients as batched matmuls) and KV's backward
(``vit_embed_bwd``), with d patch.w a GEMM. ``loss_plain`` runs the same
composition over the plain versions (``TRAIN_PLAIN_OPS``, the card's plain
twin). ``train_step`` steps the port's Adam as one KO call on the card
(``ops.adam.apply_step``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Tuple

import numpy as np
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
    dense,
    dense_init,
    has_int8,
    kernel_weight,
    layernorm,
    layernorm_init,
    layernorm_rows,
    layernorm_bwd_plain,
    layernorm_rows_plain,
    leaves_like,
    shard_block_params_tp,
    transformer_block_init,
    transformer_block_tp,
    tree_leaves,
    tree_map,
    value_and_grad,
    wide,
)
from sitewhere_tpu_torch.models.flush import WEIGHT_FORMATS
from sitewhere_tpu_torch.ops import adam as optim
from sitewhere_tpu_torch.ops.dct import FrameLayout, dct_patches, dct_patches_plain


@dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    dim: int = 768
    depth: int = 12
    heads: int = 12
    num_classes: int = 1000
    channels: int = 3
    dtype: str = "bfloat16"

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def compute_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]


VIT_B16 = ViTConfig()
VIT_TINY_TEST = ViTConfig(image_size=32, patch_size=8, dim=64, depth=2, heads=2, num_classes=10)


def init(gen: torch.Generator, cfg: ViTConfig = VIT_B16, device="cuda") -> Params:
    """Random params with the reference's distributions, drawn on the CPU
    from ``gen`` and moved to ``device``."""
    patch_dim = cfg.patch_size * cfg.patch_size * cfg.channels
    cls = torch.randn((1, 1, cfg.dim), generator=gen, dtype=torch.float32) * 0.02
    pos = torch.randn((cfg.num_patches + 1, cfg.dim), generator=gen, dtype=torch.float32) * 0.02
    return {
        "patch": dense_init(gen, patch_dim, cfg.dim, device=device),
        "cls": cls.to(device),
        "pos": pos.to(device),
        "blocks": [
            transformer_block_init(gen, cfg.dim, cfg.heads, device=device)
            for _ in range(cfg.depth)
        ],
        "ln_f": layernorm_init(cfg.dim, device),
        "head": dense_init(gen, cfg.dim, cfg.num_classes, device=device),
    }


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, N, patch*patch*C] non-overlapping patches."""
    b, h, w, c = images.shape
    gh, gw = h // patch, w // patch
    x = images.reshape(b, gh, patch, gw, patch, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, gh * gw, patch * patch * c)


# -- kernel KP: frames -> patches ---------------------------------------------------

# the u8 wire's normalization (x / 255 - 0.5) / 0.5 of every u8 value, op by
# op in f32 (numpy divides exactly rounded): after the cast to bf16 it is
# bitwise the reference's jitted form (streaming_media.py:151-153)
_U8_NORM = (np.arange(256, dtype=np.float32) / np.float32(255.0) - np.float32(0.5)) \
    / np.float32(0.5)


def frame_patches_plain(frames: torch.Tensor, patch: int, dtype: torch.dtype) -> torch.Tensor:
    """Plain version of KP: u8 frames [B, H, W, C] normalized (``_U8_NORM``)
    or float frames as they are, patchified and cast to ``dtype``."""
    if frames.dtype == torch.uint8:
        frames = torch.from_numpy(_U8_NORM).to(frames.device)[frames.long()]
    return patchify(frames, patch).to(dtype)


FRAME_KINDS = {torch.float32: 0, torch.uint8: 1}  # frame dtypes KP takes


def frame_patches(frames: torch.Tensor, patch: int, dtype: torch.dtype) -> torch.Tensor:
    """Kernel KP (``csrc/frame_patches.cu``): frames [B, H, W, C] (u8, or
    pre-normalized f32) -> patches [B, N, patch*patch*C] in ``dtype``, as
    ``frame_patches_plain``."""
    if not frames.is_cuda:
        return frame_patches_plain(frames, patch, dtype)
    if frames.dtype not in FRAME_KINDS or dtype not in ACT_KINDS:
        raise TypeError(f"KP takes u8 or f32 frames to f32 or bf16 patches, got {frames.dtype} "
                        f"-> {dtype}")
    b, h, w, c = frames.shape
    if h % patch or w % patch:
        raise ValueError(f"patches of {patch} do not tile {h}x{w} frames")
    frames = frames.contiguous()
    out = torch.empty((b, (h // patch) * (w // patch), patch * patch * c), dtype=dtype,
                      device=frames.device)
    kernels.launch(
        "frame_patches", kernels.ptr(frames), kernels.ptr(out), b, h, w, c, patch,
        FRAME_KINDS[frames.dtype], ACT_KINDS[dtype], kernels.stream_handle(frames.device),
    )
    return out


# -- kernel KV: the patch projection's epilogue -------------------------------------

def vit_embed_plain(prod: torch.Tensor, b, cls, pos) -> torch.Tensor:
    """Plain version of KV: the patch projection's product prod [B, N, D]
    (compute dtype) -> x [B, N+1, D]: ``+ b`` (cast to the compute dtype),
    [CLS] prepended, ``+ pos`` (cast), each add rounded."""
    dtype = prod.dtype
    x = prod + b.to(dtype)
    cls = cls.to(dtype).expand(prod.shape[0], 1, prod.shape[-1])
    return torch.cat([cls, x], dim=1) + pos.to(dtype)[None]


def vit_embed(prod: torch.Tensor, b, cls, pos) -> torch.Tensor:
    """Kernel KV (``csrc/vit_embed.cu``): outputs as ``vit_embed_plain``."""
    if not prod.is_cuda:
        return vit_embed_plain(prod, b, cls, pos)
    n_b, n, d = prod.shape
    if prod.dtype not in ACT_KINDS:
        raise TypeError(f"KV takes float32 or bfloat16 products, got {prod.dtype}")
    for name, t, shape in (("b", b, (d,)), ("cls", cls, (1, 1, d)), ("pos", pos, (n + 1, d))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"KV: {name} must be f32{list(shape)}, got {t.dtype}{list(t.shape)}")
    prod, b, cls, pos = (t.contiguous() for t in (prod, b, cls, pos))
    out = torch.empty((n_b, n + 1, d), dtype=prod.dtype, device=prod.device)
    p = kernels.ptr
    kernels.launch("vit_embed", p(prod), p(b), p(cls), p(pos), p(out), n_b, n, d,
                   ACT_KINDS[prod.dtype], kernels.stream_handle(prod.device))
    return out


# -- kernel KT: ln_f on [CLS], head, softmax, top-k ------------------------------------

def softmax_plain(logits: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last dim: ``exp(l - max) / sum``."""
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def softmax_topk_plain(logits: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``softmax_plain``, then its ``k`` largest with the lower index first
    on ties (as ``jax.lax.top_k``): a stable descending sort, not
    ``torch.topk``, whose tie order is not defined. -> (probs [B, k], ids
    int32 [B, k])."""
    p, ids = torch.sort(softmax_plain(logits), dim=-1, descending=True, stable=True)
    return p[:, :k].contiguous(), ids[:, :k].to(torch.int32).contiguous()


def vit_head_plain(x: torch.Tensor, ln_f: Params, head: Params, k: int):
    """Plain version of KT over the final residual stream x [B, T, D]:
    ln_f of the [CLS] row (f32 statistics, out in the compute dtype; per
    row what the reference's ln_f over all rows gives), the head (``dense``
    in the compute dtype), widened to f32 -> (logits f32[B, classes],
    probs f32[B, k], ids int32[B, k]); with ``k`` 0 the last two are
    None."""
    _check_top_k(k, head["w"].shape[-1])
    feats = layernorm(ln_f, x[:, 0])
    logits = dense(head, feats, x.dtype).to(wide(x.dtype))
    if k == 0:
        return logits, None, None
    return (logits, *softmax_topk_plain(logits, k))


KT_ARGMAX_K = 64  # KT's top-k by argmax rounds up to this k, by a sort past it
HEAD_WEIGHT_FORMATS = {torch.float32: "f32", torch.bfloat16: "bf16"}  # the head weights KT reads


def _check_top_k(k: int, c: int) -> None:
    """Any 0 <= k <= C, as ``jax.lax.top_k`` takes (it raises past the
    class count)."""
    if not 0 <= k <= c:
        raise ValueError(f"top-k takes 0 <= k <= {c} classes, got {k}")


def kt_sort_keys(d: int, c: int) -> Tuple[int, bool]:
    """KT's sort path (top-k past ``KT_ARGMAX_K``) at width ``d`` and
    ``c`` classes: (its keys a frame, the power of two at or past C;
    whether they fit shared memory beside the frame's D + C floats: when
    not, the wrapper hands the kernel a scratch row of keys a frame). As
    ``csrc/vit_head.cu`` ``sort_keys``."""
    np_ = 1
    while np_ < c:
        np_ <<= 1
    base = -(-(d + c) * 4 // 8) * 8
    return np_, base + 8 * np_ <= 227 * 1024


def _head_args(x: torch.Tensor, ln_f: Params, head: Params):
    """KT's inputs checked: x [B, T, D] in f32 or bf16, f32 ln_f params
    and head bias, the head weight f32 or bf16 (a tree from
    ``quantize_params(params, "bf16")``) -> (x, [scale, bias, w, b], B, T,
    D, C), each contiguous."""
    n_b, t, d = x.shape
    c = head["w"].shape[-1]
    if x.dtype not in ACT_KINDS:
        raise TypeError(f"KT takes float32 or bfloat16 activations, got {x.dtype}")
    weights = [ln_f["scale"], ln_f["bias"], head["w"], head["b"]]
    for i, (w, shape) in enumerate(zip(weights, ((d,), (d,), (d, c), (c,)))):
        ok = w.dtype in HEAD_WEIGHT_FORMATS if i == 2 else w.dtype == torch.float32
        if not ok or tuple(w.shape) != shape:
            raise ValueError(f"KT: head params must be f32{list(shape)} (the weight f32 or "
                             f"bf16), got {w.dtype}{list(w.shape)}")
    return x.contiguous(), [w.contiguous() for w in weights], n_b, t, d, c


def vit_head(x: torch.Tensor, ln_f: Params, head: Params, k: int):
    """Kernel KT (``csrc/vit_head.cu``): one pass a frame for ln_f on the
    [CLS] row, the head product in the kernel's own body (f32
    accumulation, the weight read as stored: f32 or bf16), the f32 softmax
    and the top-k at any 0 <= k <= C (argmax rounds up to
    ``KT_ARGMAX_K``, one bitonic sort past it); outputs as
    ``vit_head_plain``."""
    if not x.is_cuda:
        return vit_head_plain(x, ln_f, head, k)
    x, weights, n_b, t, d, c = _head_args(x, ln_f, head)
    _check_top_k(k, c)
    dev = x.device
    logits = torch.empty((n_b, c), dtype=torch.float32, device=dev)
    probs = torch.empty((n_b, k), dtype=torch.float32, device=dev) if k else None
    ids = torch.empty((n_b, k), dtype=torch.int32, device=dev) if k else None
    scratch = None
    if k > KT_ARGMAX_K:
        n_keys, fits = kt_sort_keys(d, c)
        if not fits:
            scratch = torch.empty((n_b, n_keys), dtype=torch.int64, device=dev)
    sw, sb, w, b = weights
    fmt = HEAD_WEIGHT_FORMATS[w.dtype]
    p = kernels.ptr
    kernels.launch("vit_head", p(x), p(sw), p(sb), p(w), WEIGHT_FORMATS[fmt], p(b), p(logits),
                   p(probs), p(ids), p(scratch), n_b, t, d, c, k, ACT_KINDS[x.dtype],
                   kernels.stream_handle(dev),
                   variant=f"{'sort' if k > KT_ARGMAX_K else 'argmax'},{fmt}")
    return logits, probs, ids


# -- the compositions ----------------------------------------------------------------

class _Ops(NamedTuple):
    """The device functions a composition calls: the kernels' wrappers
    (which take the plain version on CPU tensors) or, for the plain twin on
    the card, the plain versions themselves. ``layernorm``, ``attention``
    and ``bias_gelu`` are the blocks' (``models.common.blocks_stacked``)."""
    frame_patches: Callable
    dct_patches: Callable
    embed: Callable
    layernorm: Callable
    attention: Callable
    bias_gelu: Callable
    head: Callable
    weight: Callable = kernel_weight  # the blocks' projections (f32 masters or bf16)


KERNEL_OPS = _Ops(frame_patches, dct_patches, vit_embed, layernorm_rows, attention, bias_gelu,
                  vit_head)
PLAIN_OPS = _Ops(frame_patches_plain, dct_patches_plain, vit_embed_plain, layernorm_rows_plain,
                 attention_plain, bias_gelu_plain, vit_head_plain)


def _encode(params: Params, cfg, patches: torch.Tensor, top_k: int, ops: _Ops):
    """patches [B, N, patch_dim] in the compute dtype -> (logits, probs,
    ids): the patch projection, KV, the blocks over one slot, KT."""
    dtype = cfg.compute_dtype
    prod = torch.matmul(patches, kernel_weight(params["patch"], dtype))
    x = ops.embed(prod, params["patch"]["b"], params["cls"], params["pos"])
    one = tree_map(lambda a: a[None], params["blocks"])  # views: one slot
    h = blocks_stacked(one, x[None], cfg.heads, False, dtype, ops)[0]
    return ops.head(h, params["ln_f"], params["head"], top_k)


def _classify(params, cfg, frames, top_k: int, ops: _Ops):
    return _encode(params, cfg, ops.frame_patches(frames, cfg.patch_size, cfg.compute_dtype),
                   top_k, ops)


def _classify_dct(params, cfg, y_z, cb_z, cr_z, layout: FrameLayout, top_k: int, ops: _Ops):
    if (layout.width, layout.height) != (cfg.image_size, cfg.image_size) or cfg.channels != 3:
        raise ValueError(f"layout {layout} does not decode to the classifier's "
                         f"{cfg.image_size}x{cfg.image_size} RGB frames")
    patches = ops.dct_patches(y_z, cb_z, cr_z, layout, cfg.patch_size, cfg.compute_dtype)
    return _encode(params, cfg, patches, top_k, ops)


# why an int8 tree (quantize_params(params, "int8")) does not classify
INT8_TREE = ("the reference's dense (sitewhere_tpu/models/common.py:31-34) reads each dense "
             "layer's w, and an int8 tree holds qw and scale instead, so no ViT path of the "
             "reference runs it; a bf16 tree serves")
# why the train form takes f32 master weights only
TRAIN_MASTERS = ("it differentiates them, as the reference's train_step does (vit.py:127); "
                 "a bf16 tree serves only")


def _check(params, cfg, t: torch.Tensor) -> None:
    """The serving paths read f32 master and bf16-stored trees (KT reads
    the head weight as stored; the blocks' projections and the patch
    projection through ``kernel_weight``); an int8 tree raises on any
    device (``INT8_TREE``)."""
    if has_int8(params):
        raise NotImplementedError(f"the ViT takes f32 or bf16 trees: {INT8_TREE}")
    if t.is_cuda:
        check_kernel_params(params, cfg, "the ViT's kernel path")


# -- entry points ------------------------------------------------------------------

def apply(params: Params, cfg: ViTConfig, images: torch.Tensor) -> torch.Tensor:
    """images f32[B, H, W, C] (pre-normalized) -> logits f32[B, classes].
    CPU tensors take the plain versions; CUDA tensors launch KP, KV, the
    blocks' KL/KA/KU and KT."""
    _check(params, cfg, images)
    return _classify(params, cfg, images, 0, KERNEL_OPS)[0]


def apply_dct(params: Params, cfg: ViTConfig, y_z, cb_z, cr_z, layout: FrameLayout):
    """Compressed-wire forward: truncated zigzag DCT coefficients (int16
    ``[B, y_blocks, k]``, ``[B, c_blocks, k]`` twice) -> logits f32[B,
    classes], the decode fused into the patches (KJ)."""
    _check(params, cfg, y_z)
    return _classify_dct(params, cfg, y_z, cb_z, cr_z, layout, 0, KERNEL_OPS)[0]


def classify(params: Params, cfg: ViTConfig, frames: torch.Tensor, top_k: int):
    """u8 frames (normalized on the device) or pre-normalized f32 frames
    [B, H, W, C] -> (logits f32[B, classes], probs f32[B, k], ids
    int32[B, k]) of the softmax's top ``top_k``."""
    _check(params, cfg, frames)
    return _classify(params, cfg, frames, top_k, KERNEL_OPS)


def classify_dct(params: Params, cfg: ViTConfig, y_z, cb_z, cr_z, layout: FrameLayout,
                 top_k: int):
    """``classify`` from the compressed wire's coefficients (KJ)."""
    _check(params, cfg, y_z)
    return _classify_dct(params, cfg, y_z, cb_z, cr_z, layout, top_k, KERNEL_OPS)


def classify_plain(params: Params, cfg, frames: torch.Tensor, top_k: int):
    """Plain version of ``classify``."""
    return _classify(params, cfg, frames, top_k, PLAIN_OPS)


def classify_dct_plain(params: Params, cfg, y_z, cb_z, cr_z, layout: FrameLayout,
                       top_k: int):
    """Plain version of ``classify_dct``."""
    return _classify_dct(params, cfg, y_z, cb_z, cr_z, layout, top_k, PLAIN_OPS)


# -- tensor-parallel inference (the reference's vit.py:137 shard_params_tp,
# :156 apply_tp) ------------------------------------------------------------------

def shard_params_tp(params: Params, n: int):
    """Pre-slice the blocks for n tensor-parallel ranks -> (blocks_stacked,
    rest): ``blocks_stacked`` the blocks with each rank's slice
    (``shard_block_params_tp``) stacked on a leading rank dim, ``rest`` the
    leaves every rank holds whole (patch, cls, pos, ln_f, head)."""
    per_rank = [[shard_block_params_tp(b, n, i) for b in params["blocks"]] for i in range(n)]
    blocks_stacked = tree_map(lambda *xs: torch.stack(xs), *per_rank)
    return blocks_stacked, {k: params[k] for k in ("patch", "cls", "pos", "ln_f", "head")}


def apply_tp(blocks_stacked, rest: Params, cfg: ViTConfig, images: torch.Tensor,
             axis) -> torch.Tensor:
    """Tensor-parallel forward over ``axis`` (``parallel/dist.py``): each
    rank holds 1/n of every block's heads and MLP hidden (a column/row
    split, two psums a block); the activations and ``rest`` are whole on
    every rank. images f32[B, H, W, C] (pre-normalized) -> logits
    f32[B, classes] on every rank: ``apply``'s kernels (KP, KV, the blocks'
    KL, KA at the local heads, KU, KT) on CUDA tensors, their plain
    versions on CPU tensors."""
    n_ranks = tree_leaves(blocks_stacked)[0].shape[0]
    if n_ranks != axis.size:
        # a mismatch would silently drop ranks: each psum would cover a
        # fraction of the heads and the MLP hidden
        raise ValueError(f"params sliced for {n_ranks} TP ranks but the axis has "
                         f"{axis.size} ranks")
    _check(rest, cfg, images)
    ops, dtype = KERNEL_OPS, cfg.compute_dtype
    prod = torch.matmul(ops.frame_patches(images, cfg.patch_size, dtype),
                        kernel_weight(rest["patch"], dtype))
    x = ops.embed(prod, rest["patch"]["b"], rest["cls"], rest["pos"])
    for blk in tree_map(lambda a: a[axis.rank], blocks_stacked):  # the rank's slices
        x = transformer_block_tp(blk, x, cfg.heads, axis, ops, False, dtype)
    return ops.head(x, rest["ln_f"], rest["head"], 0)[0]


# -- the train form: KT's train mode, KV's backward, the blocks' backward kernels ----

def _label_index(labels: torch.Tensor, c: int):
    """``jnp.take_along_axis``'s index: a label in [-C, 0) wraps to C +
    label -> (the index, clamped into range, and whether it was in range:
    past it the reference's gather reads NaN and its scatter drops the
    cotangent)."""
    idx = torch.where(labels < 0, labels + c, labels).long()
    hit = (idx >= 0) & (idx < c)
    return idx.clamp(0, c - 1), hit


def _log_softmax_parts(logits: torch.Tensor):
    """``jax.nn.log_softmax``'s forward parts: (the shifted logits j = l -
    max, e = exp(j), s = the row sum of e)."""
    j = logits - logits.amax(-1, keepdim=True)
    e = torch.exp(j)
    return j, e, e.sum(-1, keepdim=True)


def vit_head_train_plain(x: torch.Tensor, ln_f: Params, head: Params, labels: torch.Tensor):
    """Plain version of KT's train mode (forward): from the final residual
    stream x [B, T, D], ln_f on the [CLS] rows and the head (as
    ``vit_head_plain``), then ``log_softmax`` and the mean NLL at the
    labels -> (loss f32[], logits f32[B, C] the backward reads). A label in
    [-C, 0) wraps; past the classes the loss is NaN, as the reference's."""
    logits = vit_head_plain(x, ln_f, head, 0)[0]
    b, c = logits.shape
    j, _, s = _log_softmax_parts(logits)
    idx, hit = _label_index(labels, c)
    lp = torch.gather(j - torch.log(s), 1, idx[:, None])[:, 0]
    lp = torch.where(hit, lp, torch.nan)
    return -(lp.sum() / b), logits


def dlogits_plain(logits: torch.Tensor, labels: torch.Tensor, g: torch.Tensor, dtype):
    """The loss's cotangent at the f32 logits, in the order of the
    reference's grad jaxpr: v = (-g) / B scattered at each label (dropped
    past the classes) gives y; ``log_softmax``'s vjp y + e * (sum(-y) / s);
    rounded once to the compute dtype."""
    b, c = logits.shape
    _, e, s = _log_softmax_parts(logits)
    idx, hit = _label_index(labels, c)
    v = (-g.to(logits.dtype)) / b
    y = torch.zeros_like(logits).scatter_(1, idx[:, None], torch.where(hit, v, 0.0)[:, None])
    return (y + e * ((-y).sum(-1, keepdim=True) / s)).to(dtype)


def vit_head_train_bwd_plain(x, ln_f: Params, head: Params, labels, logits, g,
                             dlogits=dlogits_plain):
    """Plain version of KT's train mode (backward), from the seed g (the
    loss's cotangent, f32[]) -> (dh [B, T, D] in x's dtype: ln_f's backward
    on the [CLS] rows, 0 elsewhere; d head.w f32[D, C]; d head.b f32[C]; d
    ln_f.scale, d ln_f.bias f32[D]). d feats = dlogits . w^T rounded; the
    head's gradients summed in f32 and rounded to the compute dtype once;
    ln_f's as ``layernorm_bwd_plain`` over the [CLS] rows."""
    dt, wd = x.dtype, wide(x.dtype)
    b = x.shape[0]
    dl = dlogits(logits, labels, g, dt)
    cls = x[:, 0].contiguous()
    feats = layernorm(ln_f, cls)
    dfeats = torch.matmul(dl, kernel_weight(head, dt).transpose(0, 1))
    dw = torch.matmul(feats.to(wd).transpose(0, 1), dl.to(wd)).to(dt).to(wd)
    db = dl.to(wd).sum(0).to(dt).to(wd)
    dcls, dscale, dbias = layernorm_bwd_plain(cls, ln_f["scale"][None], dfeats, b)
    dh = torch.zeros_like(x)
    dh[:, 0] = dcls
    return dh, dw, db, dscale[0], dbias[0]


def _head_train_args(x, ln_f, head, labels):
    x, weights, n_b, t, d, c = _head_args(x, ln_f, head)
    if tuple(labels.shape) != (n_b,) or labels.device != x.device:
        raise ValueError(f"KT's train mode takes labels [{n_b}] on {x.device}, got "
                         f"{tuple(labels.shape)} on {labels.device}")
    return x, weights, labels.to(torch.int32).contiguous(), n_b, t, d, c


def _launch_head_train(mode, x, weights, labels, n_b, t, d, c, *, logits, lp=None, loss=None,
                       g=None, dh=None, feats=None, dlog=None, part=None, red=None, dhw=None,
                       dhb=None) -> None:
    p = kernels.ptr
    kernels.launch(
        "vit_head_train", mode, p(x), *(p(w) for w in weights), p(labels), p(logits), p(lp),
        p(loss), p(g), p(dh), p(feats), p(dlog), p(part), p(red), p(dhw), p(dhb), n_b, t, d, c,
        ACT_KINDS[x.dtype], kernels.stream_handle(x.device), variant=("fwd", "bwd")[mode],
    )


def vit_head_train(x: torch.Tensor, ln_f: Params, head: Params, labels: torch.Tensor):
    """Kernel KT in its train mode, forward (``csrc/vit_head.cu``
    ``sw_vit_head_train``): outputs as ``vit_head_train_plain``; the frames'
    NLLs summed in order."""
    if not x.is_cuda:
        return vit_head_train_plain(x, ln_f, head, labels)
    x, weights, labels, n_b, t, d, c = _head_train_args(x, ln_f, head, labels)
    dev = x.device
    logits = torch.empty((n_b, c), dtype=torch.float32, device=dev)
    lp = torch.empty((n_b,), dtype=torch.float32, device=dev)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    _launch_head_train(0, x, weights, labels, n_b, t, d, c, logits=logits, lp=lp, loss=loss)
    return loss, logits


def vit_head_train_bwd(x, ln_f: Params, head: Params, labels, logits, g):
    """Kernel KT in its train mode, backward: outputs as
    ``vit_head_train_bwd_plain`` (ln_f's backward fused); every gradient's
    sums deterministic."""
    if not x.is_cuda:
        return vit_head_train_bwd_plain(x, ln_f, head, labels, logits, g)
    x, weights, labels, n_b, t, d, c = _head_train_args(x, ln_f, head, labels)
    if logits.dtype != torch.float32 or tuple(logits.shape) != (n_b, c):
        raise ValueError(f"KT's train backward takes the forward's logits f32[{n_b}, {c}]")
    dev = x.device

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    dh, red, dhw, dhb = torch.empty_like(x), f32(2 * d), f32(d, c), f32(c)
    _launch_head_train(1, x, weights, labels, n_b, t, d, c, logits=logits.contiguous(),
                       g=g.to(torch.float32).reshape(1).contiguous(), dh=dh, feats=f32(n_b, d),
                       dlog=f32(n_b, c), part=f32(n_b, 2 * d), red=red, dhw=dhw, dhb=dhb)
    return dh, dhw, dhb, red[:d], red[d:]


def vit_embed_bwd_plain(dx: torch.Tensor):
    """Plain version of KV's backward: the tokens' cotangent dx [B, N+1, D]
    in the compute dtype -> (d pos f32[N+1, D], d cls f32[1, 1, D], d
    patch.b f32[D]): the frame sums, [CLS]'s row of them, and the sum over
    frames and rows 1..N, each summed in f32 and rounded to the compute
    dtype once. The product's cotangent is ``dx[:, 1:]``."""
    dt, wd = dx.dtype, wide(dx.dtype)
    pos = dx.to(wd).sum(0)
    return (pos.to(dt).to(wd), pos[0].to(dt).to(wd)[None, None],
            pos[1:].sum(0).to(dt).to(wd))


def vit_embed_bwd(dx: torch.Tensor):
    """Kernel KV's backward (``csrc/vit_embed_bwd.cu``): outputs as
    ``vit_embed_bwd_plain``; the sums deterministic."""
    if not dx.is_cuda:
        return vit_embed_bwd_plain(dx)
    if dx.dtype not in ACT_KINDS:
        raise TypeError(f"KV's backward takes float32 or bfloat16 tokens, got {dx.dtype}")
    dx = dx.contiguous()
    n_b, t, d = dx.shape
    dev = dx.device
    red = torch.empty((t, d), dtype=torch.float32, device=dev)
    dpos = torch.empty((t, d), dtype=torch.float32, device=dev)
    dcls = torch.empty((1, 1, d), dtype=torch.float32, device=dev)
    db = torch.empty((d,), dtype=torch.float32, device=dev)
    p = kernels.ptr
    kernels.launch("vit_embed_bwd", p(dx), p(red), p(dpos), p(dcls), p(db), n_b, t - 1, d,
                   ACT_KINDS[dx.dtype], kernels.stream_handle(dev))
    return dpos, dcls, db


class _TrainOps(NamedTuple):
    """The device functions of the train form: KP, KV and its backward, KT's
    train mode (forward, backward) and the blocks'
    (``models.common.BlockTrainOps``); the kernels' wrappers or the plain
    versions (the plain twin)."""
    frame_patches: Callable
    embed: Callable
    embed_bwd: Callable
    head: Callable
    head_bwd: Callable
    blocks: BlockTrainOps


TRAIN_KERNEL_OPS = _TrainOps(frame_patches, vit_embed, vit_embed_bwd, vit_head_train,
                             vit_head_train_bwd, BLOCK_TRAIN_KERNELS)
TRAIN_PLAIN_OPS = _TrainOps(frame_patches_plain, vit_embed_plain, vit_embed_bwd_plain,
                            vit_head_train_plain, vit_head_train_bwd_plain, BLOCK_TRAIN_PLAIN)


class ViTTrainLoss(torch.autograd.Function):
    """The loss under autograd: ``apply(cfg, ops, params, images, labels,
    *tree_leaves(params))`` -> the mean NLL f32[]. The forward runs KP on
    the f32 frames, the patch projection, KV, the blocks over one slot
    keeping what their backward reads, and KT's train mode; the backward,
    from the loss's cotangent, runs KT's train backward, the blocks in
    reverse, KV's backward and d patch.w's GEMM, and returns every leaf's
    gradient."""

    @staticmethod
    def forward(ctx, cfg, ops: _TrainOps, params, images, labels, *leaves):
        dtype = cfg.compute_dtype
        patches = ops.frame_patches(images, cfg.patch_size, dtype)
        prod = torch.matmul(patches, kernel_weight(params["patch"], dtype))
        x = ops.embed(prod, params["patch"]["b"], params["cls"], params["pos"])
        one = tree_map(lambda a: a[None], params["blocks"])  # views: one slot
        h, saved = blocks_train_forward(one, x[None], cfg.heads, False, dtype, ops.blocks)
        value, logits = ops.head(h[0], params["ln_f"], params["head"], labels)
        ctx.cfg, ctx.ops, ctx.params, ctx.one, ctx.labels = cfg, ops, params, one, labels
        ctx.patches, ctx.saved, ctx.h, ctx.logits = patches, saved, h, logits
        return value

    @staticmethod
    def backward(ctx, g):
        cfg, ops, params = ctx.cfg, ctx.ops, ctx.params
        dtype = cfg.compute_dtype
        dh, dhw, dhb, dsf, dbf = ops.head_bwd(ctx.h[0], params["ln_f"], params["head"],
                                              ctx.labels, ctx.logits, g)
        dx, block_grads = blocks_train_backward(ctx.one, ctx.saved, dh[None], cfg.heads, False,
                                                dtype, ops.blocks)
        dx = dx[0]
        dpos, dcls, dpb = ops.embed_bwd(dx)
        patches = ctx.patches.reshape(-1, ctx.patches.shape[-1])
        dpw = torch.matmul(patches.transpose(0, 1), dx[:, 1:].reshape(-1, dx.shape[-1]))
        grads = {
            "patch": {"w": dpw.to(wide(dtype)), "b": dpb}, "cls": dcls, "pos": dpos,
            "blocks": tree_map(lambda a: a[0], block_grads),
            "ln_f": {"scale": dsf, "bias": dbf}, "head": {"w": dhw, "b": dhb},
        }
        ctx.params = ctx.one = ctx.saved = ctx.h = ctx.logits = ctx.patches = None
        return (None,) * 5 + tuple(leaves_like(params, grads))


def _train_loss(params: Params, cfg, images, labels, ops: _TrainOps) -> torch.Tensor:
    return ViTTrainLoss.apply(cfg, ops, params, images, labels, *tree_leaves(params))


def loss_plain(params: Params, cfg, images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Plain version of ``loss``: the train form over the plain versions
    (differentiable in ``params``; the card's plain twin)."""
    return _train_loss(params, cfg, images, labels, TRAIN_PLAIN_OPS)


def loss(params: Params, cfg: ViTConfig, images: torch.Tensor, labels: torch.Tensor):
    """Mean cross-entropy of the frames' labels (``vit.py:121``): images
    f32[B, H, W, C] (pre-normalized), labels int[B] -> f32[], differentiable
    in ``params``. CPU tensors take the plain versions; CUDA tensors launch
    KP, KV, the blocks' KL, KA, KU, KT's train mode and, under backward,
    their backward kernels. Reads f32 master weights only
    (``TRAIN_MASTERS``)."""
    _check(params, cfg, images)
    if images.is_cuda:
        check_kernel_params(params, cfg, "the ViT's train form", masters_only=TRAIN_MASTERS)
    return _train_loss(params, cfg, images, labels, TRAIN_KERNEL_OPS)


def train_step(params: Params, opt_state, batch, cfg: ViTConfig, optimizer):
    """One optimizer step on ``loss`` (``vit.py:127``): batch = (images,
    labels) -> (params, opt_state, loss). ``optimizer`` has optax's
    ``update(grads, state, params)`` surface; the port's Adam
    (``ops.adam.adam(lr)``, ``scale_by_adam()``) runs as one KO call on CUDA
    tensors, updating params and state in place (``ops.adam.apply_step``)."""
    images, labels = batch
    value, grads = value_and_grad(lambda p: loss(p, cfg, images, labels), params)
    params, opt_state = optim.apply_step(optimizer, params, grads, opt_state)
    return params, opt_state, value


def train_bytes(cfg: ViTConfig, batch: int) -> int:
    """Device bytes the kernel train form holds between its forward and
    backward for ``batch`` frames, with one block's backward in flight: 16
    D values a token a block saved in the compute dtype (as the
    transformer's ``train_bytes_per_row``), ~14 D a token of cotangents in
    flight, the patches in the compute dtype and the f32 logits."""
    t = cfg.num_patches + 1
    size = torch.tensor([], dtype=cfg.compute_dtype).element_size()
    patch_dim = cfg.patch_size * cfg.patch_size * cfg.channels
    return batch * (t * cfg.dim * size * (16 * cfg.depth + 14)
                    + cfg.num_patches * patch_dim * size + 4 * cfg.num_classes)
