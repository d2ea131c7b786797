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
  row, the head, the f32 softmax and the top-k, lower index first on ties
  as ``jax.lax.top_k``).

Each path is one composition (``_classify``, ``_classify_dct`` over
``_encode``) of the kernels' wrappers, which take their plain versions on
CPU tensors and launch the kernels on CUDA tensors; ``classify_plain`` and
``classify_dct_plain`` run the same compositions over the plain versions
on any device (the card's plain twin; ``apply`` is ``classify``'s
logits). ``loss``/``train_step`` belong to the training slice,
``shard_params_tp``/``apply_tp`` to the multi-GPU slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

from sitewhere_tpu_torch import kernels
from sitewhere_tpu_torch.models.common import (
    ACT_KINDS,
    DTYPES,
    Params,
    attention,
    attention_plain,
    bias_gelu,
    bias_gelu_plain,
    blocks_stacked,
    check_kernel_params,
    dense,
    dense_init,
    kernel_weight,
    layernorm,
    layernorm_init,
    layernorm_rows,
    layernorm_rows_plain,
    transformer_block_init,
    tree_map,
    wide,
)
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
    feats = layernorm(ln_f, x[:, 0])
    logits = dense(head, feats, x.dtype).to(wide(x.dtype))
    if k == 0:
        return logits, None, None
    return (logits, *softmax_topk_plain(logits, k))


HEAD_MAX_K = 64  # the largest top-k KT takes


def vit_head(x: torch.Tensor, ln_f: Params, head: Params, k: int):
    """Kernel KT (``csrc/vit_head.cu``): one pass a frame for ln_f on the
    [CLS] row, the head product in the kernel's own body (f32
    accumulation), the f32 softmax and the top-k; outputs as
    ``vit_head_plain``."""
    if not x.is_cuda:
        return vit_head_plain(x, ln_f, head, k)
    n_b, t, d = x.shape
    c = head["w"].shape[-1]
    if x.dtype not in ACT_KINDS:
        raise TypeError(f"KT takes float32 or bfloat16 activations, got {x.dtype}")
    if not 0 <= k <= min(c, HEAD_MAX_K):
        raise ValueError(f"KT's top-k takes 0 <= k <= {min(c, HEAD_MAX_K)}, got {k}")
    weights = [ln_f["scale"], ln_f["bias"], head["w"], head["b"]]
    for w, shape in zip(weights, ((d,), (d,), (d, c), (c,))):
        if w.dtype != torch.float32 or tuple(w.shape) != shape:
            raise ValueError(f"KT: head params must be f32{list(shape)}, got "
                             f"{w.dtype}{list(w.shape)}")
    x = x.contiguous()
    weights = [w.contiguous() for w in weights]
    dev = x.device
    logits = torch.empty((n_b, c), dtype=torch.float32, device=dev)
    probs = torch.empty((n_b, k), dtype=torch.float32, device=dev) if k else None
    ids = torch.empty((n_b, k), dtype=torch.int32, device=dev) if k else None
    p = kernels.ptr
    kernels.launch("vit_head", p(x), *(p(w) for w in weights), p(logits), p(probs), p(ids),
                   n_b, t, d, c, k, ACT_KINDS[x.dtype], kernels.stream_handle(dev))
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


def _check(params, cfg, t: torch.Tensor) -> None:
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
