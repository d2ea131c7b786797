"""Model registry of the port (``sitewhere_tpu/models/__init__.py``).

Scorer models share one contract:

    cfg    = make_config(name, overrides)
    params = spec.init(generator, cfg, device=...)
    scores = spec.score_stacked(stacked_params, cfg, windows[S, B, W],
                                n_valid[S, B], k=K)          # f32[S, B, K]
    scores = spec.score_flush(stacked_params, cfg, state, ids, later,
                              active, counts, mask, k, out_dtype)  # [T, B]

``score_flush`` is the scoring flush's form (``models/flush.py``): on CUDA
tensors it launches the family's kernel, and ``score_flush_plain`` is its
plain twin. The recurrent families train (``models/train.py``):

    per_row = spec.loss_stacked(stacked_params, cfg, windows[S, B, W])  # f32[S, B]
    per_row = spec.loss_ring(stacked_params, cfg, state)    # every stream

differentiable in the params (KB, KR on CUDA tensors; the plain version
``loss_stacked_plain`` under autograd on CPU tensors), and so does the
transformer (``models/transformer.py``: KE's train mode, the blocks' KL,
KA, KU and their backward kernels, KN's train mode). The frame classifier
trains per batch: ``loss(params, cfg, images, labels)`` and ``train_step(
params, opt_state, (images, labels), cfg, optimizer)`` (``models/vit.py``:
KP, KV, the blocks' kernels, KT's train mode and the backward kernels). ``train_bytes_per_row`` (cfg, window) -> the
device bytes a row of the kernel's train form holds and
``plain_train_rows`` the rows the plain twin differentiates at once size
the scorer's slot chunks of a train step. The registry holds the scorers ``lstm_ad``, ``deepar`` (the
``forecasting`` tenant template) and ``transformer``, and the frame
classifier ``vit_b16`` (``apply(params, cfg, images)`` -> logits).
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Any, Callable, Dict, Optional, Tuple

from sitewhere_tpu_torch.models import deepar, lstm_ad, train, transformer, vit
from sitewhere_tpu_torch.models.common import (
    DEFAULT_SCORE_RANGE,
    deepar_flops_per_row,
    lstm_ad_flops_per_row,
    transformer_flops_per_row,
    vit_flops_per_image,
)

__all__ = [
    "ModelSpec", "MODEL_REGISTRY", "get_model", "make_config", "deepar", "lstm_ad",
    "transformer", "vit",
]


@dataclass(frozen=True)
class ModelSpec:
    name: str
    config_cls: type
    init: Callable
    # (params, cfg, images f32[B, H, W, C]) -> logits f32[B, classes]: the
    # frame classifier's forward
    apply: Optional[Callable] = None
    score: Optional[Callable] = None          # legacy per-tenant scorer
    # fused megabatch contract: (stacked_params, cfg, windows[S,B,W],
    # n_valid[S,B], k=K) -> f32[S,B,K]
    score_stacked: Optional[Callable] = None
    # flush form: (stacked_params, cfg, state, ids, later, active, counts,
    # mask, k, out_dtype) -> [T, B]; the kernel on CUDA tensors, and its
    # plain twin
    score_flush: Optional[Callable] = None
    score_flush_plain: Optional[Callable] = None
    # (params, cfg, windows[B, context], generator=None, eps=None) ->
    # (samples, means) in raw units. DeepAR samples num_samples paths a
    # series: samples f32[num_samples, B, horizon], eps f32[horizon,
    # num_samples * B]; the transformer samples one, as its reference does:
    # samples f32[B, horizon], eps f32[horizon, B]. means f32[B, horizon].
    forecast: Optional[Callable] = None
    # training: the legacy per-tenant loss (params, cfg, windows[B, W]) ->
    # scalar and train_step (params, opt_state, windows, cfg, optimizer) ->
    # (params, opt_state, loss) (the ViT's: (params, cfg, images, labels)
    # and a batch (images, labels) in place of windows); the stacked train form (stacked_params,
    # cfg, windows[S, B, W]) -> per-row loss f32[S, B] (the kernel on CUDA
    # tensors) and its plain version; loss_ring (stacked_params, cfg, state)
    # -> f32[S, streams], every stream's window gathered from the rings
    loss: Optional[Callable] = None
    train_step: Optional[Callable] = None
    loss_stacked: Optional[Callable] = None
    loss_stacked_plain: Optional[Callable] = None
    loss_ring: Optional[Callable] = None
    # (cfg, window) -> device bytes a row of the kernel's train form holds
    # between its forward and backward; the rows the plain twin's autograd
    # differentiates at once (its graph holds f32 temporaries too)
    train_bytes_per_row: Optional[Callable] = None
    plain_train_rows: int = 65536
    # analytic matmul FLOPs to score one row at a given window length
    flops_per_row: Optional[Callable] = None
    # (lo, hi) score range of the score sketch's log-spaced bin edges
    score_range: Tuple[float, float] = DEFAULT_SCORE_RANGE


MODEL_REGISTRY: Dict[str, ModelSpec] = {
    "lstm_ad": ModelSpec(
        name="lstm_ad",
        config_cls=lstm_ad.LstmAdConfig,
        init=lstm_ad.init,
        score=lstm_ad.score,
        score_stacked=lstm_ad.score_stacked,
        score_flush=lstm_ad.lstm_score,
        score_flush_plain=lstm_ad.lstm_score_plain,
        loss=lstm_ad.loss,
        train_step=lstm_ad.train_step,
        loss_stacked=lstm_ad.loss_stacked,
        loss_stacked_plain=lstm_ad.loss_stacked_plain,
        loss_ring=lstm_ad.loss_ring,
        train_bytes_per_row=lambda cfg, w: train.train_bytes_per_row(lstm_ad.KB, cfg, w),
        flops_per_row=lstm_ad_flops_per_row,
    ),
    "deepar": ModelSpec(
        name="deepar",
        config_cls=deepar.DeepArConfig,
        init=deepar.init,
        score=deepar.score,
        score_stacked=deepar.score_stacked,
        score_flush=deepar.gru_score,
        score_flush_plain=deepar.gru_score_plain,
        loss=deepar.loss,
        train_step=deepar.train_step,
        loss_stacked=deepar.loss_stacked,
        loss_stacked_plain=deepar.loss_stacked_plain,
        loss_ring=deepar.loss_ring,
        train_bytes_per_row=lambda cfg, w: train.train_bytes_per_row(deepar.KR, cfg, w),
        forecast=deepar.forecast,
        flops_per_row=deepar_flops_per_row,
    ),
    "transformer": ModelSpec(
        name="transformer",
        config_cls=transformer.TransformerForecasterConfig,
        init=transformer.init,
        score=transformer.score,
        score_stacked=transformer.score_stacked,
        score_flush=transformer.tf_score,
        score_flush_plain=transformer.tf_score_plain,
        loss=transformer.loss,
        train_step=transformer.train_step,
        loss_stacked=transformer.loss_stacked,
        loss_stacked_plain=transformer.loss_stacked_plain,
        loss_ring=transformer.loss_ring,
        train_bytes_per_row=transformer.train_bytes_per_row,
        # the plain twin's graph keeps f32 copies and the T x T softmax
        # rows a head beside the saves: 4 slots of 8,192 streams at once
        plain_train_rows=32768,
        forecast=transformer.forecast,
        flops_per_row=transformer_flops_per_row,
    ),
    "vit_b16": ModelSpec(
        name="vit_b16",
        config_cls=vit.ViTConfig,
        init=vit.init,
        apply=vit.apply,
        loss=vit.loss,
        train_step=vit.train_step,
        flops_per_row=vit_flops_per_image,
    ),
}


def get_model(name: str) -> ModelSpec:
    try:
        return MODEL_REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown model '{name}' (the port has {sorted(MODEL_REGISTRY)})") from None


def make_config(name: str, overrides: Optional[Dict[str, Any]] = None):
    """Build a model config from a template's ``model_config`` dict,
    ignoring unknown keys (forward-compatible tenant templates)."""
    spec = get_model(name)
    known = {f.name for f in fields(spec.config_cls)}
    kwargs = {k: v for k, v in (overrides or {}).items() if k in known}
    return spec.config_cls(**kwargs)
