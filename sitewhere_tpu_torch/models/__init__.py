"""Model registry of the port (``sitewhere_tpu/models/__init__.py``).

Scorer models share one contract:

    cfg    = make_config(name, overrides)
    params = spec.init(generator, cfg, device=...)
    scores = spec.score_stacked(stacked_params, cfg, windows[S, B, W],
                                n_valid[S, B], k=K)          # f32[S, B, K]

The registry holds ``lstm_ad`` only; the other families of the JAX package
are still to be ported (ROADMAP queue 1, slice C and D).
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Any, Callable, Dict, Optional, Tuple

from sitewhere_tpu_torch.models import lstm_ad
from sitewhere_tpu_torch.models.common import (
    DEFAULT_SCORE_RANGE,
    lstm_ad_flops_per_row,
)

__all__ = ["ModelSpec", "MODEL_REGISTRY", "get_model", "make_config", "lstm_ad"]


@dataclass(frozen=True)
class ModelSpec:
    name: str
    config_cls: type
    init: Callable
    score: Optional[Callable] = None          # legacy per-tenant scorer
    # fused megabatch contract: (stacked_params, cfg, windows[S,B,W],
    # n_valid[S,B], k=K) -> f32[S,B,K]
    score_stacked: Optional[Callable] = None
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
        flops_per_row=lstm_ad_flops_per_row,
    ),
}


def get_model(name: str) -> ModelSpec:
    try:
        return MODEL_REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown model '{name}' (the port has {sorted(MODEL_REGISTRY)}; "
            "the other families of sitewhere_tpu are still to be ported, "
            "see ROADMAP.md queue 1)"
        ) from None


def make_config(name: str, overrides: Optional[Dict[str, Any]] = None):
    """Build a model config from a template's ``model_config`` dict,
    ignoring unknown keys (forward-compatible tenant templates)."""
    spec = get_model(name)
    known = {f.name for f in fields(spec.config_cls)}
    kwargs = {k: v for k, v in (overrides or {}).items() if k in known}
    return spec.config_cls(**kwargs)
