"""Shared building blocks of the port's models (the serving-path subset of
``sitewhere_tpu/models/common.py``).

Params are plain nested dicts of tensors (``{"w", "b"}`` per dense layer),
so stacking per-tenant params along a leading slot dim is a tree op, and a
JAX param tree carries across as numpy (``params_from_numpy`` /
``params_to_numpy``) with the same keys. Params are float32; compute
defaults to bfloat16. Init takes an explicit ``torch.Generator`` (a CPU
one, so the same seed gives the same weights on every device).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch

Params = Dict[str, Any]

# config dtype names -> torch dtypes (LstmAdConfig.dtype)
DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def dense_init(
    gen: torch.Generator, in_dim: int, out_dim: int,
    scale: Optional[float] = None, device="cuda",
) -> Params:
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    w = torch.randn((in_dim, out_dim), generator=gen, dtype=torch.float32)
    return {
        "w": (w * scale).to(device),
        "b": torch.zeros((out_dim,), dtype=torch.float32, device=device),
    }


def normalize_windows(windows: torch.Tensor, eps: float = 1e-6):
    """Per-row standardization of [..., W] windows -> (normed, mu, sigma).

    Same math as the reference: population std (``correction=0``), and
    ``eps`` added to the std outside the square root."""
    wf = windows.to(torch.float32)
    mu = wf.mean(-1, keepdim=True)
    sigma = wf.std(-1, keepdim=True, correction=0) + eps
    return (wf - mu) / sigma, mu, sigma


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` as the reference's XLA lowers it: ``1 / (1 +
    exp(-x))`` as three ops, so a bf16 input rounds after the exp, the add
    and the division (``torch.sigmoid`` rounds once)."""
    return 1 / (1 + torch.exp(-x))


def tree_map(fn, tree):
    """Apply ``fn`` to every leaf of a nested dict/list param tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def params_from_numpy(tree, device) -> Params:
    """A param tree of numpy arrays (a JAX tree after ``np.asarray`` on
    each leaf; stacked ``[T, ...]`` or single) -> the port's tree of
    tensors on ``device``, same keys."""
    return tree_map(
        lambda a: torch.from_numpy(np.array(a, copy=True)).to(device), tree
    )


def params_to_numpy(tree) -> Dict[str, Any]:
    """The port's param tree -> numpy arrays with the same keys."""
    return tree_map(lambda t: t.detach().cpu().numpy().copy(), tree)


# -- weight storage variants of the fused path ----------------------------

PARAM_DTYPES = ("f32", "bf16", "int8")

# MAC width of quantized weight matmuls against the bf16 peak: an int8 MAC
# counts as half a bf16-equivalent FLOP pair (int8 runs at twice the bf16
# rate on the tensor cores, as on the reference's matrix unit).
QUANT_MAC_WIDTH = {"f32": 1.0, "bf16": 1.0, "int8": 0.5}


def quant_mac_width(param_dtype: Optional[str]) -> float:
    return QUANT_MAC_WIDTH.get(param_dtype or "f32", 1.0)


def quantize_dense(p: Params, param_dtype: str) -> Params:
    """One dense param dict -> its kernel-side representation: ``f32``
    unchanged, ``bf16`` weight cast once, ``int8`` symmetric per-output-
    channel scales over the contraction dim (axis -2; per slot for stacked
    ``[S, I, O]`` weights). Biases stay f32."""
    if param_dtype == "f32":
        return p
    if param_dtype == "bf16":
        return {"w": p["w"].to(torch.bfloat16), "b": p["b"]}
    if param_dtype != "int8":
        raise ValueError(f"param_dtype must be one of {PARAM_DTYPES}")
    w = p["w"]
    scale = w.abs().amax(dim=-2, keepdim=True) / 127.0
    scale = torch.clamp_min(scale, 1e-12)
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return {"qw": q, "scale": scale.to(torch.float32), "b": p["b"]}


def quantize_params(params: Params, param_dtype: str) -> Params:
    """Derive the kernel-side param tree: every dense ``{"w", "b"}`` node
    with a contraction dim (ndim >= 2) re-represents per
    ``quantize_dense``; everything else passes through."""
    if param_dtype == "f32":
        return params

    def walk(node):
        if isinstance(node, dict):
            w = node.get("w")
            if w is not None and "b" in node and getattr(w, "ndim", 0) >= 2:
                return quantize_dense(node, param_dtype)
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node

    return walk(params)


def kernel_shape(p: Params) -> tuple:
    """Shape of a dense node's kernel, whatever its storage form."""
    arr = p.get("qw")
    if arr is None:
        arr = p["w"]
    return tuple(arr.shape)


def kernel_weight(p: Params, dtype) -> torch.Tensor:
    """Read a (possibly quantized) dense kernel at compute dtype; for int8
    storage this is the dequant ``qw * scale`` at that dtype."""
    qw = p.get("qw")
    if qw is not None:
        return qw.to(dtype) * p["scale"].to(dtype)
    return p["w"].to(dtype)


def kstep_mask(n_valid: torch.Tensor, k: int) -> torch.Tensor:
    """Cold-start mask per K-step score column: position W-K+j had seen
    ``n_valid - (K-1-j)`` samples when it was the newest; below 4 it
    scores 0. Returns bool[..., K] for n_valid[...]."""
    ages = torch.arange(k, dtype=torch.int32, device=n_valid.device)
    return (n_valid[..., None] - (k - 1 - ages)) >= 4


def clamp_fuse_k(k: int, window: int) -> int:
    """K is bounded by the predictable positions: a length-W window has
    W-1 one-step-ahead predictions."""
    return max(1, min(int(k), int(window) - 1))


# -- score sketches ---------------------------------------------------------

SKETCH_NBINS = 64

# default score range (lo, hi) of the log-spaced sketch edges
DEFAULT_SCORE_RANGE = (1e-3, 1e2)


def sketch_edges(
    lo: float = DEFAULT_SCORE_RANGE[0],
    hi: float = DEFAULT_SCORE_RANGE[1],
    nbins: int = SKETCH_NBINS,
) -> np.ndarray:
    """The ``nbins - 1`` interior bin edges, log-spaced over (lo, hi):
    bin 0 is [0, lo), bin nbins-1 is [hi, inf) — np.histogram semantics
    (left-closed bins). float32 numpy."""
    return np.logspace(
        math.log10(lo), math.log10(hi), nbins - 1, dtype=np.float32
    )


# -- analytic FLOP accounting ----------------------------------------------

def dense_flops(in_dim: int, out_dim: int) -> float:
    """Matmul FLOPs for one row through a dense layer (2 per MAC)."""
    return 2.0 * in_dim * out_dim


def lstm_scan_flops(hidden: int, steps: int, in_dim: int = 1) -> float:
    """One row through an LSTM scan: fused 4-gate input + recurrent
    matmuls per step."""
    per_step = dense_flops(in_dim, 4 * hidden) + dense_flops(hidden, 4 * hidden)
    return per_step * steps


def gru_scan_flops(hidden: int, steps: int, in_dim: int = 1) -> float:
    """One row through a GRU scan: fused 3-gate input + recurrent
    matmuls per step."""
    per_step = dense_flops(in_dim, 3 * hidden) + dense_flops(hidden, 3 * hidden)
    return per_step * steps


def lstm_ad_flops_per_row(
    cfg, window: int, k: Optional[int] = None, param_dtype: str = "f32",
) -> float:
    """lstm_ad.score: LSTM over window-1 steps + head (per step on the
    legacy path; last K only on the fused path, with quantized weight
    matmuls at their MAC width)."""
    t = max(1, int(window) - 1)
    wq = quant_mac_width(param_dtype) if k is not None else 1.0
    head_steps = t if k is None else max(1, min(int(k), t))
    return (
        lstm_scan_flops(cfg.hidden, t)
        + dense_flops(cfg.hidden, 1) * head_steps
    ) * wq


def deepar_flops_per_row(
    cfg, window: int, k: Optional[int] = None, param_dtype: str = "f32",
) -> float:
    """deepar.score: GRU encode over window-1 steps + (mu, sigma) heads
    (per step on the legacy path; last K only on the fused path)."""
    t = max(1, int(window) - 1)
    wq = quant_mac_width(param_dtype) if k is not None else 1.0
    head_steps = t if k is None else max(1, min(int(k), t))
    return (
        gru_scan_flops(cfg.hidden, t)
        + 2 * dense_flops(cfg.hidden, 1) * head_steps
    ) * wq
