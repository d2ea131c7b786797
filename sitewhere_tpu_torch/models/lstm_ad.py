"""LSTM anomaly detector — the port of ``sitewhere_tpu/models/lstm_ad.py``.

An LSTM reads a normalized measurement window ``x[0..W-2]`` and predicts
each next value; the anomaly score is the absolute prediction error of the
newest sample in normalized units. Rows with fewer than 4 real samples
score 0 (cold start).

The serving path is ``score_stacked``: weight-stacked scoring of a tenant
plane ``[S, B, W]``, each slot with its own params. On CPU tensors it runs
the plain PyTorch version; on CUDA tensors it launches kernel KS
(``csrc/lstm_score.cu``) in its windows mode. The scoring flush calls KS
through ``lstm_score``, which gathers each row's window from the ring state
inside the kernel and applies the flush epilogue (column select, row mask,
wire cast). The legacy per-tenant ``score`` is the reference's single-slot
path; it runs on the CPU only.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from sitewhere_tpu_torch.models.common import (
    DTYPES,
    Params,
    clamp_fuse_k,
    dense_init,
    kernel_shape,
    kernel_weight,
    kstep_mask,
    normalize_windows,
    sigmoid,
)
from sitewhere_tpu_torch.models.flush import (
    launch_ring,
    launch_windows,
    scan_weights,
    score_flush_plain,
)
from sitewhere_tpu_torch.ops.windows import WindowState


@dataclass(frozen=True)
class LstmAdConfig:
    window: int = 32
    hidden: int = 64
    dtype: str = "bfloat16"

    @property
    def compute_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]


def init(gen: torch.Generator, cfg: LstmAdConfig, device="cuda") -> Params:
    h = cfg.hidden
    return {
        # input (1) + hidden -> 4 gates, fused
        "wx": dense_init(gen, 1, 4 * h, device=device),
        "wh": dense_init(gen, h, 4 * h, scale=1.0 / math.sqrt(h), device=device),
        "head": dense_init(gen, h, 1, device=device),
    }


# -- legacy single-tenant path (CPU) -----------------------------------------

def _lstm_scan(params: Params, xs: torch.Tensor, dtype) -> torch.Tensor:
    """xs: [B, T] normalized values -> hidden states at each step [T, B, H]."""
    if xs.is_cuda:
        raise NotImplementedError(
            "the legacy per-tenant scan runs on the CPU only; the card "
            "scores through score_stacked (kernel KS)"
        )
    b, t = xs.shape
    h_dim = params["wh"]["w"].shape[0]
    wx = params["wx"]["w"].to(dtype)
    wh = params["wh"]["w"].to(dtype)
    bias = params["wx"]["b"].to(dtype) + params["wh"]["b"].to(dtype)
    h = torch.zeros((b, h_dim), dtype=dtype)
    c = torch.zeros((b, h_dim), dtype=dtype)
    hs = []
    for step in range(t):
        x_t = xs[:, step].to(dtype)
        gates = x_t[:, None] @ wx + h @ wh + bias
        i, f, g, o = torch.split(gates, h_dim, dim=-1)
        c = sigmoid(f + 1.0) * c + sigmoid(i) * torch.tanh(g)
        h = sigmoid(o) * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs)


def predict_next(params: Params, cfg: LstmAdConfig, windows: torch.Tensor) -> torch.Tensor:
    """One-step-ahead predictions for steps 1..W-1 (normalized space):
    windows f32[B, W] -> preds f32[B, W-1]."""
    dtype = cfg.compute_dtype
    normed, _, _ = normalize_windows(windows)
    hs = _lstm_scan(params, normed[:, :-1], dtype)   # [W-1, B, H]
    w_head = params["head"]["w"].to(dtype)
    b_head = params["head"]["b"].to(dtype)
    preds = (hs @ w_head)[..., 0] + b_head
    return preds.T.to(torch.float32)


def score(
    params: Params, cfg: LstmAdConfig, windows: torch.Tensor, n_valid: torch.Tensor,
) -> torch.Tensor:
    """Anomaly score per row: |last-step prediction error| in sigma units;
    rows with fewer than 4 samples score 0."""
    normed, _, _ = normalize_windows(windows)
    preds = predict_next(params, cfg, windows)
    err = torch.abs(normed[:, -1] - preds[:, -1])
    return torch.where(n_valid >= 4, err, 0.0).to(torch.float32)


# -- weight-stacked scoring (plain versions) ----------------------------------

def _stacked_lstm_scan(params: Params, xs: torch.Tensor, dtype) -> torch.Tensor:
    """xs: [S, B, T] normalized values -> hidden states [T, S, B, H]; one
    batched matmul per step over the whole stacked plane."""
    s, b, t = xs.shape
    h_dim = kernel_shape(params["wh"])[-2]
    wx = kernel_weight(params["wx"], dtype)            # [S, 1, 4H]
    wh = kernel_weight(params["wh"], dtype)            # [S, H, 4H]
    bias = (params["wx"]["b"] + params["wh"]["b"]).to(dtype)  # [S, 4H]
    h = torch.zeros((s, b, h_dim), dtype=dtype, device=xs.device)
    c = torch.zeros_like(h)
    xs_c = xs.to(dtype)
    hs = []
    for step in range(t):
        gates = (
            xs_c[:, :, step, None] * wx[:, 0][:, None, :]
            + torch.bmm(h, wh)
            + bias[:, None, :]
        )
        i, f, g, o = torch.split(gates, h_dim, dim=-1)
        c = sigmoid(f + 1.0) * c + sigmoid(i) * torch.tanh(g)
        h = sigmoid(o) * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs)


def score_stacked_plain(
    params: Params, cfg: LstmAdConfig, windows: torch.Tensor,
    n_valid: torch.Tensor, k: int = 1,
) -> torch.Tensor:
    """Plain version of ``score_stacked``: f32[S, B, K], column j the
    score at window position W-K+j (j = K-1 is the newest sample)."""
    dtype = cfg.compute_dtype
    k = clamp_fuse_k(k, windows.shape[-1])
    normed, _, _ = normalize_windows(windows)          # f32[S, B, W]
    hs = _stacked_lstm_scan(params, normed[..., :-1], dtype)
    hk = hs[-k:]                                       # [K, S, B, H]
    w_head = kernel_weight(params["head"], dtype)      # [S, H, 1]
    b_head = params["head"]["b"].to(dtype)             # [S, 1]
    preds = (
        torch.einsum("ksbh,sho->ksbo", hk, w_head)[..., 0]
        + b_head[..., 0][None, :, None]
    ).to(torch.float32)                                # [K, S, B]
    targets = torch.movedim(normed[..., -k:], -1, 0)   # [K, S, B]
    scores = torch.movedim(torch.abs(targets - preds), 0, -1)
    return torch.where(kstep_mask(n_valid, k), scores, 0.0).to(torch.float32)


def lstm_score_plain(
    params: Params, cfg: LstmAdConfig, state: WindowState, ids, later, active,
    counts=None, mask=None, k: int = 1, out_dtype=torch.float32,
) -> torch.Tensor:
    """Plain version of KS's flush form: gather each row's window from the
    post-update rings, ``score_stacked``, take column
    ``clip(K-1-later, 0, K-1)``, zero inactive slots and invalid rows, and
    cast to the wire dtype. Returns [T, B]."""
    return score_flush_plain(
        score_stacked_plain, params, cfg, state, ids, later, active, counts,
        mask, k, out_dtype,
    )


# -- kernel KS -----------------------------------------------------------------

KS_LEAVES = (
    ("wx", "w"), ("wx", "b"), ("wh", "w"), ("wh", "b"), ("head", "w"), ("head", "b"),
)


def score_stacked(
    params: Params, cfg: LstmAdConfig, windows: torch.Tensor,
    n_valid: torch.Tensor, k: int = 1,
) -> torch.Tensor:
    """Fused scoring over a stacked tenant plane: windows f32[S, B, W],
    n_valid i32[S, B] -> f32[S, B, K]. CPU tensors take the plain version;
    CUDA tensors launch KS (windows mode)."""
    if not windows.is_cuda:
        return score_stacked_plain(params, cfg, windows, n_valid, k=k)
    weights = scan_weights(params, cfg, KS_LEAVES, "KS")
    return launch_windows("lstm_score", "KS", weights, cfg, windows, n_valid, k)


def lstm_score(
    params: Params, cfg: LstmAdConfig, state: WindowState, ids, later, active,
    counts=None, mask=None, k: int = 1, out_dtype=torch.float32,
) -> torch.Tensor:
    """Kernel KS in its flush form (K2 gather + K3 scan + K4a epilogue):
    scores [T, B] in ``out_dtype`` for rows ``ids`` [T, B] of the
    post-update rings ``state``. CPU tensors take ``lstm_score_plain``;
    CUDA tensors launch KS (ring mode)."""
    if not ids.is_cuda:
        return lstm_score_plain(
            params, cfg, state, ids, later, active, counts, mask, k, out_dtype
        )
    weights = scan_weights(params, cfg, KS_LEAVES, "KS")
    return launch_ring(
        "lstm_score", "KS", weights, cfg, state, ids, later, active, counts,
        mask, k, out_dtype,
    )
