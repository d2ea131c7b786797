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

from sitewhere_tpu_torch import kernels
from sitewhere_tpu_torch.models.common import (
    DTYPES,
    Params,
    clamp_fuse_k,
    dense_init,
    kernel_shape,
    kernel_weight,
    kstep_mask,
    normalize_windows,
)
from sitewhere_tpu_torch.ops.windows import (
    ID_KINDS,
    VAL_KINDS,
    WindowState,
    gather_windows,
    row_mask,
)

# the hidden width KS is built for (every configuration of the repo uses it)
KS_HIDDEN = 64
KS_MAX_WINDOW = 128


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
        c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
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
        c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
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
    t_slots = ids.shape[0]
    wins, ns = [], []
    for t in range(t_slots):
        one = WindowState(state.values[t], state.pos[t], state.count[t])
        w_t, n_t = gather_windows(one, ids[t])
        wins.append(w_t)
        ns.append(n_t)
    sk = score_stacked_plain(params, cfg, torch.stack(wins), torch.stack(ns), k=k)
    k_eff = sk.shape[-1]
    if k_eff > 1:
        idx = torch.clamp(k_eff - 1 - later.to(torch.int64), 0, k_eff - 1)
        s = torch.gather(sk, -1, idx[..., None])[..., 0]
    else:
        s = sk[..., 0]
    live = active.to(torch.bool)[:, None] & row_mask(ids.shape, counts, mask)
    return torch.where(live, s, 0.0).to(out_dtype)


# -- kernel KS -----------------------------------------------------------------

def _ks_weights(params: Params, cfg: LstmAdConfig):
    """The six f32 weight tensors KS reads, checked."""
    if "qw" in params["wh"] or params["wh"]["w"].dtype != torch.float32:
        raise NotImplementedError(
            "KS reads float32 master weights (param_dtype='f32'); its "
            "bf16/int8 weight variants are queued in ROADMAP"
        )
    h = kernel_shape(params["wh"])[-2]
    if h != KS_HIDDEN:
        raise NotImplementedError(f"KS is built for hidden={KS_HIDDEN}, got {h}")
    if cfg.dtype not in ("bfloat16", "float32"):
        raise NotImplementedError(f"KS computes in bfloat16 or float32, not {cfg.dtype}")
    return [
        params[layer][leaf].to(torch.float32).contiguous()
        for layer, leaf in (
            ("wx", "w"), ("wx", "b"), ("wh", "w"), ("wh", "b"),
            ("head", "w"), ("head", "b"),
        )
    ]


def _launch_ks(weights, cfg, *, ring, windows, n_valid, ids, later, active,
               counts, mask, out, t_slots, b, w, k) -> None:
    p = kernels.ptr
    s = 0 if ring is None else ring.values.shape[1]
    kernels.launch(
        "lstm_score",
        *[p(x) for x in weights],
        None if ring is None else p(ring.values),
        None if ring is None else p(ring.pos),
        None if ring is None else p(ring.count), s,
        p(ids), 0 if ids is None else ID_KINDS[ids.dtype],
        p(windows), p(n_valid), p(later), p(active), p(counts), p(mask),
        p(out), VAL_KINDS[out.dtype], t_slots, b, w, KS_HIDDEN, k,
        1 if cfg.dtype == "bfloat16" else 0,
        kernels.stream_handle(out.device),
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
    s_slots, b, w = windows.shape
    if not 2 <= w <= KS_MAX_WINDOW:
        raise ValueError(f"KS takes windows of 2..{KS_MAX_WINDOW}, got {w}")
    k = clamp_fuse_k(k, w)
    weights = _ks_weights(params, cfg)
    out = torch.empty((s_slots, b, k), dtype=torch.float32, device=windows.device)
    _launch_ks(
        weights, cfg, ring=None,
        windows=windows.to(torch.float32).contiguous(),
        n_valid=n_valid.to(torch.int32).contiguous(),
        ids=None, later=None, active=None, counts=None, mask=None, out=out,
        t_slots=s_slots, b=b, w=w, k=k,
    )
    return out


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
    t_slots, b = ids.shape
    w = state.values.shape[-1]
    if not 2 <= w <= KS_MAX_WINDOW:
        raise ValueError(f"KS takes windows of 2..{KS_MAX_WINDOW}, got {w}")
    if (counts is None) == (mask is None):
        raise ValueError("pass exactly one of counts and mask")
    weights = _ks_weights(params, cfg)
    out = torch.empty((t_slots, b), dtype=out_dtype, device=ids.device)
    _launch_ks(
        weights, cfg, ring=state, windows=None, n_valid=None,
        ids=ids.contiguous(), later=later.to(torch.int32).contiguous(),
        active=active.to(torch.bool).contiguous(),
        counts=None if counts is None else counts.to(torch.int32).contiguous(),
        mask=None if mask is None else mask.to(torch.bool).contiguous(),
        out=out, t_slots=t_slots, b=b, w=w, k=clamp_fuse_k(k, w),
    )
    return out
