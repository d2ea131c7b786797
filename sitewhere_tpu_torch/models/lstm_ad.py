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
path: on CPU tensors its plain version, on CUDA tensors KS in windows mode
over one slot. The legacy ``loss`` and ``train_step`` are the plain
per-tenant composition on CPU tensors and, on CUDA tensors,
``loss_stacked`` over one slot (KB, then KO for the port's Adam).

KS and KB take any hidden and window the reference takes: their templated
forms (hidden 8, 16, 32, 64, while a block's tiles fit) keep every shape
they took, their wide forms (``csrc/lstm_score_wide.cu``,
``csrc/lstm_train_wide.cu``) every other shape whose block state fits
one block's shared memory (hidden up to 1,757 serving, 784 training),
and their global forms (the same kernels, the block state in global
memory) every wider one (``flush.scan_route``, ``flush.train_route``).
KS reads the serving tree in its storage format (f32 masters, bf16,
or int8 with per-slot, per-channel scales, ``models/flush.py``), KB the
f32 masters.

Training: ``loss_stacked`` (the per-row teacher-forced MSE f32[S, B] of a
stacked plane) and ``loss_ring`` (the same over every stream of the rings)
are differentiable in the params. On CPU tensors they are the plain
version under autograd; on CUDA tensors kernel KB (``csrc/lstm_train.cu``
or ``lstm_train_wide.cu``) runs their forward and backward
(``models/train.py``).
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
    tree_map,
    value_and_grad,
)
from sitewhere_tpu_torch.models.flush import (
    launch_ring,
    launch_windows,
    scan_weights,
    score_flush_plain,
)
from sitewhere_tpu_torch.models.train import (
    TrainForm,
    loss_ring_kernel,
    loss_stacked_kernel,
    ring_windows,
)
from sitewhere_tpu_torch.ops import adam as optim
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


# -- legacy single-tenant path (the plain composition; CUDA goes stacked) ------

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
    rows with fewer than 4 samples score 0. On CUDA tensors it is KS in
    windows mode over one slot (``score_stacked``'s column K-1)."""
    if windows.is_cuda:
        stacked = tree_map(lambda x: x[None], params)
        return score_stacked(stacked, cfg, windows[None], n_valid[None])[0, :, 0]
    normed, _, _ = normalize_windows(windows)
    preds = predict_next(params, cfg, windows)
    err = torch.abs(normed[:, -1] - preds[:, -1])
    return torch.where(n_valid >= 4, err, 0.0).to(torch.float32)


def loss(params: Params, cfg: LstmAdConfig, windows: torch.Tensor) -> torch.Tensor:
    """Teacher-forced next-step MSE over the whole window (training). On
    CUDA tensors ``loss_stacked`` over one slot (KB), the mean of its
    per-row means (every row has W-1 positions, so it is the same mean)."""
    if windows.is_cuda:
        return loss_stacked(tree_map(lambda x: x[None], params), cfg, windows[None])[0].mean()
    normed, _, _ = normalize_windows(windows)
    preds = predict_next(params, cfg, windows)
    return torch.mean((preds - normed[:, 1:]) ** 2)


def train_step(params: Params, opt_state, windows: torch.Tensor, cfg: LstmAdConfig, optimizer):
    """One optimizer step on ``loss``: (params, opt_state, loss).
    ``optimizer`` has optax's ``update(grads, state, params)`` surface; the
    port's Adam (``ops.adam.scale_by_adam()``, ``adam(lr)``) runs as KO on
    CUDA tensors, in place (``ops.adam.apply_step``)."""
    value, grads = value_and_grad(lambda p: loss(p, cfg, windows), params)
    params, opt_state = optim.apply_step(optimizer, params, grads, opt_state)
    return params, opt_state, value


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


def loss_stacked_plain(params: Params, cfg: LstmAdConfig, windows: torch.Tensor) -> torch.Tensor:
    """Plain version of ``loss_stacked``: row (s, b)'s mean squared
    next-step error over its W-1 teacher-forced predictions, f32[S, B]."""
    dtype = cfg.compute_dtype
    normed, _, _ = normalize_windows(windows)           # f32[S, B, W]
    hs = _stacked_lstm_scan(params, normed[..., :-1], dtype)   # [T, S, B, H]
    w_head = kernel_weight(params["head"], dtype)       # [S, H, 1]
    b_head = params["head"]["b"].to(dtype)              # [S, 1]
    preds = (
        torch.einsum("tsbh,sho->tsbo", hs, w_head)[..., 0]
        + b_head[..., 0][None, :, None]
    ).to(torch.float32)                                 # [T, S, B]
    targets = torch.movedim(normed[..., 1:], -1, 0)     # [T, S, B]
    return torch.mean((preds - targets) ** 2, dim=0)    # [S, B]


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


# -- kernel KB: the train form ---------------------------------------------------

def _kb_grads(red: torch.Tensor, dwh: torch.Tensor, h: int):
    """KB's reduced sums [dwx 4H | db 4H | dhead_w H | dhead_b] and dWh ->
    the gradients of ``KS_LEAVES`` (wx.b and wh.b share db)."""
    g = 4 * h
    s = red.shape[0]
    db = red[:, g:2 * g].contiguous()
    return (
        red[:, :g].reshape(s, 1, g).contiguous(), db, dwh.contiguous(), db.clone(),
        red[:, 2 * g:2 * g + h].reshape(s, h, 1).contiguous(),
        red[:, 2 * g + h:2 * g + h + 1].contiguous(),
    )


KB = TrainForm(
    name="lstm_train", label="KB", leaves=KS_LEAVES, gates=4, heads=1, cell=True,
    n_partials=lambda h: 2 * 4 * h + h + 1, grads=_kb_grads,
)


def loss_stacked(params: Params, cfg: LstmAdConfig, windows: torch.Tensor) -> torch.Tensor:
    """Per-row teacher-forced MSE over a stacked plane: windows f32[S, B,
    W] -> f32[S, B], differentiable in ``params``. CPU tensors take the
    plain version; CUDA tensors launch KB (windows mode)."""
    if not windows.is_cuda:
        return loss_stacked_plain(params, cfg, windows)
    return loss_stacked_kernel(KB, params, cfg, windows)


def loss_ring(params: Params, cfg: LstmAdConfig, state: WindowState) -> torch.Tensor:
    """``loss_stacked`` over every stream of the rings ``state`` [S,
    streams, W] -> f32[S, streams]. CPU tensors take the plain version on
    the gathered windows; CUDA tensors launch KB in ring mode, which
    gathers inside the kernel."""
    if not state.values.is_cuda:
        return loss_stacked_plain(params, cfg, ring_windows(state))
    return loss_ring_kernel(KB, params, cfg, state)
