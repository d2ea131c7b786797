"""DeepAR-style probabilistic forecaster (GRU, Gaussian head) — the port of
``sitewhere_tpu/models/deepar.py``.

A GRU reads a normalized window and emits a Gaussian (mu, sigma) for the
next value. As a scorer (the ``forecasting`` tenant template) the score is
the negative log-likelihood of the newest sample in nats, which can be
negative; rows with fewer than 4 real samples score 0. As a forecaster it
encodes a context and samples ``num_samples`` paths ancestrally over the
horizon.

Serving paths and their kernels:

- ``score_stacked`` (the fused megabatch contract) and ``gru_score`` (the
  scoring flush's form): on CPU tensors the plain PyTorch versions, on CUDA
  tensors kernel KD (``csrc/gru_score.cu``) in its windows and ring modes.
- ``forecast``: on CPU tensors ``forecast_plain``, on CUDA tensors kernel KF
  (``csrc/deepar_forecast.cu``). Its noise is drawn from an explicit
  ``torch.Generator`` (or given as ``eps``), so the kernel and the plain
  version can be held together on the same draws.

The plain versions run on any device; the card holds each kernel against
them. Compute is bf16 by default with the reference's rounding points (each
torch op on a bf16 tensor rounds its result, as each reference op does).

KD and KF take any hidden, window and sample count the reference takes:
their templated forms (hidden 8, 16, 32, 64, what fits one block's shared
memory) keep every shape they took, their wide forms
(``csrc/gru_score_wide.cu``, ``csrc/deepar_forecast_wide.cu``) every
other shape whose block state fits shared memory (hidden up to 2,231 for
KD, 2,233 for KF), and their global forms (the same kernels, the block
state in global memory) every wider one (``flush.scan_route``,
``kf_route``). KR trains the same way: its templated form
(``csrc/gru_train.cu``) keeps every shape it took, its wide form
(``csrc/gru_train_wide.cu``) takes any other hidden and window up to
hidden 1,017, its global form any wider one (``flush.train_route``). KD reads
the serving tree in its storage format (f32 masters, bf16, or int8 with
per-slot, per-channel scales, ``models/flush.py``); KF and KR read the f32
masters, as the reference's forecast and training do.

Training: ``loss_stacked`` (the per-row teacher-forced Gaussian NLL f32[S,
B] of a stacked plane) and ``loss_ring`` (the same over every stream of the
rings) are differentiable in the params: on CPU tensors the plain version
under autograd, on CUDA tensors kernel KR (``models/train.py``). The legacy
``loss`` and ``train_step`` are the plain per-tenant composition on CPU
tensors and, on CUDA tensors, ``loss_stacked`` over one slot (KR, then KO
for the port's Adam).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from sitewhere_tpu_torch import kernels
from sitewhere_tpu_torch.models.common import (
    DTYPES,
    Params,
    clamp_fuse_k,
    dense_init,
    gaussian_nll,
    kernel_shape,
    kernel_weight,
    kstep_mask,
    normalize_windows,
    sigmoid,
    softplus,
    tree_map,
    value_and_grad,
)
from sitewhere_tpu_torch.models.flush import (
    GLOBAL_WAVE,
    ROW_SRC_BYTES,
    SCAN_HIDDENS,
    global_scratch,
    launch_ring,
    launch_windows,
    past_block_route,
    plane_blocks,
    scan_state_floats,
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
class DeepArConfig:
    context: int = 128     # conditioning window length
    horizon: int = 24      # forecast steps
    hidden: int = 64
    num_samples: int = 64  # sample paths per series for quantiles
    dtype: str = "bfloat16"

    @property
    def compute_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]


def init(gen: torch.Generator, cfg: DeepArConfig, device="cuda") -> Params:
    h = cfg.hidden
    return {
        "wx": dense_init(gen, 1, 3 * h, device=device),  # GRU input -> gates
        "wh": dense_init(gen, h, 3 * h, scale=1.0 / math.sqrt(h), device=device),
        "mu": dense_init(gen, h, 1, device=device),
        "sigma": dense_init(gen, h, 1, device=device),
    }


def _cell(gx: torch.Tensor, gh: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """GRU update from the gate terms, gate order r, z, n along 3H; bh's n
    part sits inside ``r * nh``."""
    rx, zx, nx = torch.chunk(gx, 3, dim=-1)
    rh, zh, nh = torch.chunk(gh, 3, dim=-1)
    r = sigmoid(rx + rh)
    z = sigmoid(zx + zh)
    n = torch.tanh(nx + r * nh)
    return (1 - z) * n + z * h


# -- single-series path (legacy score, forecast) ------------------------------

def _gru_step(params: Params, h: torch.Tensor, x_t: torch.Tensor, dtype) -> torch.Tensor:
    """x_t: [N] -> new hidden [N, H]. The input projection (in_dim 1) is
    the product ``x_t * wx`` rounded once, as the reference's
    ``x_t[:, None] @ wx``."""
    wx = params["wx"]["w"].to(dtype)
    wh = params["wh"]["w"].to(dtype)
    gx = x_t.to(dtype)[:, None] * wx + params["wx"]["b"].to(dtype)
    gh = h @ wh + params["wh"]["b"].to(dtype)
    return _cell(gx, gh, h)


def _emit(params: Params, h: torch.Tensor, dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    mu = (h @ params["mu"]["w"].to(dtype))[:, 0] + params["mu"]["b"].to(dtype)[0]
    raw = (h @ params["sigma"]["w"].to(dtype))[:, 0] + params["sigma"]["b"].to(dtype)[0]
    sigma = softplus(raw.to(torch.float32)) + 1e-4
    return mu.to(torch.float32), sigma


def _encode(params: Params, normed: torch.Tensor, dtype) -> torch.Tensor:
    """Run the GRU over normed [B, T]; return the final hidden [B, H]. (The
    reference also emits (mu, sigma) at every step for its loss; the
    serving paths read only the last state.)"""
    h = torch.zeros(
        (normed.shape[0], params["wh"]["w"].shape[0]), dtype=dtype, device=normed.device
    )
    xs = normed.to(dtype)
    for step in range(normed.shape[1]):
        h = _gru_step(params, h, xs[:, step], dtype)
    return h


def score(
    params: Params, cfg: DeepArConfig, windows: torch.Tensor, n_valid: torch.Tensor,
) -> torch.Tensor:
    """Anomaly-score adapter (the legacy per-tenant scorer): the NLL of the
    last observed step, in nats; rows with fewer than 4 samples score 0.
    On CUDA tensors it is KD in windows mode over one slot (the same
    arithmetic, K=1)."""
    if windows.is_cuda:
        stacked = {k: {x: v[None] for x, v in node.items()} for k, node in params.items()}
        return score_stacked(stacked, cfg, windows[None], n_valid[None])[0, :, 0]
    dtype = cfg.compute_dtype
    normed, _, _ = normalize_windows(windows)
    mu, sigma = _emit(params, _encode(params, normed[:, :-1], dtype), dtype)
    nll = gaussian_nll(normed[:, -1], mu, sigma)
    return torch.where(n_valid >= 4, nll, 0.0).to(torch.float32)


def loss(params: Params, cfg: DeepArConfig, windows: torch.Tensor) -> torch.Tensor:
    """Gaussian NLL of each next step given the prefix (teacher forcing),
    the mean over rows and steps (training). On CUDA tensors
    ``loss_stacked`` over one slot (KR), the mean of its per-row means
    (every row has W-1 steps, so it is the same mean)."""
    if windows.is_cuda:
        return loss_stacked(tree_map(lambda x: x[None], params), cfg, windows[None])[0].mean()
    dtype = cfg.compute_dtype
    normed, _, _ = normalize_windows(windows)
    h = torch.zeros((normed.shape[0], params["wh"]["w"].shape[0]), dtype=dtype)
    xs = normed.to(dtype)
    mus, sigmas = [], []
    for step in range(normed.shape[1] - 1):
        h = _gru_step(params, h, xs[:, step], dtype)
        mu, sigma = _emit(params, h, dtype)
        mus.append(mu)
        sigmas.append(sigma)
    nll = gaussian_nll(normed[:, 1:], torch.stack(mus, 1), torch.stack(sigmas, 1))
    return nll.mean()


def train_step(params: Params, opt_state, windows: torch.Tensor, cfg: DeepArConfig, optimizer):
    """One optimizer step on ``loss``: (params, opt_state, loss), with an
    optimizer of optax's ``update`` surface; the port's Adam
    (``ops.adam.scale_by_adam()``, ``adam(lr)``) runs as KO on CUDA
    tensors, in place (``ops.adam.apply_step``)."""
    value, grads = value_and_grad(lambda p: loss(p, cfg, windows), params)
    params, opt_state = optim.apply_step(optimizer, params, grads, opt_state)
    return params, opt_state, value


# -- weight-stacked scoring (plain versions) ----------------------------------

def _stacked_gru_scan(params: Params, xs: torch.Tensor, dtype) -> torch.Tensor:
    """xs: [S, B, T] normalized -> hidden states [T, S, B, H]; one batched
    matmul per step over the whole stacked plane."""
    s, b, t = xs.shape
    h_dim = kernel_shape(params["wh"])[-2]
    wx = kernel_weight(params["wx"], dtype)            # [S, 1, 3H]
    wh = kernel_weight(params["wh"], dtype)            # [S, H, 3H]
    bx = params["wx"]["b"].to(dtype)[:, None, :]       # [S, 1, 3H]
    bh = params["wh"]["b"].to(dtype)[:, None, :]
    h = torch.zeros((s, b, h_dim), dtype=dtype, device=xs.device)
    xs_c = xs.to(dtype)
    hs = []
    for step in range(t):
        gx = xs_c[:, :, step, None] * wx[:, 0][:, None, :] + bx
        gh = torch.bmm(h, wh) + bh
        h = _cell(gx, gh, h)
        hs.append(h)
    return torch.stack(hs)


def score_stacked_plain(
    params: Params, cfg: DeepArConfig, windows: torch.Tensor,
    n_valid: torch.Tensor, k: int = 1,
) -> torch.Tensor:
    """Plain version of ``score_stacked``: f32[S, B, K], column j the
    Gaussian NLL at window position W-K+j (j = K-1 is the newest)."""
    dtype = cfg.compute_dtype
    k = clamp_fuse_k(k, windows.shape[-1])
    normed, _, _ = normalize_windows(windows)
    hk = _stacked_gru_scan(params, normed[..., :-1], dtype)[-k:]   # [K, S, B, H]

    def head(name):
        w = kernel_weight(params[name], dtype)                     # [S, H, 1]
        b = params[name]["b"].to(dtype)[..., 0][None, :, None]     # [1, S, 1]
        return (torch.einsum("ksbh,sho->ksbo", hk, w)[..., 0] + b).to(torch.float32)

    mus = head("mu")
    sigmas = softplus(head("sigma")) + 1e-4
    targets = torch.movedim(normed[..., -k:], -1, 0)               # [K, S, B]
    scores = torch.movedim(gaussian_nll(targets, mus, sigmas), 0, -1)
    return torch.where(kstep_mask(n_valid, k), scores, 0.0).to(torch.float32)


def loss_stacked_plain(params: Params, cfg: DeepArConfig, windows: torch.Tensor) -> torch.Tensor:
    """Plain version of ``loss_stacked``: row (s, b)'s mean Gaussian NLL
    over its W-1 teacher-forced steps, f32[S, B]."""
    dtype = cfg.compute_dtype
    normed, _, _ = normalize_windows(windows)
    hs = _stacked_gru_scan(params, normed[..., :-1], dtype)   # [T, S, B, H]

    def head(name):
        w = kernel_weight(params[name], dtype)                 # [S, H, 1]
        b = params[name]["b"].to(dtype)[..., 0][None, :, None]
        return (torch.einsum("tsbh,sho->tsbo", hs, w)[..., 0] + b).to(torch.float32)

    mus = head("mu")
    sigmas = softplus(head("sigma")) + 1e-4
    targets = torch.movedim(normed[..., 1:], -1, 0)            # [T, S, B]
    return gaussian_nll(targets, mus, sigmas).mean(0)


def gru_score_plain(
    params: Params, cfg: DeepArConfig, state: WindowState, ids, later, active,
    counts=None, mask=None, k: int = 1, out_dtype=torch.float32,
) -> torch.Tensor:
    """Plain version of KD's flush form: scores [T, B] in ``out_dtype``."""
    return score_flush_plain(
        score_stacked_plain, params, cfg, state, ids, later, active, counts,
        mask, k, out_dtype,
    )


# -- kernel KD -----------------------------------------------------------------

KD_LEAVES = (
    ("wx", "w"), ("wx", "b"), ("wh", "w"), ("wh", "b"),
    ("mu", "w"), ("mu", "b"), ("sigma", "w"), ("sigma", "b"),
)


def score_stacked(
    params: Params, cfg: DeepArConfig, windows: torch.Tensor,
    n_valid: torch.Tensor, k: int = 1,
) -> torch.Tensor:
    """Fused NLL scoring over a stacked tenant plane: windows f32[S, B, W],
    n_valid i32[S, B] -> f32[S, B, K]. CPU tensors take the plain version;
    CUDA tensors launch KD (windows mode)."""
    if not windows.is_cuda:
        return score_stacked_plain(params, cfg, windows, n_valid, k=k)
    weights = scan_weights(params, cfg, KD_LEAVES, "KD")
    return launch_windows("gru_score", "KD", weights, cfg, windows, n_valid, k)


def gru_score(
    params: Params, cfg: DeepArConfig, state: WindowState, ids, later, active,
    counts=None, mask=None, k: int = 1, out_dtype=torch.float32,
) -> torch.Tensor:
    """Kernel KD in its flush form (K2 gather + K8 scan and NLL + K4a
    epilogue): scores [T, B] in ``out_dtype`` for rows ``ids`` [T, B] of
    the post-update rings. CPU tensors take ``gru_score_plain``; CUDA
    tensors launch KD (ring mode)."""
    if not ids.is_cuda:
        return gru_score_plain(
            params, cfg, state, ids, later, active, counts, mask, k, out_dtype
        )
    weights = scan_weights(params, cfg, KD_LEAVES, "KD")
    return launch_ring(
        "gru_score", "KD", weights, cfg, state, ids, later, active, counts,
        mask, k, out_dtype,
    )


# -- kernel KR: the train form ----------------------------------------------------

def _kr_grads(red: torch.Tensor, dwh: torch.Tensor, h: int):
    """KR's reduced sums [dwx 3H | dbx 3H | dbh 3H | dmu_w H | dsigma_w H |
    dmu_b | dsigma_b] and dWh -> the gradients of ``KD_LEAVES``."""
    g = 3 * h
    s = red.shape[0]

    def cut(lo, n, shape):
        return red[:, lo:lo + n].reshape(shape).contiguous()

    return (
        cut(0, g, (s, 1, g)), cut(g, g, (s, g)), dwh.contiguous(), cut(2 * g, g, (s, g)),
        cut(3 * g, h, (s, h, 1)), cut(3 * g + 2 * h, 1, (s, 1)),
        cut(3 * g + h, h, (s, h, 1)), cut(3 * g + 2 * h + 1, 1, (s, 1)),
    )


KR = TrainForm(
    name="gru_train", label="KR", leaves=KD_LEAVES, gates=3, heads=2, cell=False,
    n_partials=lambda h: 3 * 3 * h + 2 * h + 2, grads=_kr_grads,
)


def loss_stacked(params: Params, cfg: DeepArConfig, windows: torch.Tensor) -> torch.Tensor:
    """Per-row teacher-forced Gaussian NLL over a stacked plane: windows
    f32[S, B, W] -> f32[S, B], differentiable in ``params``. CPU tensors
    take the plain version; CUDA tensors launch KR (windows mode)."""
    if not windows.is_cuda:
        return loss_stacked_plain(params, cfg, windows)
    return loss_stacked_kernel(KR, params, cfg, windows)


def loss_ring(params: Params, cfg: DeepArConfig, state: WindowState) -> torch.Tensor:
    """``loss_stacked`` over every stream of the rings ``state`` [S,
    streams, W] -> f32[S, streams]; CUDA tensors launch KR in ring mode."""
    if not state.values.is_cuda:
        return loss_stacked_plain(params, cfg, ring_windows(state))
    return loss_ring_kernel(KR, params, cfg, state)


# -- forecasting ---------------------------------------------------------------

def forecast_plain(
    params: Params, cfg: DeepArConfig, windows: torch.Tensor, eps: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of KF: windows f32[B, context], eps f32[horizon,
    num_samples * B] -> (samples f32[num_samples, B, horizon], mean
    f32[B, horizon]) in raw units."""
    dtype = cfg.compute_dtype
    normed, mu_n, sigma_n = normalize_windows(windows)
    h_ctx = _encode(params, normed, dtype)
    b, s = windows.shape[0], cfg.num_samples
    h = h_ctx[None].expand(s, b, h_ctx.shape[-1]).reshape(s * b, -1)
    x = normed[:, -1][None].expand(s, b).reshape(s * b).to(dtype)
    path = []
    for t in range(cfg.horizon):
        h = _gru_step(params, h, x, dtype)
        mu, sigma = _emit(params, h, dtype)
        x_next = mu + sigma * eps[t]
        path.append(x_next)
        x = x_next.to(dtype)
    path = torch.stack(path).reshape(cfg.horizon, s, b).permute(1, 2, 0)
    raw = path * sigma_n[None] + mu_n[None]
    return raw.to(torch.float32), raw.mean(0).to(torch.float32)


def kf_smem_bytes(h: int, num_samples: int, horizon: int, context: int) -> int:
    """The dynamic shared memory of KF's one-block form (``launch_kf``): a
    series' paths' h, gate sums, n parts, carried x and un-normalized
    paths, the context and its two statistics."""
    return (num_samples * (5 * h + 1 + horizon) + context + 2) * 4


def kf_wide_smem_bytes(h: int, rows: int) -> int:
    """The dynamic shared memory of KF's wide form (``launch_kfw``) at
    ``rows`` paths a block: two window sources, two steps' x, and the block
    state (hT double-buffered with a row stride of rows + 4, the two heads:
    ``flush.scan_state_floats("gru_score", ...)``)."""
    return 2 * ROW_SRC_BYTES + 4 * (scan_state_floats("gru_score", h, rows) + 2 * rows)


def kf_route(h: int, num_samples: int, horizon: int, context: int,
             series: Optional[int] = None) -> Tuple[str, int]:
    """The form of KF a forecast takes, decided before any launch:
    ("block", num_samples) for the one-block form (hidden in
    ``SCAN_HIDDENS`` and a series' paths in one block's shared memory: every
    shape it took before), ("wide", paths a block) while the wide form's
    block state fits shared memory (every shape it took before), else
    ("global", ``flush.global_rows`` over ``series`` x ceil(num_samples /
    rows) blocks)."""
    fits = kf_smem_bytes(h, num_samples, horizon, context) <= kernels.SMEM_MAX_BYTES
    if h in SCAN_HIDDENS and fits:
        return "block", num_samples
    return past_block_route(lambda r: kf_wide_smem_bytes(h, r),
                            plane_blocks(None if series is None else (series, num_samples)))


def forecast(
    params: Params, cfg: DeepArConfig, windows: torch.Tensor,
    generator: Optional[torch.Generator] = None, eps: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample ``num_samples`` paths per series over the horizon: windows
    f32[B, context] history (raw units) -> (samples f32[num_samples, B,
    horizon], mean f32[B, horizon]) in raw units. The noise is drawn from
    ``generator`` (on the windows' device) as eps f32[horizon,
    num_samples * B], path index ``s * B + b``; or pass ``eps`` itself.
    CPU tensors take ``forecast_plain``; CUDA tensors launch KF."""
    if (generator is None) == (eps is None):
        raise ValueError("pass exactly one of generator and eps")
    b = windows.shape[0]
    if eps is None:
        eps = torch.randn(
            (cfg.horizon, cfg.num_samples * b), generator=generator,
            dtype=torch.float32, device=windows.device,
        )
    if tuple(eps.shape) != (cfg.horizon, cfg.num_samples * b):
        raise ValueError(
            f"eps must be f32[{cfg.horizon}, {cfg.num_samples * b}], got "
            f"{tuple(eps.shape)}"
        )
    if not windows.is_cuda:
        return forecast_plain(params, cfg, windows, eps)
    if cfg.num_samples < 1:
        raise ValueError(f"KF draws at least one sample path, got {cfg.num_samples}")
    weights = scan_weights(
        params, cfg, KD_LEAVES, "KF", formats=("f32",),
        why=" (the reference's forecast reads the master weights, deepar.py:58-61)",
    )
    windows = windows.to(torch.float32).contiguous()
    eps = eps.to(torch.float32).contiguous()
    samples = torch.empty(
        (cfg.num_samples, b, cfg.horizon), dtype=torch.float32, device=windows.device
    )
    mean = torch.empty((b, cfg.horizon), dtype=torch.float32, device=windows.device)
    p = kernels.ptr
    route, rows = kf_route(weights.hidden, cfg.num_samples, cfg.horizon, windows.shape[1], b)
    extra = () if route == "block" else (rows,)
    if route == "global":
        state = global_scratch(scan_state_floats("gru_score", weights.hidden, rows),
                               b * -(-cfg.num_samples // rows), windows.device)
        extra += (p(state), GLOBAL_WAVE)
    kernels.launch(
        "deepar_forecast" if route == "block" else f"deepar_forecast_{route}",
        *[p(x) for x in weights.tensors[:len(KD_LEAVES)]], p(windows),
        p(eps), p(samples), p(mean), b, windows.shape[1], cfg.num_samples, cfg.horizon,
        weights.hidden, 1 if cfg.dtype == "bfloat16" else 0, *extra,
        kernels.stream_handle(windows.device),
        variant=f"h{weights.hidden}" if route == "block"
        else f"h{weights.hidden},s{cfg.num_samples}",
    )
    return samples, mean


def quantiles(samples: torch.Tensor, qs=(0.1, 0.5, 0.9)) -> torch.Tensor:
    """[S, B, H] sample paths -> [Q, B, H] empirical quantiles (linear
    interpolation, as ``jnp.quantile``)."""
    q = torch.tensor(qs, dtype=samples.dtype, device=samples.device)
    return torch.quantile(samples, q, dim=0)
