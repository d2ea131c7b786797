"""Shared building blocks of the port's models (the serving-path subset of
``sitewhere_tpu/models/common.py``).

Params are plain nested dicts of tensors (``{"w", "b"}`` per dense layer),
so stacking per-tenant params along a leading slot dim is a tree op, and a
JAX param tree carries across as numpy (``params_from_numpy`` /
``params_to_numpy``) with the same keys, as does optax's Adam state
(``opt_state_from_numpy`` / ``opt_state_to_numpy``). Params are float32;
compute defaults to bfloat16. Init takes an explicit ``torch.Generator`` (a
CPU one, so the same seed gives the same weights on every device).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from sitewhere_tpu_torch import kernels

Params = Dict[str, Any]

# config dtype names -> torch dtypes (LstmAdConfig.dtype); the kernels
# compute in bfloat16 or float32, the plain versions in any of these
DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def wide(dtype: torch.dtype) -> torch.dtype:
    """The dtype of the reference's f32 steps (statistics, softmax) for a
    compute dtype: float32, or the compute dtype if it is wider (a float64
    run of the plain versions is f64 throughout)."""
    return torch.promote_types(dtype, torch.float32)


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
    wf = windows.to(wide(windows.dtype))
    mu = wf.mean(-1, keepdim=True)
    sigma = wf.std(-1, keepdim=True, correction=0) + eps
    return (wf - mu) / sigma, mu, sigma


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` as the reference's XLA lowers it: ``1 / (1 +
    exp(-x))`` as three ops, so a bf16 input rounds after the exp, the add
    and the division (``torch.sigmoid`` rounds once)."""
    return 1 / (1 + torch.exp(-x))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0), with no threshold."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def gaussian_nll(targets, mus, sigmas) -> torch.Tensor:
    """The Gaussian NLL of the DeepAR and transformer heads, in f32."""
    return 0.5 * torch.log(2 * math.pi * sigmas**2) + (targets - mus) ** 2 / (
        2 * sigmas**2
    )


def tree_map(fn, tree, *rest):
    """Apply ``fn`` to every leaf of a nested dict/list param tree; with
    more trees of the same structure, ``fn`` takes the leaves at the same
    place in each (as ``jax.tree_util.tree_map``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        if any(len(r) != len(tree) for r in rest):
            raise ValueError("tree_map: lists of different lengths")
        return type(tree)(tree_map(fn, *leaves) for leaves in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of a nested dict/list tree, in ``tree_map``'s order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def value_and_grad(fn, params: Params):
    """``jax.value_and_grad`` over a param tree: ``fn(params)`` -> a scalar
    tensor; returns (value, grads shaped as ``params``). Differentiates
    fresh leaves that share the params' memory."""
    p = tree_map(lambda x: x.detach().requires_grad_(True), params)
    value = fn(p)
    flat = tree_leaves(p)
    grads = torch.autograd.grad(value, flat, allow_unused=True)
    it = iter(torch.zeros_like(x) if g is None else g for g, x in zip(grads, flat))
    return value.detach(), tree_map(lambda _: next(it), p)


def _tensor_from_numpy(a) -> torch.Tensor:
    """One numpy leaf as a CPU tensor; a bfloat16 array (``ml_dtypes``',
    as a bf16 JAX leaf comes out of ``np.asarray``) by its raw bits."""
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_numpy(tree, device) -> Params:
    """A param tree of numpy arrays (a JAX tree after ``np.asarray`` on
    each leaf; stacked ``[T, ...]`` or single) -> the port's tree of
    tensors on ``device``, same keys. A quantized tree (``quantize_params``)
    carries across too: int8 ``qw``, f32 ``scale``, bf16 ``w``."""
    return tree_map(lambda a: _tensor_from_numpy(a).to(device), tree)


def params_to_numpy(tree) -> Dict[str, Any]:
    """The port's param tree -> numpy arrays with the same keys (a bf16
    leaf widened to float32, exactly: numpy has no bfloat16)."""
    def leaf(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()

    return tree_map(leaf, tree)


def opt_state_from_numpy(state, device):
    """The reference's ``ScaleByAdamState`` (``count``, ``mu``, ``nu``, each
    numpy or a JAX array; stacked ``[T, ...]`` as ``jax.vmap(optimizer.init)``
    lays it out, or one slot as ``slot_opt_state`` returns it) -> the port's
    ``ops.adam.AdamState`` of tensors on ``device``, count i32."""
    from sitewhere_tpu_torch.ops.adam import AdamState

    count, mu, nu = state
    count = torch.from_numpy(np.array(count, dtype=np.int32, copy=True)).to(device)
    return AdamState(count, params_from_numpy(mu, device), params_from_numpy(nu, device))


def opt_state_to_numpy(state):
    """The port's ``AdamState`` -> an ``AdamState`` of numpy arrays (count
    i32), the layout ``opt_state_from_numpy`` takes."""
    from sitewhere_tpu_torch.ops.adam import AdamState

    count, mu, nu = state
    return AdamState(
        count.detach().cpu().numpy().astype(np.int32), params_to_numpy(mu), params_to_numpy(nu)
    )


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


# -- transformer blocks: the plain math, under the reference's names ---------
#
# Each function rounds where ``sitewhere_tpu/models/common.py`` rounds: a
# torch op on a bf16 tensor rounds its result, as each reference op does,
# and a bf16 matmul accumulates in f32 and rounds once, as the reference's
# einsum. The transformer family's kernels (KL, KA, KU below; KE and KN in
# ``models/transformer.py``) are held against these.

def layernorm_init(dim: int, device="cuda") -> Params:
    return {
        "scale": torch.ones((dim,), dtype=torch.float32, device=device),
        "bias": torch.zeros((dim,), dtype=torch.float32, device=device),
    }


def mha_init(gen: torch.Generator, dim: int, heads: int, device="cuda") -> Params:
    del heads  # the head count is config, not a parameter
    return {n: dense_init(gen, dim, dim, device=device) for n in ("wq", "wk", "wv", "wo")}


def mlp_init(gen: torch.Generator, dim: int, hidden: int, device="cuda") -> Params:
    return {
        "fc1": dense_init(gen, dim, hidden, device=device),
        "fc2": dense_init(gen, hidden, dim, device=device),
    }


def transformer_block_init(
    gen: torch.Generator, dim: int, heads: int, mlp_ratio: int = 4, device="cuda",
) -> Params:
    return {
        "ln1": layernorm_init(dim, device),
        "attn": mha_init(gen, dim, heads, device),
        "ln2": layernorm_init(dim, device),
        "mlp": mlp_init(gen, dim, dim * mlp_ratio, device),
    }


def dense(p: Params, x: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """``x @ w`` rounded to the compute dtype, then ``+ b`` rounded again."""
    return torch.matmul(x.to(dtype), p["w"].to(dtype)) + p["b"].to(dtype)


def stacked_bias(p: Params, x_ndim: int, dtype) -> torch.Tensor:
    """Bias ``[S, O]`` shaped to broadcast against ``[S, ..., O]``."""
    b = p["b"].to(dtype)
    return b.reshape(b.shape[0], *([1] * (x_ndim - 2)), b.shape[-1])


def dense_stacked(p: Params, x: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Weight-stacked dense: x [S, ..., I] x w [S, I, O] -> [S, ..., O] as
    one batched matmul over the slot dim, with ``dense``'s two roundings."""
    w = kernel_weight(p, dtype)
    y = torch.bmm(x.to(dtype).reshape(x.shape[0], -1, x.shape[-1]), w)
    return y.reshape(*x.shape[:-1], w.shape[-1]) + stacked_bias(p, x.ndim, dtype)


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """f32 mean and population variance, ``rsqrt(var + eps)``, then
    ``* scale + bias`` in f32 and a cast back to the input dtype."""
    xf = x.to(wide(x.dtype))
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


def layernorm_stacked(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``layernorm`` with per-slot scale/bias [S, D] over x [S, ..., D]."""
    shape = (x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],)
    return layernorm(
        {"scale": p["scale"].reshape(shape), "bias": p["bias"].reshape(shape)}, x, eps
    )


def attn_core(q, k, v, causal: bool, dtype) -> torch.Tensor:
    """The reference's attention math: q, k, v [..., T, H, hd] -> [...,
    T, H*hd]. The QK^T product comes out in the compute dtype and is
    widened to f32; it is scaled by ``1/sqrt(hd)`` in f32 (XLA folds the
    reference's division into that product), masked with -1e30 when
    causal, put through an f32 softmax (``exp(l - max) / sum``, as
    ``jax.nn.softmax``), cast to the compute dtype; the AV product comes
    out in the compute dtype."""
    t, hd = q.shape[-3], q.shape[-1]
    logits = torch.einsum("...qhd,...khd->...hqk", q, k).to(wide(dtype))
    logits = logits * (1.0 / math.sqrt(hd))
    if causal:
        mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=q.device))
        logits = torch.where(mask, logits, -1e30)
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    attn = (e / e.sum(-1, keepdim=True)).to(dtype)
    out = torch.einsum("...hqk,...khd->...qhd", attn, v)
    return out.reshape(*out.shape[:-2], out.shape[-2] * out.shape[-1])


def _split_heads(a: torch.Tensor, heads: int) -> torch.Tensor:
    return a.reshape(*a.shape[:-1], heads, a.shape[-1] // heads)


def mha(p: Params, x, heads: int, causal: bool = False, dtype=torch.bfloat16):
    q, k, v = (_split_heads(dense(p[n], x, dtype), heads) for n in ("wq", "wk", "wv"))
    return dense(p["wo"], attn_core(q, k, v, causal, dtype), dtype)


def mha_stacked(p: Params, x, heads: int, causal: bool = False, dtype=torch.bfloat16):
    q, k, v = (
        _split_heads(dense_stacked(p[n], x, dtype), heads) for n in ("wq", "wk", "wv")
    )
    return dense_stacked(p["wo"], attn_core(q, k, v, causal, dtype), dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (``approximate=True``, the tanh form) as XLA lowers
    it: ``x * (0.5 * (1 + tanh(c * (x + k * x**3))))`` with ``c =
    sqrt(2/pi)`` and ``k = 0.044715`` cast to the input dtype and ``x**3``
    as ``(x * x) * x``, every op rounded in that dtype.
    ``F.gelu(x, approximate="tanh")`` computes in f32 and rounds once."""
    c = torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype, device=x.device)
    k = torch.tensor(0.044715, dtype=x.dtype, device=x.device)
    cdf = 0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x))))
    return x * cdf


def mlp(p: Params, x, dtype=torch.bfloat16):
    return dense(p["fc2"], gelu(dense(p["fc1"], x, dtype)), dtype)


def transformer_block(p: Params, x, heads: int, causal: bool = False, dtype=torch.bfloat16):
    x = x + mha(p["attn"], layernorm(p["ln1"], x), heads, causal=causal, dtype=dtype)
    return x + mlp(p["mlp"], layernorm(p["ln2"], x), dtype=dtype)


def transformer_block_stacked(
    p: Params, x, heads: int, causal: bool = False, dtype=torch.bfloat16,
):
    x = x + mha_stacked(
        p["attn"], layernorm_stacked(p["ln1"], x), heads, causal=causal, dtype=dtype
    )
    h = layernorm_stacked(p["ln2"], x)
    return x + dense_stacked(
        p["mlp"]["fc2"], gelu(dense_stacked(p["mlp"]["fc1"], h, dtype)), dtype
    )


# -- kernels KL, KA, KU: wrappers and their plain versions --------------------
#
# The transformer block's device functions on rows laid out as the stacked
# projections produce them: a [S, B, T, D] activation is N = S*B*T rows of
# D (KL, KU; the slot of row n is ``n // rows_per_slot``) or S*B sequences
# of T tokens (KA, heads split by column). On CPU tensors each wrapper runs
# its plain version; on CUDA tensors it launches its kernel or raises.

ACT_KINDS = {torch.float32: 0, torch.bfloat16: 1}  # activation dtypes the kernels take
ATTN_HEAD_DIMS = (32, 64)  # KA's head widths: the transformer family's and ViT-B/16's
ATTN_MAX_T = 512           # the longest sequence KA takes (transformer.py:12)


def _check_rows(name: str, x: torch.Tensor, params: Sequence[torch.Tensor], rows_per_slot: int):
    if x.dtype not in ACT_KINDS:
        raise TypeError(f"{name} takes float32 or bfloat16 activations, got {x.dtype}")
    n = x.shape[0]
    if rows_per_slot < 1 or n % rows_per_slot:
        raise ValueError(f"{name}: {n} rows do not split into slots of {rows_per_slot}")
    for t in params:
        if t.dtype != torch.float32 or t.shape != (n // rows_per_slot, x.shape[1]):
            raise ValueError(
                f"{name}: per-slot params must be f32[{n // rows_per_slot}, {x.shape[1]}], "
                f"got {t.dtype}{list(t.shape)}"
            )


def layernorm_rows_plain(x, scale, bias, rows_per_slot: int) -> torch.Tensor:
    """Plain version of KL: rows x [N, D], per-slot scale/bias f32 [S, D]."""
    n, d = x.shape
    y = layernorm_stacked({"scale": scale, "bias": bias}, x.reshape(-1, rows_per_slot, d))
    return y.reshape(n, d)


def layernorm_rows(x, scale, bias, rows_per_slot: int) -> torch.Tensor:
    """Kernel KL (``csrc/layernorm.cu``): ``layernorm_stacked`` over rows
    x [N, D] in the compute dtype, out in the same dtype."""
    if not x.is_cuda:
        return layernorm_rows_plain(x, scale, bias, rows_per_slot)
    x, scale, bias = x.contiguous(), scale.contiguous(), bias.contiguous()
    _check_rows("KL", x, (scale, bias), rows_per_slot)
    out = torch.empty_like(x)
    p = kernels.ptr
    kernels.launch(
        "layernorm", p(x), p(scale), p(bias), p(out), x.shape[0], x.shape[1],
        rows_per_slot, ACT_KINDS[x.dtype], kernels.stream_handle(x.device),
    )
    return out


def attention_plain(q, k, v, heads: int, causal: bool) -> torch.Tensor:
    """Plain version of KA: q, k, v [N, T, D] -> [N, T, D] in their dtype,
    ``attn_core`` with the heads split by column."""
    return attn_core(
        _split_heads(q, heads), _split_heads(k, heads), _split_heads(v, heads),
        causal, q.dtype,
    )


def attention(q, k, v, heads: int, causal: bool) -> torch.Tensor:
    """Kernel KA (``csrc/attention.cu``): ``attn_core`` over q, k, v [N, T,
    D] as the projections produce them, heads split by column."""
    if not q.is_cuda:
        return attention_plain(q, k, v, heads, causal)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    n, t, d = q.shape
    if q.dtype not in ACT_KINDS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"KA takes float32 or bfloat16 q, k, v of one dtype, got {q.dtype}")
    if k.shape != q.shape or v.shape != q.shape or d % heads:
        raise ValueError(f"KA takes q, k, v of one shape [N, T, heads*hd], got {q.shape}")
    hd = d // heads
    if hd not in ATTN_HEAD_DIMS or not 1 <= t <= ATTN_MAX_T:
        raise NotImplementedError(
            f"KA takes head dims {ATTN_HEAD_DIMS} and T <= {ATTN_MAX_T}, got hd={hd}, T={t} "
            "(ROADMAP item K3'b)"
        )
    out = torch.empty_like(q)
    p = kernels.ptr
    kernels.launch(
        "attention", p(q), p(k), p(v), p(out), n, t, heads, hd, int(causal),
        ACT_KINDS[q.dtype], kernels.stream_handle(q.device),
    )
    return out


def bias_gelu_plain(x, b, rows_per_slot: int) -> torch.Tensor:
    """Plain version of KU: ``gelu(x + b)`` over fc1's product x [N, F]
    with the per-slot bias f32 [S, F] cast to x's dtype (``dense``'s
    second rounding)."""
    n, f = x.shape
    y = x.reshape(-1, rows_per_slot, f) + b.to(x.dtype)[:, None, :]
    return gelu(y).reshape(n, f)


def bias_gelu(x, b, rows_per_slot: int) -> torch.Tensor:
    """Kernel KU (``csrc/bias_gelu.cu``): fc1's bias add and the tanh GELU
    in one elementwise pass over x [N, F]."""
    if not x.is_cuda:
        return bias_gelu_plain(x, b, rows_per_slot)
    x, b = x.contiguous(), b.contiguous()
    _check_rows("KU", x, (b,), rows_per_slot)
    out = torch.empty_like(x)
    p = kernels.ptr
    kernels.launch(
        "bias_gelu", p(x), p(b), p(out), x.shape[0], x.shape[1], rows_per_slot,
        ACT_KINDS[x.dtype], kernels.stream_handle(x.device),
    )
    return out


def check_kernel_params(params: Params, cfg, label: str) -> None:
    """The transformer's and the ViT's kernel paths read f32 master weights
    and compute in bf16/f32."""
    quantized = []

    def walk(node):
        if isinstance(node, dict):
            if "qw" in node or ("w" in node and node["w"].dtype != torch.float32):
                quantized.append(node)
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)

    walk(params)
    if quantized:
        raise NotImplementedError(
            f"{label} reads float32 master weights (param_dtype='f32'); its "
            "bf16/int8 weight variants are ROADMAP item K3'b"
        )
    if cfg.compute_dtype not in ACT_KINDS:
        raise NotImplementedError(f"{label} computes in bfloat16 or float32, not {cfg.dtype}")


def blocks_stacked(blocks, x: torch.Tensor, heads: int, causal: bool, dtype, ops) -> torch.Tensor:
    """The pre-LN blocks over tokens x [S, B, T, D] with per-slot block
    params ([S, ...] leaves) -> the final residual stream: each block
    ``transformer_block_stacked`` through ``ops.layernorm`` (KL: ln1, ln2),
    ``ops.attention`` (KA) and ``ops.bias_gelu`` (KU), the kernels'
    wrappers or their plain versions (a family's ops tuple). The
    projections are batched matmuls over the slot dim with the bias add in
    the compute dtype; fc1's bias add belongs to KU; the residual adds are
    the reference's adds in the compute dtype. The transformer family runs
    it causal over S slots, ViT non-causal over one slot (its params as
    views with a leading dim of 1)."""
    s, b, t, d = x.shape
    rows = b * t  # rows of D per slot
    for blk in blocks:
        a = blk["attn"]
        h = ops.layernorm(x.reshape(-1, d), blk["ln1"]["scale"], blk["ln1"]["bias"], rows)
        h = h.reshape(x.shape)
        q, k, v = (dense_stacked(a[n], h, dtype).reshape(s * b, t, d) for n in ("wq", "wk", "wv"))
        o = ops.attention(q, k, v, heads, causal=causal).reshape(x.shape)
        x = x + dense_stacked(a["wo"], o, dtype)
        h = ops.layernorm(x.reshape(-1, d), blk["ln2"]["scale"], blk["ln2"]["bias"], rows)
        fc1, fc2 = blk["mlp"]["fc1"], blk["mlp"]["fc2"]
        f = torch.bmm(h.reshape(s, rows, d), kernel_weight(fc1, dtype))
        g = ops.bias_gelu(f.reshape(s * rows, -1), fc1["b"], rows)
        x = x + dense_stacked(fc2, g.reshape(s, b, t, -1), dtype)
    return x


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


def transformer_block_flops(dim: int, seq: int, mlp_ratio: int = 4) -> float:
    """One transformer block over a length-``seq`` sequence (all rows):
    QKV+output projections, the two attention matmuls, and the MLP."""
    proj = 4 * dense_flops(dim, dim) * seq              # wq/wk/wv/wo
    attn = 2 * (2.0 * seq * seq * dim)                  # QK^T and AV
    mlp = (dense_flops(dim, mlp_ratio * dim)
           + dense_flops(mlp_ratio * dim, dim)) * seq
    return proj + attn + mlp


def transformer_flops_per_row(
    cfg, window: int, k: Optional[int] = None, param_dtype: str = "f32",
) -> float:
    """transformer.score: embed + causal backbone over window-1 tokens +
    the (mu, raw_sigma) head. Quantization scales only the weight matmuls;
    the attention QK^T/AV products are activation x activation and run at
    full width whatever the param_dtype."""
    t = max(1, int(window) - 1)
    wq = quant_mac_width(param_dtype) if k is not None else 1.0
    head_steps = t if k is None else max(1, min(int(k), t))
    attn = cfg.depth * 2 * (2.0 * t * t * cfg.dim)        # QK^T and AV
    mlp_ratio = 4
    weight_mm = (
        dense_flops(1, cfg.dim) * t                        # embed
        + cfg.depth * (
            4 * dense_flops(cfg.dim, cfg.dim) * t          # wq/wk/wv/wo
            + (dense_flops(cfg.dim, mlp_ratio * cfg.dim)
               + dense_flops(mlp_ratio * cfg.dim, cfg.dim)) * t
        )
        + dense_flops(cfg.dim, 2) * head_steps             # (mu, sigma)
    )
    return weight_mm * wq + attn


def vit_flops_per_image(cfg, window: int = 0) -> float:
    """vit.apply: patch embed + backbone over N+1 tokens + CLS head.
    ``window`` is ignored (frames carry no series window); the argument
    keeps the ``flops_per_row`` contract uniform across the registry."""
    del window
    n = cfg.num_patches
    patch_dim = cfg.patch_size * cfg.patch_size * cfg.channels
    return (
        dense_flops(patch_dim, cfg.dim) * n
        + cfg.depth * transformer_block_flops(cfg.dim, n + 1)
        + dense_flops(cfg.dim, cfg.num_classes)
    )
