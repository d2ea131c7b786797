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

import functools
import math
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

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
    ``ops.adam.AdamState`` of tensors on ``device``, count i32. ``optax.adam``'s
    chain state ``(ScaleByAdamState, EmptyState())`` -> ``(AdamState,
    ops.adam.EmptyState())``, the state of ``ops.adam.adam(lr)``."""
    from sitewhere_tpu_torch.ops.adam import AdamState, EmptyState

    if len(state) == 2 and len(state[1]) == 0:
        return (opt_state_from_numpy(state[0], device), EmptyState())
    count, mu, nu = state
    count = torch.from_numpy(np.array(count, dtype=np.int32, copy=True)).to(device)
    return AdamState(count, params_from_numpy(mu, device), params_from_numpy(nu, device))


def opt_state_to_numpy(state):
    """The port's ``AdamState`` -> an ``AdamState`` of numpy arrays (count
    i32), the layout ``opt_state_from_numpy`` takes; ``adam(lr)``'s chain
    state -> ``(AdamState of numpy, EmptyState())``."""
    from sitewhere_tpu_torch.ops.adam import AdamState, EmptyState

    if len(state) == 2 and len(state[1]) == 0:
        return (opt_state_to_numpy(state[0]), EmptyState())
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
    storage this is the dequant ``qw * scale`` at that dtype (KQ's plain
    version). bf16 storage is a cast, exact."""
    qw = p.get("qw")
    if qw is not None:
        return dequant_plain(qw, p["scale"], dtype)
    return p["w"].to(dtype)


def dequant_weight(p: Params, dtype) -> torch.Tensor:
    """``kernel_weight`` as the kernel paths read it: an int8 node on CUDA
    tensors through KQ (``dequant``), everything else as ``kernel_weight``.
    The plain versions read ``kernel_weight``, so a plain twin on the card
    launches no kernel."""
    qw = p.get("qw")
    if qw is not None and qw.is_cuda:
        return dequant(qw, p["scale"], dtype)
    return kernel_weight(p, dtype)


def dequant_plain(qw, scale, dtype) -> torch.Tensor:
    """Plain version of KQ: ``qw.to(dtype) * scale.to(dtype)``, one rounding
    (|q| <= 127 is exact in bf16)."""
    return qw.to(dtype) * scale.to(dtype)


def dequant(qw, scale, dtype) -> torch.Tensor:
    """Kernel KQ (``csrc/dequant.cu``): an int8 weight qw [S, I, O] (or [I,
    O]) with its f32 scales [S, 1, O] -> [S, I, O] in ``dtype`` (bfloat16 or
    float32), bitwise ``dequant_plain``."""
    if not qw.is_cuda:
        return dequant_plain(qw, scale, dtype)
    if qw.dtype != torch.int8 or qw.ndim not in (2, 3) or dtype not in ACT_KINDS:
        raise TypeError(f"KQ takes int8 [S, I, O] or [I, O] weights to bf16/f32, got "
                        f"{qw.dtype}{list(qw.shape)} to {dtype}")
    qw = qw.contiguous()
    s = qw.shape[0] if qw.ndim == 3 else 1
    i, o = qw.shape[-2:]
    scale = scale.to(torch.float32).contiguous()
    if scale.numel() != s * o:
        raise ValueError(f"KQ takes scales f32[{s}, 1, {o}], got {list(scale.shape)}")
    out = torch.empty(qw.shape, dtype=dtype, device=qw.device)
    p = kernels.ptr
    kernels.launch("dequant", p(qw), p(scale), p(out), s, i, o, ACT_KINDS[dtype],
                   kernels.stream_handle(qw.device), variant=f"int8->{str(dtype)[6:]}")
    return out


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


def dense_stacked(p: Params, x: torch.Tensor, dtype=torch.bfloat16,
                  weight: Callable = kernel_weight) -> torch.Tensor:
    """Weight-stacked dense: x [S, ..., I] x w [S, I, O] -> [S, ..., O] as
    one batched matmul over the slot dim, with ``dense``'s two roundings;
    ``weight`` reads the kernel (``dequant_weight`` on the kernel paths)."""
    w = weight(p, dtype)
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


def _gelu_parts(y: torch.Tensor):
    """``gelu``'s tanh and cdf (and its two constants, cast to y's dtype):
    the forward's values KU's backward reads."""
    c = torch.tensor(math.sqrt(2 / math.pi), dtype=y.dtype, device=y.device)
    k = torch.tensor(0.044715, dtype=y.dtype, device=y.device)
    th = torch.tanh(c * (y + k * (y * y * y)))
    return th, 0.5 * (1.0 + th), c, k


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (``approximate=True``, the tanh form) as XLA lowers
    it: ``x * (0.5 * (1 + tanh(c * (x + k * x**3))))`` with ``c =
    sqrt(2/pi)`` and ``k = 0.044715`` cast to the input dtype and ``x**3``
    as ``(x * x) * x``, every op rounded in that dtype.
    ``F.gelu(x, approximate="tanh")`` computes in f32 and rounds once."""
    return x * _gelu_parts(x)[1]


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
ATTN_HEAD_DIMS = (32, 64)  # the staged KA's head widths: the transformer family's and ViT-B/16's
ATTN_MAX_T = 512           # the longest sequence the staged KA takes (transformer.py:12)
ATTN_TILED_MAX_HD = 256    # the tiled KA's widest head (csrc/attention_tiled*.cu)
ATTN_SPLIT_CHUNK = 256     # the split KA's f32 column chunk, a block each (csrc/attention_split.cuh)
ATTN_SPLIT_ROWS = 64       # the bf16 split KA's tile rows (attention_split.cuh ka_split_tc::kRows)
ATTN_SPLIT_DEPTH = 64      # ... and the columns of its depth chunk (kDC)
KA_WARPS = 4               # csrc/attention.cu, attention_bwd.cu kWarps (the f32 instance)
ATTN_STAGED_ROWS = 64      # the bf16 staged KA's tile rows (attention_staged.cuh kRows)
ATTN_STAGED_WG = 2         # ... and its warpgroups a block (kWG)


def attn_staged_plan(t: int, hd: int) -> dict:
    """The launch geometry of the bf16 staged KA (``csrc/attention.cu``,
    ``attention_bwd.cu``) for sequences of ``t`` tokens at head dim ``hd``
    (32 or 64), as ``csrc/attention_staged.cuh`` (``ka_staged_tc::plan``)
    computes it. T <= 64, packed: a 64-row tile holds ``items_per_tile``
    (sequence, head) items of ``rows_per_item`` rows, a block
    ``warpgroups`` tiles of consecutive items (``items_per_block``), two
    stages of them in shared memory. Past it, staged: a block an item, its
    ``query_tiles`` 64-row tiles shared by the ``warpgroups``, its rows in
    shared memory once (the backward's V to a multiple of 8 rows, Q, K and
    dout to a multiple of 64, then 16 bytes of row statistics a row).
    ``fwd_smem``, ``bwd_smem``: each direction's dynamic shared memory."""
    rows, wg = ATTN_STAGED_ROWS, ATTN_STAGED_WG
    tile = rows * hd * 2  # a bf16 tile of 64 rows
    if t <= rows:
        lg = 3
        while (1 << lg) < t:
            lg += 1
        return dict(packed=True, rows_per_item=1 << lg, items_per_tile=rows >> lg,
                    items_per_block=wg * (rows >> lg), query_tiles=1, warpgroups=wg,
                    fwd_kernel="attention_staged_pack_tc",
                    bwd_kernel="attention_staged_bwd_pack_tc",
                    fwd_smem=2 * 3 * wg * tile,
                    bwd_smem=2 * 4 * wg * tile + 2 * wg * rows * rows * 2)
    r64, r8 = -(-t // 64) * 64, -(-t // 8) * 8
    return dict(packed=False, rows_per_item=r64, items_per_tile=1, items_per_block=1,
                query_tiles=r64 // rows, warpgroups=wg,
                fwd_kernel="attention_staged_tc", bwd_kernel="attention_staged_bwd_tc",
                fwd_smem=3 * r64 * hd * 2, bwd_smem=(r8 + 3 * r64) * hd * 2 + 16 * r64)


def attn_staged_variant(dtype: torch.dtype, hd: int, t: int) -> str:
    """The staged KA's launch variant (``kernels.variant_launches``):
    "bf16,pack,hd32" etc. (``attn_staged_plan``'s form) or "f32,hd64"."""
    if dtype != torch.bfloat16:
        return f"f32,hd{hd}"
    return f"bf16,{'pack' if t <= ATTN_STAGED_ROWS else 'staged'},hd{hd}"


def attn_smem_bytes(backward: bool, dtype: torch.dtype, hd: int, t: int) -> int:
    """The dynamic shared memory the staged KA's kernel takes for ``t``
    tokens: bf16, ``attn_staged_plan``'s; f32, one (sequence, head)'s
    ``smem_bytes`` of ``csrc/attention.cu`` (K rows padded by one 32-bit
    word, V, each warp's query and logit rows in f32) or of
    ``csrc/attention_bwd.cu`` (Q, K, V and dout rows padded likewise, the
    rows' max, sum and Sigma term, each warp's f32 rows)."""
    if dtype == torch.bfloat16:
        return attn_staged_plan(t, hd)["bwd_smem" if backward else "fwd_smem"]
    size = torch.tensor([], dtype=dtype).element_size()
    stride = hd + 4 // size
    if backward:
        mats = 4 * t * stride * size
        return -(-mats // 16) * 16 + (KA_WARPS * (2 * hd + 3 * t) + 3 * t) * 4
    kv = t * (stride + hd) * size
    return -(-kv // 16) * 16 + KA_WARPS * (hd + t) * 4


@functools.lru_cache(maxsize=None)
def attn_max_t(backward: bool, dtype: torch.dtype, hd: int) -> int:
    """The longest sequence the staged KA (forward or backward) takes at
    ``dtype`` and head dim ``hd``: ``ATTN_MAX_T`` or the last T whose staged
    rows fit ``kernels.SMEM_MAX_BYTES``. f32 hd 64: 435 forward, 209 backward; bf16
    hd 64 backward 416; f32 hd 32 backward 393; the others 512. Longer
    sequences go to the tiled KA (``attn_route``). Cached: every launch's
    route reads it."""
    t = ATTN_MAX_T
    while t > 0 and attn_smem_bytes(backward, dtype, hd, t) > kernels.SMEM_MAX_BYTES:
        t -= 1
    return t


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


def attn_route(backward: bool, dtype: torch.dtype, hd: int, t: int) -> str:
    """Which form of KA takes a shape, decided before any launch: "staged"
    (``csrc/attention.cu``, ``attention_bwd.cu``: head dims 32 and 64, T up
    to ``attn_max_t``, every shape it took before the tiled form),
    "tiled" (``csrc/attention_tiled.cu``, ``attention_tiled_bwd.cu``: head
    dims 1 to 256, any T, every other shape it took before the split form)
    or "split" (``csrc/attention_split.cu``, ``attention_split_bwd.cu``:
    head dims past 256, any T)."""
    if hd in ATTN_HEAD_DIMS and 1 <= t <= attn_max_t(backward, dtype, hd):
        return "staged"
    return "tiled" if hd <= ATTN_TILED_MAX_HD else "split"


def _check_tiled_head(hd: int) -> None:
    if not 1 <= hd <= ATTN_TILED_MAX_HD:
        raise ValueError(f"KA's tiled form takes head dims 1..{ATTN_TILED_MAX_HD}, got hd={hd} "
                         "(attn_route sends wider heads to the split form)")


def _check_attention(label: str, q, k, v, heads: int) -> int:
    n, t, d = q.shape
    if q.dtype not in ACT_KINDS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{label} takes float32 or bfloat16 q, k, v of one dtype, got {q.dtype}")
    if k.shape != q.shape or v.shape != q.shape or d % heads or t < 1:
        raise ValueError(f"{label} takes q, k, v of one shape [N, T, heads*hd], got {q.shape}")
    return d // heads


def attention(q, k, v, heads: int, causal: bool) -> torch.Tensor:
    """Kernel KA: ``attn_core`` over q, k, v [N, T, D] as the projections
    produce them, heads split by column; the staged form
    (``csrc/attention.cu``: bf16 on tensor cores, ``attn_staged_plan``; f32
    on CUDA cores), the tiled one (``attention_tiled``) or the split one
    (``attention_split``) by ``attn_route``."""
    if not q.is_cuda:
        return attention_plain(q, k, v, heads, causal)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    hd = _check_attention("KA", q, k, v, heads)
    n, t, _ = q.shape
    route = attn_route(False, q.dtype, hd, t)
    if route == "tiled":
        return attention_tiled(q, k, v, heads, causal)
    if route == "split":
        return attention_split(q, k, v, heads, causal)
    out = torch.empty_like(q)
    p = kernels.ptr
    kernels.launch(
        "attention", p(q), p(k), p(v), p(out), n, t, heads, hd, int(causal),
        ACT_KINDS[q.dtype], kernels.stream_handle(q.device),
        variant=attn_staged_variant(q.dtype, hd, t),
    )
    return out


def attention_tiled(q, k, v, heads: int, causal: bool) -> torch.Tensor:
    """KA's tiled form (``csrc/attention_tiled.cu``) at any head dim up to
    256 and any T: outputs as ``attention_plain``. ``attention`` sends it
    the shapes the staged form does not take; called directly it takes
    those too (to time the two forms side by side)."""
    if not q.is_cuda:
        return attention_plain(q, k, v, heads, causal)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    hd = _check_attention("KA (tiled)", q, k, v, heads)
    _check_tiled_head(hd)
    n, t, _ = q.shape
    out = torch.empty_like(q)
    p = kernels.ptr
    kernels.launch(
        "attention_tiled", p(q), p(k), p(v), p(out), n, t, heads, hd, int(causal),
        ACT_KINDS[q.dtype], kernels.stream_handle(q.device),
    )
    return out


def attn_split_plan(t: int, hd: int) -> dict:
    """The launch geometry of KA's bf16 split kernels for sequences of
    ``t`` tokens at head dim ``hd`` on 16-byte aligned tensors, as
    ``csrc/attention_split.cuh`` (``ka_split_tc::plan``) and the launchers
    compute it: a tile of 64 rows packs ``items_per_block`` (sequence, head)
    items of ``rows_per_item`` rows (T <= 64), else one item's 64 rows of
    ``tiles``; the head dim streams in ``depth_chunks`` of 64 columns,
    ``copy_bytes`` a copy (16, 8, 4; 2: element by element); each kernel's
    dynamic shared memory (its ring, then its bf16 p / dl caches: every
    tile of the item while they fit ``kernels.SMEM_MAX_BYTES``, else one,
    recomputed: ``*_resident`` False); the backward one fused kernel at one
    tile, else the dq and dk/dv kernels."""
    rows = ATTN_SPLIT_ROWS
    if t <= rows:
        lg = 3
        while (1 << lg) < t:
            lg += 1
        tiles = 1
    else:
        lg, tiles = 6, -(-t // rows)
    tile = rows * ATTN_SPLIT_DEPTH * 2  # a bf16 64 x 64 tile
    fwd_ring, bwd_ring = 4 * 2 * tile, 2 * 4 * tile  # stages x tiles a stage

    def cached(fixed: int, per: int) -> int:
        return tiles if fixed + tiles * per * tile <= kernels.SMEM_MAX_BYTES else 1

    copy = 16
    while copy > 2 and (2 * hd) % copy:
        copy //= 2
    plan = dict(rows_per_item=1 << lg, items_per_block=rows >> lg, tiles=tiles,
                depth_chunks=-(-hd // ATTN_SPLIT_DEPTH), copy_bytes=copy,
                fwd_smem=fwd_ring + cached(fwd_ring, 1) * tile,
                fwd_resident=cached(fwd_ring, 1) == tiles)
    if tiles == 1:
        # two stages of three tiles (four 64 x 32 chunks, or three 64 x 64),
        # then p^T, dl^T and dl
        plan.update(bwd_kernels=("attention_split_bwd_tc",), bwd_smem=(2 * 3 * tile + 3 * tile,),
                    bwd_resident=(True,))
    else:
        c1, c2 = cached(bwd_ring, 1), cached(bwd_ring, 2)
        plan.update(bwd_kernels=("attention_split_dq_tc", "attention_split_dkv_tc"),
                    bwd_smem=(bwd_ring + c1 * tile, bwd_ring + 2 * c2 * tile),
                    bwd_resident=(c1 == tiles, c2 == tiles))
    return plan


def _split_launch(name: str, tensors, q, heads: int, hd: int, causal: bool) -> None:
    if heads * -(-hd // ATTN_SPLIT_CHUNK) > 65535:
        raise ValueError(f"KA's split form takes heads x column chunks up to 65,535, got "
                         f"{heads} x {-(-hd // ATTN_SPLIT_CHUNK)}")
    n, t, _ = q.shape
    p = kernels.ptr
    kernels.launch(name, *(p(x) for x in tensors), n, t, heads, hd, int(causal),
                   ACT_KINDS[q.dtype], kernels.stream_handle(q.device))


def attention_split(q, k, v, heads: int, causal: bool) -> torch.Tensor:
    """KA's split form (``csrc/attention_split.cu``) at any head dim, any
    T, outputs as ``attention_plain``: bf16 on tensor cores (a block a
    64-row query tile with all its output columns, the head dim streamed in
    64-column chunks: ``attn_split_plan``), f32 on CUDA cores (the output
    columns in chunks of 256, a block each, every block's logits over the
    full head dim). ``attention`` sends it head dims past 256; called
    directly it takes any (to time it beside the tiled form)."""
    if not q.is_cuda:
        return attention_plain(q, k, v, heads, causal)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    hd = _check_attention("KA (split)", q, k, v, heads)
    out = torch.empty_like(q)
    _split_launch("attention_split", (q, k, v, out), q, heads, hd, causal)
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


def has_int8(params: Params) -> bool:
    """Whether a param tree holds an int8 dense node (``qw`` and ``scale``,
    no ``w``: ``quantize_params(..., "int8")``)."""
    if isinstance(params, dict):
        return "qw" in params or any(has_int8(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return any(has_int8(v) for v in params)
    return False


def check_kernel_params(params: Params, cfg, label: str, masters_only: str = "") -> None:
    """A kernel path computes in bf16/f32. With ``masters_only`` (the
    reason) it also reads f32 master weights only, and a bf16/int8 tree
    raises; the transformer's serving paths read every format
    (``quantize_params``'s) and pass none."""
    if cfg.compute_dtype not in ACT_KINDS:
        raise NotImplementedError(f"{label} computes in bfloat16 or float32, not {cfg.dtype}")
    if not masters_only:
        return
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
            f"{label} reads float32 master weights (param_dtype='f32'): {masters_only}")


def _block(blk, x: torch.Tensor, heads: int, causal: bool, dtype, ops,
           saved: Optional[list] = None, reduce: Optional[Callable] = None) -> torch.Tensor:
    """One pre-LN block of ``blocks_stacked`` over x [S, B, T, D] -> the
    block's output. With ``saved`` given, appends what the block's
    backward reads: the input, ln1's output, q, k, v [S*B, T, D], the
    attention output, the residual after attention, ln2's output, fc1's
    product (before its bias) and the GELU output. Without it, each
    intermediate is dropped as soon as the block is past it. ``reduce``
    (the tensor-parallel block's psum, ``transformer_block_tp``) takes the
    wo and fc2 products before their residual adds; the block's params
    may then hold a rank's slice of the heads and the MLP hidden."""
    s, b, t, d = x.shape
    rows = b * t  # rows of D per slot
    a = blk["attn"]
    h = ops.layernorm(x.reshape(-1, d), blk["ln1"]["scale"], blk["ln1"]["bias"], rows)
    h = h.reshape(x.shape)
    q, k, v = (dense_stacked(a[n], h, dtype, ops.weight).reshape(s * b, t, -1)
               for n in ("wq", "wk", "wv"))
    o = ops.attention(q, k, v, heads, causal=causal).reshape(s, b, t, -1)
    if saved is not None:
        saved.append((x, h, q, k, v, o))
    y = dense_stacked(a["wo"], o, dtype, ops.weight)
    x = x + (y if reduce is None else reduce(y))
    h = ops.layernorm(x.reshape(-1, d), blk["ln2"]["scale"], blk["ln2"]["bias"], rows)
    fc1, fc2 = blk["mlp"]["fc1"], blk["mlp"]["fc2"]
    f = torch.bmm(h.reshape(s, rows, d), ops.weight(fc1, dtype))
    g = ops.bias_gelu(f.reshape(s * rows, -1), fc1["b"], rows)
    if saved is not None:
        saved[-1] += (x, h, f, g)
    y = dense_stacked(fc2, g.reshape(s, b, t, -1), dtype, ops.weight)
    return x + (y if reduce is None else reduce(y))


def blocks_stacked(blocks, x: torch.Tensor, heads: int, causal: bool, dtype, ops) -> torch.Tensor:
    """The pre-LN blocks over tokens x [S, B, T, D] with per-slot block
    params ([S, ...] leaves) -> the final residual stream: each block
    ``transformer_block_stacked`` through ``ops.layernorm`` (KL: ln1, ln2),
    ``ops.attention`` (KA) and ``ops.bias_gelu`` (KU), the kernels'
    wrappers or their plain versions (a family's ops tuple). The
    projections are batched matmuls over the slot dim on the weights
    ``ops.weight`` reads (KQ for int8 on the kernel path) with the bias add in
    the compute dtype; fc1's bias add belongs to KU; the residual adds are
    the reference's adds in the compute dtype. The transformer family runs
    it causal over S slots, ViT non-causal over one slot (its params as
    views with a leading dim of 1)."""
    for blk in blocks:
        x = _block(blk, x, heads, causal, dtype, ops)
    return x


def block_stage(blk: Params, x: torch.Tensor, heads: int, ops, causal: bool = False,
                dtype=torch.bfloat16) -> torch.Tensor:
    """One block (a single block's params) over x [B, T, D]: the kernel
    block, ``blocks_stacked`` on one slot through a family's ``ops``
    (``vit.KERNEL_OPS`` for the kernels). A pipeline stage's function
    (``ops.pipeline_parallel``), as the reference's stages run
    ``transformer_block``."""
    one = tree_map(lambda a: a[None], blk)
    return blocks_stacked([one], x[None], heads, causal, dtype, ops)[0]


# -- tensor parallelism (Megatron-style; the reference's models/common.py:528
# shard_block_params_tp, :574 transformer_block_tp): column-parallel q/k/v and
# fc1 (each rank owns heads/n heads and hidden/n MLP units), row-parallel wo
# and fc2 with one psum each, two collectives a block, over an ``Axis``
# (parallel/dist.py) -------------------------------------------------------------

def shard_block_params_tp(blk: Params, n: int, idx: int) -> Params:
    """One block's params for tensor-parallel rank ``idx`` of ``n``:
    column-parallel weights (wq, wk, wv, fc1 and their biases) split on
    the output dim, row-parallel ones (wo, fc2) on the input dim with the
    bias on rank 0 only (zeros elsewhere: it is added once across the
    psum). Every split dim must divide by ``n``."""
    dim = blk["attn"]["wq"]["w"].shape[1]
    hidden = blk["mlp"]["fc1"]["w"].shape[1]
    if dim % n or hidden % n:
        raise ValueError(f"TP degree {n} must divide model dim {dim} and MLP hidden {hidden}")

    def col(p):
        o = p["w"].shape[1] // n
        return {"w": p["w"][:, idx * o:(idx + 1) * o].contiguous(),
                "b": p["b"][idx * o:(idx + 1) * o].contiguous()}

    def row(p):
        i = p["w"].shape[0] // n
        return {"w": p["w"][idx * i:(idx + 1) * i].contiguous(),
                "b": p["b"] if idx == 0 else torch.zeros_like(p["b"])}

    a, mlp_p = blk["attn"], blk["mlp"]
    return {
        "ln1": blk["ln1"],
        "ln2": blk["ln2"],
        "attn": {"wq": col(a["wq"]), "wk": col(a["wk"]), "wv": col(a["wv"]), "wo": row(a["wo"])},
        "mlp": {"fc1": col(mlp_p["fc1"]), "fc2": row(mlp_p["fc2"])},
    }


def transformer_block_tp(p: Params, x: torch.Tensor, heads: int, axis, ops,
                         causal: bool = False, dtype=torch.bfloat16) -> torch.Tensor:
    """The tensor-parallel block over replicated activations x [B, T, D]
    with a rank's params (``shard_block_params_tp``); ``heads`` is the
    GLOBAL head count (each rank runs heads / n). ``_block`` at the local
    heads with ``axis.psum`` on the wo and fc2 products."""
    if heads % axis.size:
        raise ValueError(f"TP degree {axis.size} must divide head count {heads}")
    one = tree_map(lambda a: a[None], p)
    return _block(one, x[None], heads // axis.size, causal, dtype, ops, reduce=axis.psum)[0]


# -- the blocks' train form: the backward kernels KL, KA, KU and their plain
# versions, and the composition that walks the blocks in reverse ------------
#
# Each plain version follows the reference's grad jaxpr (``jax.vjp`` of the
# function it differentiates) in its rounding points; the kernels
# (``csrc/layernorm_bwd.cu``, ``attention_bwd.cu``, ``bias_gelu_bwd.cu``)
# are held against them. Per-slot parameter gradients come out f32; where
# the reference computes one as a bf16 dot or reduction (the dense layers'
# weights and biases, fc1's bias in KU) it is rounded to the compute dtype
# once and widened, as the reference's cast to the f32 param widens it.

KL_BWD_TILE_ROWS = 512   # csrc/layernorm_bwd.cu kTileRows
KU_BWD_TILE_ROWS = 256   # csrc/bias_gelu_bwd.cu kTileRows


def _tiles(rows: int, per_tile: int) -> int:
    return (rows + per_tile - 1) // per_tile


def layernorm_bwd_plain(x, scale, dy, rows_per_slot: int):
    """Plain version of KL's backward: rows x [N, D] and the output's
    cotangent dy [N, D] in the compute dtype, per-slot scale f32 [S, D] ->
    (dx [N, D] in x's dtype, dscale, dbias [S, D] in f32). The f32
    backward of ``layernorm_stacked`` in the reference's grad jaxpr's order:
    ``dx = (dcd + t2) + ((-sum(dcd)) + (-sum(t2))) / D`` with ``dcd = dy *
    scale * r`` and ``t2 = c * (dvar * 2 / D)``, ``dvar = sum(c * dy *
    scale) * ((r / (var + eps)) * -0.5)``."""
    n, d = x.shape
    wd = wide(x.dtype)
    xf = x.to(wd).reshape(-1, rows_per_slot, d)
    g = dy.to(wd).reshape(xf.shape)
    sc = scale.to(wd)[:, None, :]
    c = xf - xf.mean(-1, keepdim=True)
    ve = (c * c).mean(-1, keepdim=True) + 1e-5
    r = torch.rsqrt(ve)
    gy = g * sc
    dcd = gy * r
    dvar = (c * gy).sum(-1, keepdim=True) * ((r / ve) * -0.5)
    t2 = c * (dvar * (2.0 / d))
    dmean = (-dcd.sum(-1, keepdim=True) + -t2.sum(-1, keepdim=True)) * (1.0 / d)
    dx = ((dcd + t2) + dmean).to(x.dtype).reshape(n, d)
    return dx, ((c * r) * g).sum(1), g.sum(1)


def layernorm_bwd(x, scale, dy, rows_per_slot: int):
    """Kernel KL's backward (``csrc/layernorm_bwd.cu``): outputs as
    ``layernorm_bwd_plain``; the per-slot sums are deterministic (per-tile
    partials summed in a fixed order)."""
    if not x.is_cuda:
        return layernorm_bwd_plain(x, scale, dy, rows_per_slot)
    x, scale, dy = x.contiguous(), scale.contiguous(), dy.contiguous()
    _check_rows("KL's backward", x, (scale,), rows_per_slot)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError("KL's backward takes dy of x's shape and dtype")
    t_slots, d = x.shape[0] // rows_per_slot, x.shape[1]
    dx = torch.empty_like(x)
    part = torch.empty((t_slots, _tiles(rows_per_slot, KL_BWD_TILE_ROWS), 2 * d),
                       dtype=torch.float32, device=x.device)
    red = torch.empty((t_slots, 2 * d), dtype=torch.float32, device=x.device)
    p = kernels.ptr
    kernels.launch(
        "layernorm_bwd", p(x), p(scale), p(dy), p(dx), p(part), p(red), t_slots, d,
        rows_per_slot, ACT_KINDS[x.dtype], kernels.stream_handle(x.device),
    )
    return dx, red[:, :d], red[:, d:]


def _softmax_rows(q, k, causal: bool, wd):
    """The forward's logits -> (e = exp(l - max), s = sum e, the causal
    mask or None) over q, k [N, T, H, hd], as ``attn_core`` computes them."""
    t, hd = q.shape[-3], q.shape[-1]
    logits = torch.einsum("...qhd,...khd->...hqk", q, k).to(wd) * (1.0 / math.sqrt(hd))
    mask = None
    if causal:
        mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=q.device))
        logits = torch.where(mask, logits, -1e30)
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    return e, e.sum(-1, keepdim=True), mask


def attention_bwd_plain(q, k, v, dout, heads: int, causal: bool):
    """Plain version of KA's backward: q, k, v and the output's cotangent
    dout [N, T, D] -> (dq, dk, dv) [N, T, D] in their dtype. In the
    reference's grad jaxpr's order: ``dp = dout . v^T`` rounded; ``a =
    sum_k (dp * (1 / s^2)) * e``; ``dl = ((dp / s) - a) * e``, masked keys
    0, times ``1/sqrt(hd)``, rounded; ``dq = dl . k``, ``dk = dl^T . q``,
    ``dv = p^T . dout``, each rounded once; p recomputed as the forward
    computes it."""
    dtype, wd = q.dtype, wide(q.dtype)
    n, t, d = q.shape
    qh, kh, vh, oh = (_split_heads(a, heads) for a in (q, k, v, dout))
    e, s, mask = _softmax_rows(qh, kh, causal, wd)
    p = (e / s).to(dtype)
    dv = torch.einsum("...hqk,...qhd->...khd", p, oh)
    dp = torch.einsum("...qhd,...khd->...hqk", oh, vh).to(wd)
    a = ((dp * (1 / (s * s))) * e).sum(-1, keepdim=True)
    dl = (dp / s - a) * e
    if mask is not None:
        dl = torch.where(mask, dl, 0.0)
    dl = (dl * (1.0 / math.sqrt(d // heads))).to(dtype)
    dq = torch.einsum("...hqk,...khd->...qhd", dl, kh)
    dk = torch.einsum("...hqk,...qhd->...khd", dl, qh)
    return tuple(x.reshape(n, t, d) for x in (dq, dk, dv))


def attention_bwd(q, k, v, dout, heads: int, causal: bool):
    """Kernel KA's backward: outputs as ``attention_bwd_plain``, p
    recomputed with KA's forward arithmetic; the staged form
    (``csrc/attention_bwd.cu``: bf16 on tensor cores, ``attn_staged_plan``;
    f32 on CUDA cores), the tiled one (``attention_tiled_bwd``) or the split
    one (``attention_split_bwd``) by ``attn_route``."""
    if not q.is_cuda:
        return attention_bwd_plain(q, k, v, dout, heads, causal)
    q, k, v, dout = q.contiguous(), k.contiguous(), v.contiguous(), dout.contiguous()
    hd = _check_attention("KA's backward", q, k, v, heads)
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError("KA's backward takes dout of q's shape and dtype")
    n, t, _ = q.shape
    route = attn_route(True, q.dtype, hd, t)
    if route == "tiled":
        return attention_tiled_bwd(q, k, v, dout, heads, causal)
    if route == "split":
        return attention_split_bwd(q, k, v, dout, heads, causal)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    p = kernels.ptr
    kernels.launch(
        "attention_bwd", p(q), p(k), p(v), p(dout), p(dq), p(dk), p(dv), n, t, heads, hd,
        int(causal), ACT_KINDS[q.dtype], kernels.stream_handle(q.device),
        variant=attn_staged_variant(q.dtype, hd, t),
    )
    return dq, dk, dv


def attention_tiled_bwd(q, k, v, dout, heads: int, causal: bool):
    """KA's tiled backward (``csrc/attention_tiled_bwd.cu``: a dq kernel
    that also writes each row's max, sum and Sigma term, then a dk/dv
    kernel over key tiles) at any head dim up to 256 and any T: outputs as
    ``attention_bwd_plain``, deterministic (no atomics)."""
    if not q.is_cuda:
        return attention_bwd_plain(q, k, v, dout, heads, causal)
    q, k, v, dout = q.contiguous(), k.contiguous(), v.contiguous(), dout.contiguous()
    hd = _check_attention("KA's backward (tiled)", q, k, v, heads)
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError("KA's backward takes dout of q's shape and dtype")
    _check_tiled_head(hd)
    n, t, _ = q.shape
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    stats = torch.empty((n, heads, t, 3), dtype=torch.float32, device=q.device)
    p = kernels.ptr
    kernels.launch(
        "attention_tiled_bwd", p(q), p(k), p(v), p(dout), p(dq), p(dk), p(dv), p(stats), n, t,
        heads, hd, int(causal), ACT_KINDS[q.dtype], kernels.stream_handle(q.device),
    )
    return dq, dk, dv


def attention_split_bwd(q, k, v, dout, heads: int, causal: bool):
    """KA's split backward (``csrc/attention_split_bwd.cu``) at any head
    dim and T: outputs as ``attention_bwd_plain``, deterministic (no
    atomics). bf16 on tensor cores: one fused kernel where a tile holds
    every key (T <= 64), else a dq kernel that writes each row's
    statistics to ``stats`` and a dk/dv kernel (``attn_split_plan``); f32
    on CUDA cores: the tiled backward's two kernels, each split by column
    chunk."""
    if not q.is_cuda:
        return attention_bwd_plain(q, k, v, dout, heads, causal)
    q, k, v, dout = q.contiguous(), k.contiguous(), v.contiguous(), dout.contiguous()
    hd = _check_attention("KA's backward (split)", q, k, v, heads)
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError("KA's backward takes dout of q's shape and dtype")
    n, t, _ = q.shape
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    stats = torch.empty((n, heads, t, 3), dtype=torch.float32, device=q.device)
    _split_launch("attention_split_bwd", (q, k, v, dout, dq, dk, dv, stats), q, heads, hd,
                  causal)
    return dq, dk, dv


def bias_gelu_bwd_plain(x, b, dy, rows_per_slot: int):
    """Plain version of KU's backward: fc1's product x [N, F] (before its
    bias), the per-slot bias f32 [S, F] and the GELU output's cotangent dy
    [N, F] -> (dx [N, F] in x's dtype, the bias gradient f32 [S, F]). Op
    by op as the reference's grad HLO, each op rounded in the compute
    dtype: ``v8 = dy * cdf + c * (v4 + v4 * th)``, ``v4 = (0.5 * (y * dy))
    * (1 - th)``, ``dx = v8 + (k * c * (v4 + v4 * th)) * (3 * (y * y))``;
    the bias gradient the slot's column sum, accumulated in f32 and
    rounded to the compute dtype."""
    n, f = x.shape
    y = x.reshape(-1, rows_per_slot, f) + b.to(x.dtype)[:, None, :]
    g = dy.reshape(y.shape)
    th, cdf, c, k = _gelu_parts(y)
    v4 = (0.5 * (y * g)) * (1.0 - th)
    v7 = c * (v4 + v4 * th)
    dx = (g * cdf + v7) + (k * v7) * (3.0 * (y * y))
    db = dx.sum(1, dtype=wide(x.dtype)).to(x.dtype).to(wide(x.dtype))
    return dx.reshape(n, f), db


def bias_gelu_bwd(x, b, dy, rows_per_slot: int):
    """Kernel KU's backward (``csrc/bias_gelu_bwd.cu``): outputs as
    ``bias_gelu_bwd_plain``; the bias gradient's sums are deterministic."""
    if not x.is_cuda:
        return bias_gelu_bwd_plain(x, b, dy, rows_per_slot)
    x, b, dy = x.contiguous(), b.contiguous(), dy.contiguous()
    _check_rows("KU's backward", x, (b,), rows_per_slot)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError("KU's backward takes dy of x's shape and dtype")
    t_slots, f = x.shape[0] // rows_per_slot, x.shape[1]
    dx = torch.empty_like(x)
    part = torch.empty((t_slots, _tiles(rows_per_slot, KU_BWD_TILE_ROWS), f),
                       dtype=torch.float32, device=x.device)
    db = torch.empty((t_slots, f), dtype=torch.float32, device=x.device)
    p = kernels.ptr
    kernels.launch(
        "bias_gelu_bwd", p(x), p(b), p(dy), p(dx), p(part), p(db), t_slots, f, rows_per_slot,
        ACT_KINDS[x.dtype], kernels.stream_handle(x.device),
    )
    return dx, db


class BlockTrainOps(NamedTuple):
    """The device functions of the blocks' train form: the forward's KL,
    KA, KU and their backward kernels (wrappers, which take the plain
    version on CPU tensors), or their plain versions (the plain twin)."""
    layernorm: Callable
    layernorm_bwd: Callable
    attention: Callable
    attention_bwd: Callable
    bias_gelu: Callable
    bias_gelu_bwd: Callable
    weight: Callable = kernel_weight  # the train forms read f32 masters


BLOCK_TRAIN_KERNELS = BlockTrainOps(layernorm_rows, layernorm_bwd, attention, attention_bwd,
                                    bias_gelu, bias_gelu_bwd)
BLOCK_TRAIN_PLAIN = BlockTrainOps(layernorm_rows_plain, layernorm_bwd_plain, attention_plain,
                                  attention_bwd_plain, bias_gelu_plain, bias_gelu_bwd_plain)


def blocks_train_forward(blocks, x, heads: int, causal: bool, dtype, ops: BlockTrainOps):
    """``blocks_stacked`` that also keeps what each block's backward reads:
    -> (the final residual stream, one saved tuple a block)."""
    saved: list = []
    for blk in blocks:
        x = _block(blk, x, heads, causal, dtype, ops, saved)
    return x, saved


def _dense_bwd(p: Params, x, dy, dtype):
    """The vjp of ``dense_stacked`` over x [S, R, I] with the output's
    cotangent dy [S, R, O] in the compute dtype -> (dx [S, R, I] = dy .
    w^T, rounded; {"w": x^T . dy, "b": the column sums of dy}, each
    accumulated in f32, rounded to the compute dtype once and widened to
    the f32 param's dtype)."""
    wd = wide(dtype)
    dx = torch.bmm(dy, kernel_weight(p, dtype).transpose(1, 2))
    gw = torch.bmm(x.transpose(1, 2), dy).to(wd)
    gb = dy.sum(1, dtype=wd).to(dtype).to(wd)
    return dx, {"w": gw, "b": gb}


def blocks_train_backward(blocks, saved, dx, heads: int, causal: bool, dtype,
                          ops: BlockTrainOps) -> Tuple[torch.Tensor, List[Params]]:
    """The blocks' backward, the last block first: the final residual
    stream's cotangent dx [S, B, T, D] in the compute dtype and the saves
    of ``blocks_train_forward`` -> (the tokens' cotangent, each block's
    gradients as a tree with the block params' keys). KU's, KA's and KL's
    backward kernels (``ops``) and the projections' gradients as batched
    matmuls over the slot dim (``_dense_bwd``); the residual branches'
    cotangents add in the compute dtype, as the reference's add_any; h's
    three projections' contributions add v, k, q in that order (the
    reference's transpose visits the last use first)."""
    s, b, t, d = dx.shape
    rows = b * t
    grads: List[Params] = []
    for blk, (xin, h1, q, k, v, o, xm, h2, f, g) in zip(reversed(blocks), reversed(saved)):
        a, fc1 = blk["attn"], blk["mlp"]["fc1"]
        dg, gfc2 = _dense_bwd(blk["mlp"]["fc2"], g.reshape(s, rows, -1), dx.reshape(s, rows, d),
                              dtype)
        df, gb1 = ops.bias_gelu_bwd(f.reshape(s * rows, -1), fc1["b"], dg.reshape(s * rows, -1),
                                    rows)
        df = df.reshape(s, rows, -1)
        dh2 = torch.bmm(df, kernel_weight(fc1, dtype).transpose(1, 2))
        gfc1 = {"w": torch.bmm(h2.reshape(s, rows, d).transpose(1, 2), df).to(wide(dtype)),
                "b": gb1}
        dxm, gs2, gbi2 = ops.layernorm_bwd(xm.reshape(-1, d), blk["ln2"]["scale"],
                                           dh2.reshape(-1, d), rows)
        dxm = dx + dxm.reshape(dx.shape)
        do, gwo = _dense_bwd(a["wo"], o.reshape(s, rows, d), dxm.reshape(s, rows, d), dtype)
        dq, dk, dv = ops.attention_bwd(q, k, v, do.reshape(s * b, t, d), heads, causal)
        h1r = h1.reshape(s, rows, d)
        dh1, gp = None, {}
        for name, dz in (("wv", dv), ("wk", dk), ("wq", dq)):
            dhz, gp[name] = _dense_bwd(a[name], h1r, dz.reshape(s, rows, d), dtype)
            dh1 = dhz if dh1 is None else dh1 + dhz
        dxi, gs1, gbi1 = ops.layernorm_bwd(xin.reshape(-1, d), blk["ln1"]["scale"],
                                           dh1.reshape(-1, d), rows)
        dx = dxm + dxi.reshape(dx.shape)
        grads.append({
            "ln1": {"scale": gs1, "bias": gbi1},
            "attn": {"wq": gp["wq"], "wk": gp["wk"], "wv": gp["wv"], "wo": gwo},
            "ln2": {"scale": gs2, "bias": gbi2},
            "mlp": {"fc1": gfc1, "fc2": gfc2},
        })
    grads.reverse()
    return dx, grads


def leaves_like(params, grads) -> list:
    """The leaves of ``grads`` (a tree with ``params``' keys, in any order)
    in ``tree_leaves(params)``'s order, each cast to its param's dtype."""
    if isinstance(params, dict):
        return [x for key, v in params.items() for x in leaves_like(v, grads[key])]
    if isinstance(params, (list, tuple)):
        return [x for v, gv in zip(params, grads) for x in leaves_like(v, gv)]
    return [grads.to(params.dtype)]


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
