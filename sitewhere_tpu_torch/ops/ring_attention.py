"""Ring attention: sequence-parallel exact attention over ranks — the port
of ``sitewhere_tpu/ops/ring_attention.py``.

Each rank holds one block of the sequence's queries; the key and value
blocks rotate around the ring (``Axis.ppermute_next``), and each step
combines the block's partial attention into running softmax statistics
with a log-sum-exp rescale. Exact attention; per-rank memory O(T/n).

The device function of a step is kernel KA's ring step
(``csrc/attention_ring.cu``, ``ring_step``): the reference's
``_block_attn`` (``ring_attention.py:33``) and the combine (``:81-86``) in
one launch, in place on the running ``m``, ``l`` [B, H, Tl] and ``acc``
[B, H, Tl, hd], and on the last step the output ``acc / max(l, 1e-30)``
as [B, Tl, H, hd] (``:92-93``). ``ring_step_plain`` is its plain version:
``block_attn_plain`` (``_block_attn``) and the combine in torch ops.

Numerics kept from the reference: the mask sentinel is the finite
``NEG_INF = -1e30``, not -inf (a fully masked row has max -1e30, p forced
to 0, l = 0, acc = 0; with -inf, ``exp(m - m_new)`` is NaN); the logits
are the f32 q.k product DIVIDED by ``sqrt(hd)`` rounded to the input
dtype, which is what the reference's ring computes as its tests and the
multi-device dry run call it (eagerly under ``shard_map``; a ``jit`` would
fold the division into a product, as ``models.common.attn_core``'s
comment says of the blocks).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from sitewhere_tpu_torch import kernels

NEG_INF = -1e30
RING_MAX_HD = 256  # the ring step kernel's widest head (csrc/attention_ring.cu)
# why the kernel takes f32 only and head dims 1..256
RING_LIMITS = ("the ring step kernel takes float32 q, k, v, m, l, acc (the reference's "
               "backbone feeds f32, transformer.py:108-110) and head dims 1..256; other "
               "dtypes and wider heads are open kernel work (ROADMAP queue 2)")


def _divisor(d: int, like: torch.Tensor) -> torch.Tensor:
    """``sqrt(d)`` as the reference divides by it: rounded to the logits'
    dtype, a tensor on their device (a true division on every device;
    torch's CUDA division by a host scalar multiplies by its reciprocal)."""
    return torch.tensor(math.sqrt(d), dtype=like.dtype, device=like.device)


def ring_mask(tq: int, tk: int, q_off: int, k_off: int, causal: bool, device) -> torch.Tensor:
    """The block's mask [Tq, Tk] (True = attend) at global offsets: causal
    ``q_pos >= k_pos``, else all True (``ring_attention.py:72-77``)."""
    if not causal:
        return torch.ones((tq, tk), dtype=torch.bool, device=device)
    q_pos = q_off + torch.arange(tq, device=device)
    k_pos = k_off + torch.arange(tk, device=device)
    return q_pos[:, None] >= k_pos[None, :]


def block_attn_plain(q, k, v, mask):
    """One (Q-block x K-block) partial attention, ``_block_attn``: q [B,
    Tq, H, D], k/v [B, Tk, H, D], mask [Tq, Tk] -> (the masked logits' row
    max m [B, H, Tq], the partial sum l, the partial numerator acc [B, H,
    Tq, D]). Masked logits take the sentinel ``NEG_INF``."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / _divisor(q.shape[-1], q)
    s = torch.where(mask[None, None], s, NEG_INF)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    p = torch.where(mask[None, None], p, 0.0)
    return m, p.sum(-1), torch.einsum("bhqk,bkhd->bhqd", p, v)


def finish_plain(acc: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """The ring's output from its statistics: ``acc / max(l, 1e-30)`` as
    [B, Tl, H, D] (``ring_attention.py:92-93``)."""
    return (acc / torch.clamp_min(l, 1e-30)[..., None]).permute(0, 2, 1, 3)


def ring_step_plain(q, k, v, m, l, acc, q_off: int, k_off: int, causal: bool,
                    out: Optional[torch.Tensor] = None):
    """Plain version of KA's ring step: ``block_attn_plain`` of q against the
    arriving k, v at global offsets ``q_off``, ``k_off`` and the running
    log-sum-exp combine (``ring_attention.py:81-86``), IN PLACE on m, l,
    acc; with ``out`` [B, Tq, H, D] (the last step) also the output."""
    mask = ring_mask(q.shape[1], k.shape[1], q_off, k_off, causal, q.device)
    bm, bl, bacc = block_attn_plain(q, k, v, mask)
    m_new = torch.maximum(m, bm)
    r_old, r_blk = torch.exp(m - m_new), torch.exp(bm - m_new)
    l.copy_(l * r_old + bl * r_blk)
    acc.copy_(acc * r_old[..., None] + bacc * r_blk[..., None])
    m.copy_(m_new)
    if out is not None:
        out.copy_(finish_plain(acc, l))


def _check_step(q, k, v, m, l, acc, out) -> None:
    b, tq, h, d = q.shape
    if any(t.dtype != torch.float32 for t in (q, k, v, m, l, acc)) or not 1 <= d <= RING_MAX_HD:
        raise NotImplementedError(f"KA's ring step on CUDA: {RING_LIMITS}; got {q.dtype}, hd {d}")
    tk = k.shape[1]
    if k.shape != (b, tk, h, d) or v.shape != k.shape:
        raise ValueError(f"k, v must be [B, Tk, H, D] beside q {tuple(q.shape)}, got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    for name, t, shape in (("m", m, (b, h, tq)), ("l", l, (b, h, tq)),
                           ("acc", acc, (b, h, tq, d)), ("out", out, (b, tq, h, d))):
        if t is not None and (tuple(t.shape) != shape or not t.is_contiguous()
                              or t.device != q.device):
            raise ValueError(f"{name} must be a contiguous f32{list(shape)} on {q.device} "
                             f"(updated in place), got {t.dtype}{list(t.shape)}")
    if out is not None and out.dtype != torch.float32:
        raise NotImplementedError(f"KA's ring step on CUDA: {RING_LIMITS}; got out {out.dtype}")


def ring_step(q, k, v, m, l, acc, q_off: int, k_off: int, causal: bool,
              out: Optional[torch.Tensor] = None) -> None:
    """Kernel KA's ring step (``csrc/attention_ring.cu``): one launch per
    ring step, ``ring_step_plain``'s function in place on m, l, acc (and
    ``out`` on the last step). CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise (f32 and head dims 1..256 only,
    ``RING_LIMITS``)."""
    if not q.is_cuda:
        return ring_step_plain(q, k, v, m, l, acc, q_off, k_off, causal, out)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    _check_step(q, k, v, m, l, acc, out)
    b, tq, h, d = q.shape
    p = kernels.ptr
    kernels.launch("attention_ring", p(q), p(k), p(v), p(m), p(l), p(acc), p(out), b, tq,
                   k.shape[1], h, d, int(q_off), int(k_off), int(causal),
                   kernels.stream_handle(q.device))
    return None


def ring_attention_local(q, k, v, axis, causal: bool = True, step: Callable = ring_step):
    """The per-rank body: q, k, v [B, Tl, H, D] this rank's blocks of the
    sequence -> [B, Tl, H, D], exact attention over the FULL sequence. The
    ring runs ``axis.size`` steps, each ``step`` (``ring_step`` or
    ``ring_step_plain``) on the arriving block from ``(rank - s) mod n``,
    then K/V rotate to the next rank; the last step writes the output."""
    n, my = axis.size, axis.rank
    b, tl, h, d = q.shape
    m = torch.full((b, h, tl), NEG_INF, dtype=q.dtype, device=q.device)
    l = torch.zeros((b, h, tl), dtype=q.dtype, device=q.device)
    acc = torch.zeros((b, h, tl, d), dtype=q.dtype, device=q.device)
    out = torch.empty((b, tl, h, d), dtype=q.dtype, device=q.device)
    k_cur, v_cur = k, v
    for s in range(n):
        src = (my - s) % n  # the block arriving at step s started s hops behind
        step(q, k_cur, v_cur, m, l, acc, my * tl, src * tl, causal,
             out if s == n - 1 else None)
        if s < n - 1:
            k_cur, v_cur = axis.ppermute_next(k_cur, v_cur)
    return out


def ring_attention(q, k, v, axis, causal: bool = True, step: Callable = ring_step):
    """q, k, v [B, T, H, D] global arrays (T divisible by the axis size):
    each rank takes its block of the sequence, runs the ring, and every
    rank returns the global result [B, T, H, D]."""
    blocks = [axis.block(x, 1).contiguous() for x in (q, k, v)]
    return axis.all_gather(ring_attention_local(*blocks, axis, causal, step), 1)


def full_attention_reference(q, k, v, causal: bool = True):
    """Single-device exact attention, the numerics oracle
    (``ring_attention.py:110``): q, k, v [B, T, H, D] -> [B, T, H, D]."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / _divisor(q.shape[-1], q)
    if causal:
        t = q.shape[1]
        mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=q.device))
        s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.softmax(s, -1)
    return torch.einsum("bhqk,bkhd->bhqd", p, v).permute(0, 2, 1, 3)
