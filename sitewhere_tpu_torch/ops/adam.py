"""Adam's moment update — the port of optax 0.2.6 ``scale_by_adam``
(``optax/_src/transform.py:246-306``, ``tree_utils/_tree_math.py:353-411``,
``_src/numerics.py:105``) with its defaults: b1 0.9, b2 0.999, eps 1e-8,
eps_root 0, no Nesterov term. The card's machine has no optax, so the port
keeps its own copy.

Two forms:

- ``scale_by_adam()`` and ``adam(lr)`` (optax's ``adam`` chain: then
  ``u * -lr``), the optax transformations over one param tree (``init`` /
  ``update`` -> (updates, state)), for the families' per-tenant
  ``train_step``: on CPU tensors through that surface, on CUDA tensors
  through ``apply_step``, which runs the step as one KO call
  (``ko_step``: every leaf a ``[1, ...]`` view, in place);
- the scorer's per-slot step over params stacked ``[T, ...]``: optax's
  update vmapped over the slots, then the train step's epilogue
  (``sitewhere_tpu/parallel/sharded.py:1168-1187``): ``p' = p - lr[t] * u``,
  and slots outside ``mask`` keep params, ``mu``, ``nu`` and ``count``
  bitwise. ``adam_update`` is its wrapper: CPU tensors take
  ``adam_update_plain``, CUDA tensors launch kernel KO
  (``csrc/adam_update.cu``), one launch over every leaf.

Both update ``p``, ``mu``, ``nu`` and ``count`` IN PLACE, where the
reference donates params and optimizer state (``sharded.py:1204``). The
per-slot bias corrections ``1 - b**count`` are computed once, in
``bias_corrections``, and KO and its plain version share them: a table of
glibc's ``powf`` (what the reference's compiled power calls on the CPU),
built on the host once and gathered by count on the counts' device, so a
step needs no host sync.

State is ``AdamState(count, mu, nu)``: ``count`` i32[T] (i32[] for one
tree), ``mu`` and ``nu`` trees shaped and typed as the params.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch

from sitewhere_tpu_torch import kernels
from sitewhere_tpu_torch.models.common import tree_leaves, tree_map

B1, B2, EPS, EPS_ROOT = 0.9, 0.999, 1e-8, 0.0
INT32_MAX = 2**31 - 1
# counts the bias-correction table holds; from there on both corrections
# are exactly 1.0 in float32 (b2**count < 2**-25 past count 17,318, and
# 1 - x rounds to 1 below that; b1 gets there far sooner)
BC_TABLE_SIZE = 1 << 15


class AdamState(NamedTuple):
    """optax's ``ScaleByAdamState``: the step count and the two moments."""

    count: Any
    mu: Any
    nu: Any


def init_adam(params, n_slots: int = 0) -> AdamState:
    """Zero moments shaped as ``params``; ``count`` i32[n_slots] for a
    stacked tree (``jax.vmap(optimizer.init)``'s layout), i32[] for
    ``n_slots=0``."""
    dev = tree_leaves(params)[0].device
    shape = (n_slots,) if n_slots else ()
    return AdamState(
        torch.zeros(shape, dtype=torch.int32, device=dev),
        tree_map(torch.zeros_like, params), tree_map(torch.zeros_like, params),
    )


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def safe_increment(count: torch.Tensor) -> torch.Tensor:
    """``numerics.safe_increment``: count + 1, saturating at the int32 max."""
    return torch.where(count < INT32_MAX, count + 1, count)


_bc_tables: Dict[str, torch.Tensor] = {}


def _powf():
    libm = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    fn = libm.powf
    fn.argtypes = [ctypes.c_float, ctypes.c_float]
    fn.restype = ctypes.c_float
    return fn


def glibc_bias_corrections(counts) -> np.ndarray:
    """``1 - b**count`` in float32 for b1 and b2 over ``counts`` (ints):
    f32[2, n]. The power is glibc's ``powf`` of the float32 decay and the
    count converted to float32, the call XLA's CPU backend emits for the
    reference's ``1 - decay**count`` (``stablehlo.power`` lowers to
    ``llvm.pow.f32``); the subtraction rounds in float32."""
    powf = _powf()
    out = np.empty((2, len(counts)), np.float32)
    for row, b in enumerate((B1, B2)):
        bf = float(np.float32(b))
        out[row] = [powf(bf, float(np.float32(c))) for c in counts]
    return np.float32(1.0) - out


def bias_correction_table(device) -> torch.Tensor:
    """f32[2, BC_TABLE_SIZE] on ``device``: ``glibc_bias_corrections`` of
    counts 0..BC_TABLE_SIZE-1, built once a device."""
    key = str(device)
    if key not in _bc_tables:
        tab = glibc_bias_corrections(range(BC_TABLE_SIZE))
        _bc_tables[key] = torch.from_numpy(tab).to(device)
    return _bc_tables[key]


def bias_corrections(count_inc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``1 - b1**count`` and ``1 - b2**count`` in float32, optax's
    ``tree_bias_correction`` at the incremented count: the table's entries
    gathered by count on the counts' device (counts past the table take
    its last entry, 1.0 for both). Bitwise the reference's compiled values
    at counts 1..200,000 (``tests/test_torch_k3.py``); float64's power
    rounded to float32, the form this replaces, missed at counts 2,958 and
    3,606 by one ulp."""
    table = bias_correction_table(count_inc.device)
    idx = count_inc.clamp(0, BC_TABLE_SIZE - 1).long()
    return table[0][idx], table[1][idx]


def fma(a, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once to float32, as a fused multiply-add
    (float64 holds the product of two float32 values exactly; the sum
    then rounds twice, which differs from one rounding only when the
    float64 sum lands exactly halfway between two float32 values)."""
    f64 = torch.float64
    return (a.to(f64) * b.to(f64) + c.to(f64)).to(torch.float32)


def _moments(g, mu, nu):
    """``(1 - b) * g**order + b * moment`` as the reference's compiled step
    evaluates it on the CPU: the first product fused with the sum (an
    FMA), the second rounded, ``g**2`` rounded."""
    mu2 = fma(_f32(1 - B1, g), g, _f32(B1, g) * mu)
    nu2 = fma(_f32(1 - B2, g), g * g, _f32(B2, g) * nu)
    return mu2, nu2


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root (torch's vectorized CPU
    ``sqrt`` is off by one ulp on ~0.7% of inputs; the float64 root rounds
    to the float32 one exactly)."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def _direction(mu2, nu2, bc1, bc2):
    """``mu_hat / (sqrt(nu_hat + eps_root) + eps)`` with ``mu_hat = mu /
    bc1``, as the reference's compiled step evaluates it: XLA folds the
    two divisions into ``mu / (bc1 * (sqrt(nu / bc2) + eps))`` (eps_root 0
    drops out)."""
    return mu2 / (bc1 * (sqrt_rn(nu2 / bc2) + _f32(EPS, mu2)))


class ScaleByAdam:
    """``optax.scale_by_adam()`` over one param tree: ``init(params)``,
    ``update(grads, state, params=None) -> (updates, state)``."""

    def init(self, params) -> AdamState:
        return init_adam(params)

    def update(self, grads, state: AdamState, params=None):
        del params
        count = safe_increment(state.count)
        bc1, bc2 = bias_corrections(count)
        mu = tree_map(lambda g, m: _moments(g, m, m)[0], grads, state.mu)
        nu = tree_map(lambda g, v: _moments(g, v, v)[1], grads, state.nu)
        updates = tree_map(lambda m, v: _direction(m, v, bc1, bc2), mu, nu)
        return updates, AdamState(count, mu, nu)


def scale_by_adam() -> ScaleByAdam:
    """The default optimizer of the port (optax's defaults)."""
    return ScaleByAdam()


class EmptyState(NamedTuple):
    """optax's ``EmptyState``: the state of a stateless transformation."""


class Adam:
    """``optax.adam(lr)``: ``scale_by_adam()``, then
    ``scale_by_learning_rate(lr)`` (each update times ``-lr`` in float32);
    the state is optax's chain state ``(AdamState, EmptyState())``."""

    def __init__(self, lr: float):
        self.lr = lr

    def init(self, params):
        return (init_adam(params), EmptyState())

    def update(self, grads, state, params=None):
        updates, inner = ScaleByAdam().update(grads, state[0], params)
        updates = tree_map(lambda u: _f32(-self.lr, u) * u, updates)
        return updates, (inner, state[1])


def adam(lr: float) -> Adam:
    """optax's ``adam(lr)`` with its defaults (b1 0.9, b2 0.999, eps 1e-8)."""
    return Adam(lr)


def apply_step(optimizer, params, grads, state):
    """One optimizer step on one (unstacked) param tree -> (params, state),
    as the reference's ``optimizer.update`` then ``p + u``. With the port's
    own Adam (``scale_by_adam()`` or ``adam(lr)``) on CUDA tensors it is one
    KO call (``ko_step``) that updates params, moments and count IN PLACE
    and returns them; any other optimizer, or CPU tensors, take the optax
    surface."""
    kind = type(optimizer)
    if kind in (ScaleByAdam, Adam) and tree_leaves(params)[0].is_cuda:
        # p' = fma(-lr, u, p): -1 for scale_by_adam, where fma(1, u, p) is
        # exactly p + u
        lr = optimizer.lr if kind is Adam else -1.0
        ko_step(params, grads, state[0] if kind is Adam else state, lr)
        return params, state
    updates, state = optimizer.update(grads, state, params)
    return tree_map(lambda p, u: p + u, params, updates), state


def ko_step(params, grads, state: AdamState, lr: float) -> None:
    """Kernel KO over one param tree, in place: ``adam_update`` with the
    tree as one slot (every leaf of params, grads and moments viewed ``[1,
    ...]``, the count ``[1]``), lr ``[lr]`` and mask ``[True]``: ``p' =
    fma(-lr, u, p)``, one C call (a launch per 16 leaves)."""
    def one(tree):
        return tree_map(lambda x: x[None], tree)

    dev = state.count.device
    adam_update(one(params), tree_map(lambda g: g.contiguous()[None], grads),
                AdamState(state.count.reshape(1), one(state.mu), one(state.nu)),
                torch.full((1,), lr, dtype=torch.float32, device=dev),
                torch.ones(1, dtype=torch.bool, device=dev))


# -- the scorer's per-slot step ------------------------------------------------

def _check(params, grads, state: AdamState, lr, mask) -> list:
    ps, gs, ms, vs = (tree_leaves(x) for x in (params, grads, state.mu, state.nu))
    if not len(ps) == len(gs) == len(ms) == len(vs):
        raise ValueError("params, grads and the moments differ in structure")
    t = state.count.shape[0]
    for p, g, m, v in zip(ps, gs, ms, vs):
        if not p.shape == g.shape == m.shape == v.shape or p.shape[0] != t:
            raise ValueError(f"leaf shapes differ or do not stack {t} slots")
    if tuple(lr.shape) != (t,) or tuple(mask.shape) != (t,):
        raise ValueError(f"lr and mask must be [{t}]")
    return list(zip(ps, gs, ms, vs))


def adam_update_plain(params, grads, state: AdamState, lr, mask) -> None:
    """Plain version of KO: one Adam step for the slots in ``mask``
    (bool[T]) at per-slot learning rates ``lr`` (f32[T]), in place; other
    slots keep every value bitwise."""
    leaves = _check(params, grads, state, lr, mask)
    count_inc = safe_increment(state.count)
    bc1, bc2 = bias_corrections(count_inc)
    sc = -lr.to(torch.float32)
    keep = mask.to(torch.bool)
    for p, g, m, v in leaves:
        shape = (-1,) + (1,) * (p.dim() - 1)
        mu2, nu2 = _moments(g, m, v)
        u = _direction(mu2, nu2, bc1.reshape(shape), bc2.reshape(shape))
        p2 = fma(sc.reshape(shape), u, p)
        sel = keep.reshape(shape)
        p.copy_(torch.where(sel, p2, p))
        m.copy_(torch.where(sel, mu2, m))
        v.copy_(torch.where(sel, nu2, v))
    state.count.copy_(torch.where(keep, count_inc, state.count))


def adam_update(params, grads, state: AdamState, lr, mask) -> None:
    """Kernel KO: one Adam step over every leaf of the stacked tree, in
    place (see ``adam_update_plain``). CPU tensors take the plain
    version; CUDA tensors launch KO."""
    if not state.count.is_cuda:
        adam_update_plain(params, grads, state, lr, mask)
        return
    leaves = _check(params, grads, state, lr, mask)
    for x in (y for leaf in leaves for y in leaf):
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise TypeError("KO updates contiguous float32 leaves")
    count_inc = safe_increment(state.count)
    bc1, bc2 = bias_corrections(count_inc)
    launch_ko(leaves, state.count, count_inc, bc1, bc2, lr.to(torch.float32).contiguous(),
              mask.to(torch.bool).contiguous())


def launch_ko(leaves, count, count_inc, bc1, bc2, lr, mask) -> None:
    """KO's launch: ``leaves`` (p, g, mu, nu) tuples of contiguous float32
    [T, ...] tensors, the per-slot bias corrections, lr and mask."""
    t = count.shape[0]
    table = []
    for p, g, m, v in leaves:
        table += [p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(), p.numel() // t]
    tab = (ctypes.c_longlong * len(table))(*table)
    p_ = kernels.ptr
    kernels.launch(
        "adam_update", tab, len(leaves), t, p_(lr), p_(bc1), p_(bc2), p_(mask),
        p_(count), p_(count_inc), kernels.stream_handle(count.device),
    )
