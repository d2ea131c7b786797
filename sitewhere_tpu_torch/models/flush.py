"""The flush form shared by the recurrent scorers' kernels (KS for LSTM-AD,
KD for DeepAR).

A family's flush-form scorer takes the post-update rings and one flush's
rows and returns the score plane the scoring flush emits:

    (params, cfg, state, ids, later, active, counts, mask, k, out_dtype)
        -> scores [T, B] in out_dtype

Its plain version (``score_flush_plain``) gathers each row's window from the
rings, runs the family's plain ``score_stacked``, takes column
``clip(K-1-later, 0, K-1)``, zeroes inactive slots and invalid rows and
casts to the wire dtype — what the reference's fused step does around
``spec.score_stacked`` (``sitewhere_tpu/parallel/sharded.py:564-580``).

KS and KD share one C interface after their weight pointers, and two
modes: ring mode (the flush form; the window gather, column select, row
mask and wire cast happen inside the kernel) and windows mode (given
windows f32[S, B, W] and n_valid, all K columns out, the ``score_stacked``
contract). ``launch_windows`` and ``launch_ring`` are the wrappers'
common part: checks, output allocation, the launch.

Both take the tree the scorer serves from (``ShardedScorer.kernel_params``):
its weight leaves stored as the tenant's ``param_dtype`` made them
(``quantize_params``): f32 masters, bf16, or int8 ``qw`` with per-slot,
per-output-channel f32 ``scale``; the biases f32 in every format.
``scan_weights`` reads the format and the width off the tree and raises
for anything else; its format check (``dense_format``, ``dense_leaf``) is
also how the transformer's KE and KN read theirs.

Each has three forms, chosen by shape before any launch (``scan_route``):
the templated form (``csrc/lstm_score.cu``, ``gru_score.cu``: hidden 8,
16, 32 or 64, ``SCAN_HIDDENS``, a thread's wh column in registers, the
tile's normalized windows in shared memory, so windows up to what
``scan_smem_bytes`` fits), the wide form (``csrc/lstm_score_wide.cu``,
``gru_score_wide.cu``, ``csrc/scan_wide.cuh``: any hidden whose block
state fits shared memory, ``wide_rows``, and any window, read from
global memory) and the global form (the same wide kernels with the block
state in a scratch in global memory, launch names ``lstm_score_global``,
``gru_score_global``: every hidden past the wide form's, 1,757 for KS and
2,231 for KD; ``global_rows``, ``scan_state_floats``). Every shape the
templated or the wide form took keeps its route. The train forms (KB,
KR, ``models/train.py``) route the same way by their own shared memory
(``train_route``): the templated ``csrc/lstm_train.cu``, ``gru_train.cu``
at hidden 8/16/32/64 while their tiles fit (``train_smem_bytes``), the
wide ``csrc/lstm_train_wide.cu``, ``gru_train_wide.cu`` at any other
hidden and window while the block state fits (``train_wide_smem_bytes``:
hidden up to 784 for KB, 1,017 for KR), their global form past it.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple

import torch

from sitewhere_tpu_torch import kernels
from sitewhere_tpu_torch.models.common import Params, clamp_fuse_k, kernel_shape
from sitewhere_tpu_torch.ops.windows import (
    ID_KINDS,
    VAL_KINDS,
    WindowState,
    gather_windows,
    row_mask,
)

# the hidden widths the templated recurrent kernels (KS, KD, KF, KB, KR)
# are built for (csrc/common.cuh by_hidden); rows a block of KS/KD's
# templated form (kRows)
SCAN_HIDDENS = (8, 16, 32, 64)
SCAN_ROWS = 32
# threads of the templated train forms' backward block (csrc/bptt.cuh
# kBwdThreads): 256 / H row groups of H units
TRAIN_BWD_THREADS = 256
# rows a block of the wide forms, most first (csrc/scan_wide.cuh: a
# multiple of kTR = 8), and the bytes of a row's window source there
# (wide::RowSrc)
WIDE_ROWS = (32, 16, 8)
ROW_SRC_BYTES = 32
# the global form: the H100's SMs (global_rows gives each a block where the
# plane allows), the blocks a launch wave holds in its scratch (8 an SM;
# later waves reuse it), and the floats a block's slice of the scratch is
# rounded up to (csrc/scan_wide.cuh kStateAlign: 128 bytes)
GLOBAL_SMS = 132
GLOBAL_WAVE = 8 * GLOBAL_SMS
STATE_ALIGN = 32
# the wide form of each flush kernel: (cell state held, heads)
WIDE_FORMS = {"lstm_score": (True, 1), "gru_score": (False, 2)}
# the weight leaves' storage formats (csrc/common.cuh WF_*), named as the
# tenant's param_dtype
WEIGHT_FORMATS = {"f32": 0, "bf16": 1, "int8": 2}


def score_flush_plain(
    score_stacked_plain: Callable, params: Params, cfg, state: WindowState,
    ids, later, active, counts=None, mask=None, k: int = 1,
    out_dtype=torch.float32,
) -> torch.Tensor:
    """Plain flush form over a family's plain ``score_stacked``: scores
    [T, B] in ``out_dtype`` for rows ``ids`` [T, B] of the post-update
    rings ``state``."""
    windows, n_valid = gather_stacked(state, ids)
    sk = score_stacked_plain(params, cfg, windows, n_valid, k=k)
    return select_scores(sk, later, active, counts, mask, out_dtype)


def gather_stacked(state: WindowState, ids) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each slot's rows ``ids`` [T, B] gathered from the post-update rings:
    (windows f32[T, B, W], n_valid i32[T, B])."""
    wins, ns = [], []
    for t in range(ids.shape[0]):
        one = WindowState(state.values[t], state.pos[t], state.count[t])
        w_t, n_t = gather_windows(one, ids[t])
        wins.append(w_t)
        ns.append(n_t)
    return torch.stack(wins), torch.stack(ns)


def select_scores(sk, later, active, counts, mask, out_dtype) -> torch.Tensor:
    """The flush epilogue on all-K scores f32[T, B, K]: each row's column
    ``clip(K-1-later, 0, K-1)``, zeros for inactive slots and invalid rows,
    the cast to the wire dtype -> [T, B]."""
    k_eff = sk.shape[-1]
    if k_eff > 1:
        idx = torch.clamp(k_eff - 1 - later.to(torch.int64), 0, k_eff - 1)
        s = torch.gather(sk, -1, idx[..., None])[..., 0]
    else:
        s = sk[..., 0]
    live = active.to(torch.bool)[:, None] & row_mask(sk.shape[:2], counts, mask)
    return torch.where(live, s, 0.0).to(out_dtype)


@dataclass(frozen=True)
class ScanWeights:
    """What a recurrent kernel reads of a tree: ``tensors`` its weight
    arguments in order (the leaves, then the int8 scales of the weight
    leaves, or None each for the other formats), the storage format
    ``fmt`` and the width ``hidden``."""

    tensors: Tuple[Optional[torch.Tensor], ...]
    fmt: str
    hidden: int

    @property
    def variant(self) -> str:
        """The launch-count key of this width and format."""
        return f"h{self.hidden},{self.fmt}"


def weight_format(params: Params) -> str:
    """The storage format of a recurrent tree's dense layers: "f32",
    "bf16" or "int8" (``quantize_params``'s forms), "mixed" when they
    differ."""
    fmts = set()
    for node in params.values():
        if "qw" in node:
            fmts.add("int8")
        else:
            fmts.add({torch.float32: "f32", torch.bfloat16: "bf16"}.get(node["w"].dtype,
                                                                     str(node["w"].dtype)))
    return fmts.pop() if len(fmts) == 1 else "mixed"


def dense_format(
    params: Params, layers: Sequence[str], label: str,
    formats: Sequence[str] = tuple(WEIGHT_FORMATS), why: str = "",
) -> str:
    """The one storage format of the dense ``layers`` of a tree; raises
    for a format the kernel does not read (``formats`` it takes, ``why``
    the reason for the rest) or for layers that differ ("mixed")."""
    fmt = weight_format({layer: params[layer] for layer in layers})
    if fmt not in formats:
        raise NotImplementedError(
            f"{label} reads weights stored as {'/'.join(formats)}, got {fmt}" + why
        )
    return fmt


def dense_leaf(node: Params, fmt: str, label: str, layer: str):
    """A dense node's weight as a kernel reads it in format ``fmt``: (the
    stored tensor, its f32 scales for int8, else None)."""
    want = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}[fmt]
    x = node["qw"] if fmt == "int8" else node["w"]
    if x.dtype != want:
        raise TypeError(f"{label}: {layer} weight is {x.dtype}, not {want}")
    scale = node["scale"].to(torch.float32).contiguous() if fmt == "int8" else None
    return x.contiguous(), scale


def scan_weights(
    params: Params, cfg, leaves: Sequence[Tuple[str, str]], label: str,
    formats: Sequence[str] = tuple(WEIGHT_FORMATS), why: str = "",
) -> ScanWeights:
    """The tensors a recurrent kernel reads, in its argument order, with
    the tree's format and width; raises for what the kernel is not built
    for (``formats`` it takes, ``why`` the reason for the rest)."""
    fmt = dense_format(params, list(params), label, formats, why)
    h = kernel_shape(params["wh"])[-2]
    if cfg.dtype not in ("bfloat16", "float32"):
        raise NotImplementedError(f"{label} computes in bfloat16 or float32, not {cfg.dtype}")
    tensors, scales = [], []
    for layer, leaf in leaves:
        node = params[layer]
        if leaf == "w":
            x, scale = dense_leaf(node, fmt, label, layer)
            scales.append(scale)
        else:
            x = node[leaf]
            if x.dtype != torch.float32:
                raise TypeError(f"{label}: {layer}.{leaf} must be float32, got {x.dtype}")
            x = x.contiguous()
        tensors.append(x)
    return ScanWeights(tuple(tensors + scales), fmt, h)


def scan_smem_bytes(h: int, w: int) -> int:
    """The dynamic shared memory of KS's and KD's templated form at hidden
    ``h``, window ``w``: a tile's h, gate sums (and KD's n parts: both 5H
    floats a row) and normalized windows, plus three ints a row
    (``launch_ks``, ``launch_kd``)."""
    return SCAN_ROWS * (5 * h + w) * 4 + 3 * SCAN_ROWS * 4


def scan_state_floats(name: str, h: int, rows: int) -> int:
    """Floats of a block state of the wide and global forms of ``name``
    ("lstm_score", or "gru_score", whose layout KF's shares) at hidden
    ``h`` and ``rows`` a block: hT double-buffered with a row stride of
    rows + 4, the LSTM's c, the head weights (``ksw_state_floats``,
    ``kdw_state_floats``, ``kfw_state_floats``)."""
    cell, heads = WIDE_FORMS[name]
    return 2 * h * (rows + 4) + (rows * h if cell else 0) + heads * h


def wide_smem_bytes(name: str, h: int, rows: int) -> int:
    """The dynamic shared memory of the wide form of ``name`` ("lstm_score"
    or "gru_score") at hidden ``h`` and ``rows`` a block: the rows' window
    sources, two steps' x, three ints a row and the block state
    (``scan_state_floats``; ``launch_ksw``, ``launch_kdw``)."""
    return rows * ROW_SRC_BYTES + 4 * (scan_state_floats(name, h, rows) + 2 * rows) + 3 * rows * 4


def wide_rows(smem_of: Callable[[int], int]) -> int:
    """The most rows a block (``WIDE_ROWS``) whose wide-form state
    ``smem_of(rows)`` fits one block's shared memory; 0 when none does (the
    global form's widths)."""
    for rows in WIDE_ROWS:
        if smem_of(rows) <= kernels.SMEM_MAX_BYTES:
            return rows
    return 0


def state_stride(floats: int) -> int:
    """Floats of a block's slice of the global form's scratch
    (``wide::state_stride``): ``floats`` rounded up to ``STATE_ALIGN``."""
    return -(-floats // STATE_ALIGN) * STATE_ALIGN


def global_rows(blocks_of: Optional[Callable[[int], int]] = None) -> int:
    """Rows a block of the global form: the most of ``WIDE_ROWS`` whose grid
    (``blocks_of(rows)`` blocks) still gives each of the H100's
    ``GLOBAL_SMS`` SMs a block, else 8; without a plane, 32. Each row's
    arithmetic is its own, so no result of the flush and forecast forms
    depends on it (the train forms' leaf sums do, through their tiles' sum
    order); more rows a block read each streamed wh weight for more rows."""
    if blocks_of is None:
        return WIDE_ROWS[0]
    for rows in WIDE_ROWS:
        if blocks_of(rows) >= GLOBAL_SMS:
            return rows
    return WIDE_ROWS[-1]


def plane_blocks(plane: Optional[Tuple[int, int]]) -> Optional[Callable[[int], int]]:
    """The global form's blocks at ``rows`` a block over ``plane`` (slots,
    rows a slot), for ``global_rows``; None without a plane."""
    if plane is None:
        return None
    t, b = plane
    return lambda rows: t * -(-b // rows)


def global_scratch(floats: int, blocks: int, device) -> torch.Tensor:
    """The global form's scratch: one launch wave's blocks (at most
    ``GLOBAL_WAVE`` of ``blocks``), ``state_stride(floats)`` floats each,
    through torch's allocator."""
    n = min(blocks, GLOBAL_WAVE) * state_stride(floats)
    return torch.empty((max(n, 1),), dtype=torch.float32, device=device)


_FORCED: list = []  # (route, rows) while forced_route is active


@contextlib.contextmanager
def forced_route(route: str, rows: int):
    """Within the block, every shape that takes the wide or the global form
    of KS, KD, KF, KB or KR takes ``route`` ("wide" or "global") at
    ``rows`` a block instead (the templated forms' shapes keep theirs): how
    the card's checks hold the global form against the wide form on the
    same shapes, and one R against another. A wide form forced past its
    shared memory fails to launch."""
    if route not in ("wide", "global") or rows not in WIDE_ROWS:
        raise ValueError(f"force the wide or global form at {WIDE_ROWS} rows, got {route}, {rows}")
    _FORCED.append((route, rows))
    try:
        yield
    finally:
        _FORCED.pop()


def past_block_route(smem_of: Callable[[int], int],
                     blocks_of: Optional[Callable[[int], int]]) -> Tuple[str, int]:
    """The form of a shape the templated form does not take: ("wide", the
    most rows whose block state ``smem_of(rows)`` fits shared memory, every
    shape that form took before) or ("global", ``global_rows(blocks_of)``);
    within ``forced_route``, the forced one."""
    if _FORCED:
        return _FORCED[-1]
    rows = wide_rows(smem_of)
    if rows:
        return "wide", rows
    return "global", global_rows(blocks_of)


def scan_route(name: str, label: str, h: int, w: int,
               plane: Optional[Tuple[int, int]] = None) -> Tuple[str, int]:
    """The form of KS (``name`` "lstm_score") or KD ("gru_score") a shape
    takes and its rows a block, decided before any launch: ("block", 32)
    for the templated form (hidden in ``SCAN_HIDDENS`` and a tile that
    fits, ``scan_smem_bytes``: every shape it took before), ("wide", rows)
    while the block state fits shared memory (every shape it took before),
    else ("global", ``global_rows`` over ``plane``, (slots, rows a slot))."""
    if w < 2:
        raise ValueError(f"{label} takes windows of 2 or more samples, got {w}")
    if h in SCAN_HIDDENS and scan_smem_bytes(h, w) <= kernels.SMEM_MAX_BYTES:
        return "block", SCAN_ROWS
    return past_block_route(lambda r: wide_smem_bytes(name, h, r), plane_blocks(plane))


def train_smem_bytes(form, h: int, w: int) -> int:
    """The dynamic shared memory of a templated train form (``form`` a
    ``models.train.TrainForm``: KB or KR) at hidden ``h``, window ``w``, the
    larger of its two modes (``launch_kb``, ``launch_kr``). Forward: a
    tile's h, gate sums (and KR's n parts and losses) and normalized
    windows. Backward: wh^T, the tile's dgates (or the row groups' partial
    sums, whichever is larger), dh, the windows and each head's seed a
    row."""
    g, p = form.gates * h, form.n_partials(h)
    if form.cell:
        fwd = SCAN_ROWS * (h + g + w)
    else:
        fwd = SCAN_ROWS * (h + g + h + w) + SCAN_ROWS
    dg = max(SCAN_ROWS * g, (TRAIN_BWD_THREADS // h) * (p - form.heads))
    bwd = g * h + dg + SCAN_ROWS * (h + w) + form.heads * SCAN_ROWS
    return 4 * max(fwd, bwd)


def train_state_floats(form, h: int, rows: int, mode: int) -> int:
    """Floats of a block state of a wide or global train form (``form``: KB
    or KR) at hidden ``h`` and ``rows`` a block, in ``mode`` 0 (forward:
    hT double-buffered with a row stride of rows + 4, the LSTM's c, the
    heads) or 1 (backward: the step's dgates transposed, [G][rows + 4], dh
    and the LSTM's dc, the row groups' partial sums, the heads;
    ``bw::fwd_state``, ``bw::bwd_state``)."""
    g, rs = form.gates * h, rows + 4
    cell = rows * h if form.cell else 0
    if mode == 0:
        return 2 * h * rs + cell + form.heads * h
    pa = form.n_partials(h) - form.heads
    return g * rs + rows * h + cell + (rows // 8) * pa + form.heads * h


def train_wide_smem_bytes(form, h: int, rows: int) -> int:
    """The dynamic shared memory of a wide train form (``launch_kbw``,
    ``launch_krw``) at hidden ``h`` and ``rows`` a block, the larger of its
    two modes: the rows' window sources, per row the forward's two steps'
    x and its loss or the backward's two steps' seeds and x, and the block
    state (``train_state_floats``)."""
    fwd = train_state_floats(form, h, rows, 0) + 3 * rows
    bwd = train_state_floats(form, h, rows, 1) + 2 * rows * form.heads + 2 * rows
    return rows * ROW_SRC_BYTES + 4 * max(fwd, bwd)


def train_route(form, h: int, w: int,
                plane: Optional[Tuple[int, int]] = None) -> Tuple[str, int]:
    """The form of KB or KR (``form``) a shape trains on and its rows a
    block, decided before any launch: ("block", 32) for the templated form
    (hidden in ``SCAN_HIDDENS`` and both modes' tiles in one block's shared
    memory, ``train_smem_bytes``: every shape it took before, windows up to
    128, and longer ones while they fit), ("wide", rows) with the most rows
    whose state fits (``train_wide_smem_bytes``: every shape it took
    before), else ("global", ``global_rows`` over ``plane``, (slots, rows a
    slot))."""
    if w < 2:
        raise ValueError(f"{form.label} trains on windows of 2 or more samples, got {w}")
    if h in SCAN_HIDDENS and train_smem_bytes(form, h, w) <= kernels.SMEM_MAX_BYTES:
        return "block", SCAN_ROWS
    return past_block_route(lambda r: train_wide_smem_bytes(form, h, r), plane_blocks(plane))


def _launch(name, weights: ScanWeights, cfg, *, ring, windows, n_valid, ids, later,
            active, counts, mask, out, t_slots, b, w, k, label) -> None:
    p = kernels.ptr
    s = 0 if ring is None else ring.values.shape[1]
    route, rows = scan_route(name, label, weights.hidden, w, (t_slots, b))
    extra = () if route == "block" else (rows,)
    if route == "global":
        state = global_scratch(scan_state_floats(name, weights.hidden, rows),
                               t_slots * -(-b // rows), out.device)
        extra += (p(state), GLOBAL_WAVE)
    kernels.launch(
        name if route == "block" else f"{name}_{route}",
        *[p(x) for x in weights.tensors], WEIGHT_FORMATS[weights.fmt],
        None if ring is None else p(ring.values),
        None if ring is None else p(ring.pos),
        None if ring is None else p(ring.count), s,
        p(ids), 0 if ids is None else ID_KINDS[ids.dtype],
        p(windows), p(n_valid), p(later), p(active), p(counts), p(mask),
        p(out), VAL_KINDS[out.dtype], t_slots, b, w, weights.hidden, k,
        1 if cfg.dtype == "bfloat16" else 0, *extra,
        kernels.stream_handle(out.device), variant=weights.variant,
    )


def launch_windows(
    name: str, label: str, weights: ScanWeights, cfg, windows: torch.Tensor,
    n_valid: torch.Tensor, k: int,
) -> torch.Tensor:
    """Windows mode: windows f32[S, B, W], n_valid i32[S, B] ->
    f32[S, B, K]."""
    s_slots, b, w = windows.shape
    k = clamp_fuse_k(k, w)
    out = torch.empty((s_slots, b, k), dtype=torch.float32, device=windows.device)
    _launch(
        name, weights, cfg, ring=None,
        windows=windows.to(torch.float32).contiguous(),
        n_valid=n_valid.to(torch.int32).contiguous(),
        ids=None, later=None, active=None, counts=None, mask=None, out=out,
        t_slots=s_slots, b=b, w=w, k=k, label=label,
    )
    return out


def launch_ring(
    name: str, label: str, weights: ScanWeights, cfg, state: WindowState, ids, later,
    active, counts, mask, k: int, out_dtype,
) -> torch.Tensor:
    """Ring mode, the flush form: scores [T, B] in ``out_dtype``."""
    t_slots, b = ids.shape
    w = state.values.shape[-1]
    if (counts is None) == (mask is None):
        raise ValueError("pass exactly one of counts and mask")
    out = torch.empty((t_slots, b), dtype=out_dtype, device=ids.device)
    _launch(
        name, weights, cfg, ring=state, windows=None, n_valid=None,
        ids=ids.contiguous(), later=later.to(torch.int32).contiguous(),
        active=active.to(torch.bool).contiguous(),
        counts=None if counts is None else counts.to(torch.int32).contiguous(),
        mask=None if mask is None else mask.to(torch.bool).contiguous(),
        out=out, t_slots=t_slots, b=b, w=w, k=clamp_fuse_k(k, w), label=label,
    )
    return out
