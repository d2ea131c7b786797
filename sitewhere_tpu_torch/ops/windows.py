"""Per-stream ring-buffer windows on the device — the port of
``sitewhere_tpu/ops/windows.py``.

Every (device, measurement-name) series owns a fixed-length ring buffer in
device memory, so the hot loop only ships the new micro-batch host→device.
State is ``[S, W]`` per slot (``[T, S, W]`` stacked over tenant slots).
Rows of one stream in one batch are ranked by arrival and written to
``(pos[s] + rank) % W``; only the newest W rows of a burst write. Invalid
rows write nothing, ids outside ``[0, S)`` write nothing, and reads clamp
ids into ``[0, S)`` (XLA's scatter ``mode="drop"`` and clamped gather).

Two forms of the update live here:

- the functional plain versions of the reference, one slot at a time
  (``update_windows``, ``gather_windows``, ``update_and_gather``,
  ``update_gather_ranked``), which return new state;
- ``window_update``, the wrapper of kernel KW, which updates the stacked
  state of every slot IN PLACE (the JAX step donates its window state,
  ``parallel/sharded.py:611``, so the buffer is reused the same way) and
  returns the rows' ``later`` recency. On CPU tensors it runs
  ``window_update_plain``; on CUDA tensors it launches KW in one of two
  forms, chosen by the flush's rows a slot (``kw_route``): the one-block
  form (``csrc/window_update.cu``, every flush it sorts in one block's
  shared memory: ``kw_block_max_rows()``, 16,384 rows) or the multi-block
  form (``csrc/window_update_multi.cu``: chunk sorts, merge passes, ranks
  and writes, the pos/count advance; any row count). Both give the same
  bits; ``window_update_chunked_plain`` mirrors the multi-block
  decomposition step by step, its chunk size a parameter.

Totals are the per-stream row counts of the batch. The reference's
``_segment_ranks`` broadcasts the largest run length of the sorted suffix
instead (ROADMAP queue 3), which differs when a later-sorted stream has a
longer run; this port follows the documented contract.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from sitewhere_tpu_torch import kernels

# the one-block KW's key: row index in its low kRowBits bits
# (csrc/window_update.cu)
KW_ROW_BITS = 15
# rows a block of the multi-block KW sorts in shared memory (a power of
# two; csrc/window_update_multi.cu kw_chunk_sort), and its key's row shift
KW_CHUNK = 4096
KW_MULTI_ROW_SHIFT = 31

# wire kind codes shared with csrc/common.cuh
VAL_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
ID_KINDS = {torch.int32: 0, torch.uint16: 1}


class WindowState(NamedTuple):
    """Per-stream ring buffers.

    values: f32[..., S, W]  ring storage (raw measurement values)
    pos:    i32[..., S]     next write slot per stream
    count:  i32[..., S]     samples ever written per stream (only
                            ``min(count, W)`` is used)
    """

    values: torch.Tensor
    pos: torch.Tensor
    count: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.values.shape[-2]

    @property
    def window(self) -> int:
        return self.values.shape[-1]


def init_window_state(
    max_streams: int, window: int, device="cuda", dtype=torch.float32,
    n_slots: Optional[int] = None,
) -> WindowState:
    """Zeroed state ``[S, W]``, or ``[n_slots, S, W]`` when stacked."""
    lead = () if n_slots is None else (n_slots,)
    return WindowState(
        values=torch.zeros(lead + (max_streams, window), dtype=dtype, device=device),
        pos=torch.zeros(lead + (max_streams,), dtype=torch.int32, device=device),
        count=torch.zeros(lead + (max_streams,), dtype=torch.int32, device=device),
    )


def ids_as_long(ids: torch.Tensor) -> torch.Tensor:
    """Stream ids as int64 for indexing; u16 ids are widened through int16
    (CPU support for ``torch.uint16`` arithmetic is thin)."""
    if ids.dtype == torch.uint16:
        return ids.view(torch.int16).to(torch.int64) & 0xFFFF
    return ids.to(torch.int64)


def _segment_ranks(stream_ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rank of each row among rows sharing its stream id (arrival order),
    and the number of rows with that id. Works on padded ids too.

    Returns (ranks i32[B], totals i32[B]) in the original row order."""
    b = stream_ids.shape[0]
    dev = stream_ids.device
    if b == 0:
        empty = torch.zeros((0,), dtype=torch.int32, device=dev)
        return empty, empty
    order = torch.argsort(stream_ids, stable=True)
    sorted_ids = stream_ids[order]
    idx = torch.arange(b, device=dev)
    change = sorted_ids[1:] != sorted_ids[:-1]
    one = torch.ones((1,), dtype=torch.bool, device=dev)
    is_start = torch.cat([one, change])
    is_end = torch.cat([change, one])
    start_idx = torch.cummax(torch.where(is_start, idx, -1), 0).values
    ranks_sorted = idx - start_idx
    # the run's end index, broadcast backwards along the run (cummin over
    # the reversed end markers stops at the run's own end)
    big = torch.full_like(idx, b)
    end_idx = torch.cummin(torch.where(is_end, idx, big).flip(0), 0).values.flip(0)
    totals_sorted = end_idx - start_idx + 1
    ranks = torch.empty_like(ranks_sorted)
    totals = torch.empty_like(totals_sorted)
    ranks[order] = ranks_sorted
    totals[order] = totals_sorted
    return ranks.to(torch.int32), totals.to(torch.int32)


def _apply_update(
    state: WindowState,
    stream_ids: torch.Tensor,
    values: torch.Tensor,
    valid: torch.Tensor,
    ranks: torch.Tensor,
    totals: torch.Tensor,
) -> WindowState:
    """Scatter a ranked micro-batch into the rings of one slot (the body
    of ``update_windows``); returns new state."""
    s, w = state.values.shape
    ids = ids_as_long(stream_ids)
    in_range = (ids >= 0) & (ids < s)
    safe = ids.clamp(0, s - 1)
    write_slot = (state.pos[safe].to(torch.int64) + ranks) % w
    newest_w = ranks >= (totals - w)
    keep = valid & newest_w & in_range
    new_values = state.values.clone().reshape(-1)
    flat = safe * w + write_slot
    new_values[flat[keep]] = values[keep].to(state.values.dtype)
    per_stream = torch.zeros((s,), dtype=torch.int32, device=ids.device)
    counted = valid & in_range
    per_stream.index_add_(
        0, safe[counted], torch.ones_like(safe[counted], dtype=torch.int32)
    )
    return WindowState(
        values=new_values.reshape(s, w),
        pos=(state.pos + per_stream) % w,
        count=state.count + per_stream,
    )


def update_windows(
    state: WindowState,
    stream_ids: torch.Tensor,  # i32/u16[B]
    values: torch.Tensor,      # f32/bf16/f16[B]
    valid: torch.Tensor,       # bool[B]
) -> WindowState:
    """Append a micro-batch into one slot's rings (order-preserving within
    a stream). Functional: returns new state."""
    ids = ids_as_long(stream_ids)
    ranks, totals = _segment_ranks(torch.where(valid, ids, -1))
    return _apply_update(state, stream_ids, values, valid, ranks, totals)


def gather_windows(
    state: WindowState,
    stream_ids: torch.Tensor,  # [B]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Time-ordered windows of each requested stream: (windows f32[B, W]
    oldest→newest, n_valid i32[B] clamped to W). Streams with fewer than
    W samples are left-padded with their oldest value."""
    s, w = state.values.shape
    ids = ids_as_long(stream_ids).clamp(0, s - 1)  # reads clamp
    raw = state.values[ids]                        # [B, W] ring order
    pos = state.pos[ids].to(torch.int64)
    col = torch.arange(w, device=ids.device)[None, :]
    src = (pos[:, None] + col) % w
    ordered = torch.gather(raw, 1, src)
    n = state.count[ids].clamp(max=w)
    first_valid_col = (w - n).to(torch.int64)
    first_val = torch.gather(
        ordered, 1, torch.clamp(first_valid_col, max=w - 1)[:, None]
    )
    windows = torch.where(col < first_valid_col[:, None], first_val, ordered)
    return windows, n.to(torch.int32)


def update_and_gather(state, stream_ids, values, valid):
    """Append the batch, then gather each row's window including the row
    itself as the newest element."""
    new_state = update_windows(state, stream_ids, values, valid)
    windows, n = gather_windows(new_state, stream_ids)
    return new_state, windows, n


def update_gather_ranked(state, stream_ids, values, valid):
    """``update_and_gather`` plus per-row recency ``later`` i32[B]: how
    many valid same-stream rows come after row b in this batch (0 = the
    stream's newest sample)."""
    ids = ids_as_long(stream_ids)
    ranks, totals = _segment_ranks(torch.where(valid, ids, -1))
    new_state = _apply_update(state, stream_ids, values, valid, ranks, totals)
    windows, n = gather_windows(new_state, stream_ids)
    later = torch.where(valid, totals - 1 - ranks, 0).to(torch.int32)
    return new_state, windows, n, later


# -- kernel KW: the stacked in-place update ---------------------------------

def row_mask(
    shape, counts: Optional[torch.Tensor], mask: Optional[torch.Tensor]
) -> torch.Tensor:
    """bool[T, B] validity from lane counts i32[T, 1] (rows fill each lane
    from the front) or from a given mask."""
    if mask is not None:
        return mask.to(torch.bool)
    t, b = shape
    lanepos = torch.arange(b, dtype=torch.int32, device=counts.device)
    return lanepos[None, :] < counts.reshape(t, 1)


def window_update_plain(
    state: WindowState, ids, vals, counts=None, mask=None
) -> torch.Tensor:
    """Plain version of KW: ``update_gather_ranked``'s update for every
    slot of the stacked state, written back in place. Returns later
    i32[T, B]."""
    valid = row_mask(ids.shape, counts, mask)
    later = torch.empty(ids.shape, dtype=torch.int32, device=ids.device)
    for t in range(ids.shape[0]):
        one = WindowState(state.values[t], state.pos[t], state.count[t])
        sid = ids_as_long(ids[t])
        ranks, totals = _segment_ranks(torch.where(valid[t], sid, -1))
        new = _apply_update(one, ids[t], vals[t], valid[t], ranks, totals)
        state.values[t].copy_(new.values)
        state.pos[t].copy_(new.pos)
        state.count[t].copy_(new.count)
        later[t] = torch.where(valid[t], totals - 1 - ranks, 0)
    return later


def _check_flush(state: WindowState, ids, vals, counts, mask) -> None:
    t, b = ids.shape
    if (counts is None) == (mask is None):
        raise ValueError("pass exactly one of counts and mask")
    if state.values.dim() != 3 or state.values.shape[0] != t:
        raise ValueError(
            f"state {tuple(state.values.shape)} does not stack {t} slots"
        )
    if vals.shape != ids.shape:
        raise ValueError(f"values {tuple(vals.shape)} != ids {tuple(ids.shape)}")
    if counts is not None and tuple(counts.shape) != (t, 1):
        raise ValueError(f"counts must be i32[{t}, 1], got {tuple(counts.shape)}")
    if mask is not None and mask.shape != ids.shape:
        raise ValueError("mask must match ids")


def _multi_keys(ids, valid) -> torch.Tensor:
    """The multi-block KW's sort keys of one slot: (stream id + 1) << 31 |
    row, the id taken as u32 and 0 in the high part for invalid rows (the
    kernel's u64 keys; as int64 here, exact for the contract's ids, which
    are never negative)."""
    g = torch.where(valid, (ids_as_long(ids) & 0xFFFFFFFF) + 1, 0)
    return (g << KW_MULTI_ROW_SHIFT) | torch.arange(ids.shape[0], device=ids.device)


def _merge_runs(keys: torch.Tensor, width: int) -> torch.Tensor:
    """One merge pass of the multi-block KW (``kw_merge``): every key of
    two adjacent sorted runs of ``width`` takes its own index in its run
    plus the number of smaller keys in the other run."""
    b = keys.shape[0]
    out = torch.empty_like(keys)
    for a0 in range(0, b, 2 * width):
        mid, end = min(a0 + width, b), min(a0 + 2 * width, b)
        left, right = keys[a0:mid], keys[mid:end]
        out[a0 + torch.arange(mid - a0) + torch.searchsorted(right, left)] = left
        out[a0 + torch.arange(end - mid) + torch.searchsorted(left, right)] = right
    return out


def window_update_chunked_plain(
    state: WindowState, ids, vals, counts=None, mask=None, chunk: int = KW_CHUNK
) -> torch.Tensor:
    """Plain mirror of the multi-block KW's decomposition, slot by slot:
    sort each chunk of ``chunk`` rows, merge adjacent runs until one is
    left, then ranks, ``later`` and the ring writes from the sorted keys'
    runs (binary searches), and the pos/count advance by each run's last
    key. Updates ``state`` in place; returns later i32[T, B], bitwise
    ``window_update_plain``'s."""
    valid = row_mask(ids.shape, counts, mask)
    t_slots, b = ids.shape
    s_max, w = state.values.shape[1:]
    later = torch.zeros(ids.shape, dtype=torch.int32, device=ids.device)
    for t in range(t_slots):
        keys = _multi_keys(ids[t], valid[t])
        keys = torch.cat([keys[c:c + chunk].sort().values for c in range(0, b, chunk)])
        width = chunk
        while width < b:
            keys = _merge_runs(keys, width)
            width *= 2
        g = keys >> KW_MULTI_ROW_SHIFT
        row = keys & ((1 << KW_MULTI_ROW_SHIFT) - 1)
        first = torch.searchsorted(keys, g << KW_MULTI_ROW_SHIFT)
        end = torch.searchsorted(keys, (g + 1) << KW_MULTI_ROW_SHIFT)
        rank = torch.arange(b, device=ids.device) - first
        total = end - first
        real = g > 0
        later[t, row[real]] = (total - 1 - rank)[real].to(torch.int32)
        sid = ids_as_long(ids[t])[row]
        writes = real & (sid >= 0) & (sid < s_max)
        ring = writes & (rank >= total - w)
        slot_pos = state.pos[t].to(torch.int64)
        at = (slot_pos[sid[ring]] + rank[ring]) % w
        state.values[t][sid[ring], at] = vals[t][row[ring]].to(state.values.dtype)
        last = writes & torch.cat([g[1:] != g[:-1], torch.ones(1, dtype=torch.bool,
                                                                device=ids.device)])
        s_last, n_last = sid[last], total[last]
        state.pos[t][s_last] = ((slot_pos[s_last] + n_last) % w).to(torch.int32)
        state.count[t][s_last] += n_last.to(torch.int32)
    return later


def kw_block_max_rows() -> int:
    """The most rows a slot the one-block KW takes: it sorts the next power
    of two of B 8-byte keys in one block's shared memory, each key holding
    the row in ``KW_ROW_BITS`` bits. 16,384 on the H100."""
    p = 1
    while 2 * p * 8 <= kernels.SMEM_MAX_BYTES and 2 * p <= 1 << KW_ROW_BITS:
        p *= 2
    return p


def kw_route(b: int) -> str:
    """The form of KW a flush of ``b`` rows a slot takes, decided before
    any launch: "block" (``csrc/window_update.cu``, every flush it took
    before the multi-block form) or "multi" (``csrc/window_update_multi.cu``)."""
    return "block" if b <= kw_block_max_rows() else "multi"


def window_update(
    state: WindowState, ids, vals, counts=None, mask=None, route: Optional[str] = None,
) -> torch.Tensor:
    """Kernel KW: append one flush ``ids``/``vals`` [T, B] into the stacked
    rings ``state`` [T, S, W] in place; validity is ``counts`` i32[T, 1]
    (counts mode) or ``mask`` bool[T, B]. Returns later i32[T, B]. CPU
    tensors take the plain version; CUDA tensors launch KW in the form
    ``kw_route`` picks (``route`` forces one: the card's checks hold the
    multi-block form against the one-block form at a shape both take)."""
    _check_flush(state, ids, vals, counts, mask)
    if not ids.is_cuda:
        return window_update_plain(state, ids, vals, counts, mask)
    t, b = ids.shape
    route = route or kw_route(b)
    if route == "block" and b > kw_block_max_rows():
        raise ValueError(f"the one-block KW takes at most {kw_block_max_rows()} rows a slot")
    if ids.dtype not in ID_KINDS or vals.dtype not in VAL_KINDS:
        raise TypeError(f"KW takes ids {list(ID_KINDS)}, values {list(VAL_KINDS)}")
    if state.values.dtype != torch.float32:
        raise TypeError("KW rings are float32")
    for x in (state.values, state.pos, state.count, ids, vals):
        if not x.is_contiguous():
            raise ValueError("KW takes contiguous tensors")
    counts = None if counts is None else counts.to(torch.int32).contiguous()
    mask = None if mask is None else mask.to(torch.bool).contiguous()
    later = torch.empty((t, b), dtype=torch.int32, device=ids.device)
    s, w = state.values.shape[1:]
    p = kernels.ptr
    head = (p(state.values), p(state.pos), p(state.count), s, w, p(ids), ID_KINDS[ids.dtype],
            p(vals), VAL_KINDS[vals.dtype], p(counts), p(mask), p(later), t, b)
    if route == "block":
        kernels.launch("window_update", *head, kernels.stream_handle(ids.device))
        return later
    chunk = min(KW_CHUNK, 1 << max(1, (b - 1).bit_length()))
    keys = torch.empty((2, t, b), dtype=torch.int64, device=ids.device)
    kernels.launch("window_update_multi", *head, chunk, p(keys[0]), p(keys[1]),
                   kernels.stream_handle(ids.device))
    return later
