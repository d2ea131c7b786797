"""The feed path of the scoring flush — the first part of the port of
``sitewhere_tpu/pipeline/inference.py``.

What a flush needs on the host side: ``StreamRegistry`` maps each
(device token, measurement name) of a tenant to a (data shard, local
stream id); ``_LaneRing`` holds the pending rows of one (slot, data shard)
lane in preallocated numpy rings; ``_StagingSet`` is one reusable set of
flush buffers in the scorer's wire dtypes. A flush pops each lane's rows
front-contiguous into a staging set, stages it (async h2d), runs
``step_counts``, compacts the rows with ``gather_rows`` and copies them
back asynchronously — as ``TpuInferenceService._flush_slice`` does in the
JAX package. The service itself is the next slice (ROADMAP queue 1).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from sitewhere_tpu_torch.parallel.sharded import f32_to_bf16_bits


class StreamRegistry:
    """Per-tenant map (device_token, name) -> (data_shard, local_id).

    Streams are pinned to a data shard at first sight (least-loaded wins),
    so a stream's window updates always land on the same device."""

    def __init__(self, n_data_shards: int, local_capacity: int) -> None:
        self.n_data_shards = n_data_shards
        self.local_capacity = local_capacity
        self._map: Dict[Tuple[str, str], Tuple[int, int]] = {}
        self._next: List[int] = [0] * n_data_shards

    def lookup_or_assign(
        self, device_token: str, name: str
    ) -> Optional[Tuple[int, int]]:
        key = (device_token, name)
        hit = self._map.get(key)
        if hit is not None:
            return hit
        shard = min(range(self.n_data_shards), key=lambda d: self._next[d])
        if self._next[shard] >= self.local_capacity:
            return None  # capacity exhausted; the event passes unscored
        local_id = self._next[shard]
        self._next[shard] += 1
        self._map[key] = (shard, local_id)
        return shard, local_id

    @property
    def n_streams(self) -> int:
        return len(self._map)


class _LaneRing:
    """Pending rows for one (slot, data_shard): a preallocated numpy ring.

    Rows are written into fixed-dtype ring segments at enqueue (``push``)
    and leave straight into a flush's staging buffers (``pop_into``) or as
    fresh arrays on the cold paths (``pop``). Capacity doubles when a burst
    overshoots."""

    COLS = ("ids", "vals", "seqs", "rows")
    __slots__ = COLS + ("head", "count")

    def __init__(self, capacity: int = 4096) -> None:
        cap = max(64, int(capacity))
        self.ids = np.empty((cap,), np.int32)   # local stream ids
        self.vals = np.empty((cap,), np.float32)
        self.seqs = np.empty((cap,), np.int64)  # batch sequence numbers
        self.rows = np.empty((cap,), np.int32)  # row index inside the batch
        self.head = 0
        self.count = 0

    @property
    def capacity(self) -> int:
        return len(self.ids)

    def _grow(self, need: int) -> None:
        cap = self.capacity
        new_cap = cap
        while new_cap < need:
            new_cap *= 2
        k = self.count
        first = min(k, cap - self.head)
        for name in self.COLS:
            old = getattr(self, name)
            new = np.empty((new_cap,), old.dtype)
            new[:first] = old[self.head : self.head + first]
            new[first:k] = old[: k - first]
            setattr(self, name, new)
        self.head = 0

    def push(self, ids, vals, seq, rows) -> None:
        """Append rows. ``seq`` may be a scalar (broadcast into the ring)."""
        n = len(ids)
        if self.count + n > self.capacity:
            self._grow(self.count + n)
        cap = self.capacity
        tail = (self.head + self.count) % cap
        first = min(n, cap - tail)
        second = n - first
        self.ids[tail : tail + first] = ids[:first]
        self.vals[tail : tail + first] = vals[:first]
        self.rows[tail : tail + first] = rows[:first]
        if np.ndim(seq):
            self.seqs[tail : tail + first] = seq[:first]
        else:
            self.seqs[tail : tail + first] = seq
        if second:
            self.ids[:second] = ids[first:]
            self.vals[:second] = vals[first:]
            self.rows[:second] = rows[first:]
            self.seqs[:second] = seq[first:] if np.ndim(seq) else seq
        self.count += n

    @staticmethod
    def _put_vals(dst, src) -> None:
        # a uint16 value buffer is the bf16 wire carried as raw bits
        if dst.dtype == np.uint16:
            dst[:] = f32_to_bf16_bits(src)
        else:
            dst[:] = src

    def pop_into(
        self, k: int, ids_row, vals_row, col0: int, seqs_out, rows_out, off: int
    ) -> None:
        """Move k rows FIFO off the front straight into one slot's staging
        views (at column ``col0``; the cast to the wire dtype happens in
        the slice write) and the flush's bookkeeping at offset ``off``."""
        h, cap = self.head, self.capacity
        first = min(k, cap - h)
        second = k - first
        ids_row[col0 : col0 + first] = self.ids[h : h + first]
        self._put_vals(vals_row[col0 : col0 + first], self.vals[h : h + first])
        seqs_out[off : off + first] = self.seqs[h : h + first]
        rows_out[off : off + first] = self.rows[h : h + first]
        if second:
            ids_row[col0 + first : col0 + k] = self.ids[:second]
            self._put_vals(vals_row[col0 + first : col0 + k], self.vals[:second])
            seqs_out[off + first : off + k] = self.seqs[:second]
            rows_out[off + first : off + k] = self.rows[:second]
        self.head = (h + k) % cap
        self.count -= k

    def pop(self, n: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Take up to n rows off the front as fresh arrays (cold paths)."""
        k = min(int(n), self.count)
        h, cap = self.head, self.capacity
        first = min(k, cap - h)
        out = []
        for name in self.COLS:
            a = getattr(self, name)
            dst = np.empty((k,), a.dtype)
            dst[:first] = a[h : h + first]
            if k > first:
                dst[first:] = a[: k - first]
            out.append(dst)
        self.head = (h + k) % cap
        self.count -= k
        return tuple(out)


class _StagingSet:
    """One reusable flush staging set: ids/vals ``[T, D*B]`` in the
    scorer's wire dtypes (page-locked on the card), lane counts ``[T, D]``
    and a cached column arange. ``staged`` holds the device arrays of this
    set's last ``stage_inputs``: the async h2d copy reads the host buffers,
    so reuse waits on it (two sets rotating per bucket normally hide the
    wait)."""

    __slots__ = ("ids", "vals", "counts", "arange", "staged")

    def __init__(self, scorer, b_lane: int) -> None:
        t, d = scorer.n_slots, scorer.mm.n_data_shards
        self.ids = scorer.host_buffer((t, d * b_lane), scorer.ids_np_dtype)
        self.vals = scorer.host_buffer((t, d * b_lane), scorer.vals_np_dtype)
        self.counts = scorer.host_buffer((t, d), np.int32)
        self.arange = np.arange(d * b_lane, dtype=np.int32)
        self.staged = None

    def ensure_reusable(self) -> bool:
        """Block until this set's previous h2d copy finished. Returns True
        when it had to wait (the service counts those)."""
        staged = self.staged
        if staged is None:
            return False
        self.staged = None
        if all(a.is_ready() for a in staged):
            return False
        for a in staged:
            a.block_until_ready()
        return True
