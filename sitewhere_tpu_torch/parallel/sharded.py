"""Stacked multi-tenant scoring — the port of ``sitewhere_tpu/parallel/sharded.py``.

One ``ShardedScorer`` per model family holds every tenant slot's params
stacked along a leading slot dim ``[T, ...]``, the window state
``[T, S, W]`` and the active mask ``[T]``, all on one device. A scoring
flush runs on the current stream:

  KW     window_update  (ops/windows.py)  rings updated IN PLACE, later[T, B]
  KS/KD/ the family's ``score_flush``     scores[T, B] in the wire dtype
  KE..KN (KS models/lstm_ad.py, KD models/deepar.py; the transformer's
         KE, KL, KA, KU, KN and its projections, models/transformer.py)
  KH     score_sketch   (this module)     per-slot 64-bin histogram
  KG     gather_rows    (this module)     compacted rows, NaN-padded

Where the JAX step donates its window state (``sharded.py:611``) the port
updates the state tensors in place. CPU tensors run each kernel's plain
PyTorch version; CUDA tensors launch the kernels (``plain=True`` makes a
scorer run the plain versions on the card too, as the twin the kernels are
held against). The fused path is the only path.

The training half (the continual-learning train lane, ``sharded.py:976-1349``
of the reference) runs one step, ``_train_step``, for ``train_resident``
(on the serve rings) and ``train_lane_step`` (the serve rings or the
replay-fed feed rings): the family's ``loss_ring`` over every stream of
every slot (KB for LSTM-AD, KR for DeepAR, ``models/train.py``; the
transformer's KE, KL, KA, KU, KN and their backward kernels,
``models/transformer.py``), a chunk of slots at a time, the masked
per-slot mean, one backward, and KO (``ops/adam.py``), the per-slot Adam
step with the freeze of slots outside the train mask. Params and the Adam
state update in place, where the reference donates them. The feed rings
take replayed rows through KW in counts mode (``train_feed_ingest``).

Host transfers ride two side streams. ``stage_inputs`` copies one flush's
wire buffers host→device on the h2d stream and records an event the step
waits on; ``copy_to_host_async`` on a result copies it device→host on the
d2h stream into page-locked memory. Results come back as ``DeviceArray``
handles with the ``is_ready`` / ``block_until_ready`` /
``copy_to_host_async`` surface the service duck-types on.

bf16 on the host is ``np.uint16`` raw bits (no ``ml_dtypes`` here), viewed
as ``torch.bfloat16`` on the device.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from sitewhere_tpu_torch import kernels
from sitewhere_tpu_torch.models import ModelSpec
from sitewhere_tpu_torch.models.common import (
    PARAM_DTYPES,
    SKETCH_NBINS,
    clamp_fuse_k,
    quantize_params,
    sketch_edges,
    tree_leaves,
    tree_map,
)
from sitewhere_tpu_torch.models.train import ring_windows
from sitewhere_tpu_torch.ops.adam import (
    AdamState,
    adam_update,
    adam_update_plain,
    init_adam,
)
from sitewhere_tpu_torch.ops.windows import (
    VAL_KINDS,
    WindowState,
    init_window_state,
    row_mask,
    window_update,
    window_update_plain,
)
from sitewhere_tpu_torch.parallel.mesh import MeshManager

Params = Dict[str, object]

WIRE_TORCH = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}


# -- bf16 as raw bits on the host ---------------------------------------------

def f32_to_bf16_bits(x) -> np.ndarray:
    """float32 values -> bf16 raw bits (np.uint16), round to nearest even,
    NaN kept quiet — the cast ``ml_dtypes`` and torch perform."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    rounded = ((u + (((u >> 16) & 1) + 0x7FFF)) >> 16).astype(np.uint16)
    nan = (u & 0x7FFFFFFF) > 0x7F800000
    return np.where(nan, ((u >> 16) | 0x0040).astype(np.uint16), rounded)


def bf16_bits_to_f32(bits) -> np.ndarray:
    """bf16 raw bits (np.uint16) -> float32 values (exact)."""
    return (np.asarray(bits, dtype=np.uint16).astype(np.uint32) << 16).view(np.float32)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype in (torch.bfloat16, torch.uint16):
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


# -- device results -------------------------------------------------------------

class DeviceArray:
    """A tensor on the scorer's device plus its async host path: the
    ``is_ready`` / ``block_until_ready`` / ``copy_to_host_async`` surface
    of a ``jax.Array`` the service duck-types on. ``ready`` is the CUDA
    event recorded after the work that produced the tensor (None on the
    CPU); ``np.asarray`` waits for the host copy (bf16 comes back as
    uint16 bits)."""

    __slots__ = ("tensor", "_ready", "_d2h", "_host", "_copied", "_source")

    def __init__(
        self, tensor: torch.Tensor, ready=None, d2h_stream=None, source=None
    ) -> None:
        self.tensor = tensor
        self._ready = ready
        self._d2h = d2h_stream
        self._host: Optional[torch.Tensor] = None
        self._copied = None
        # the host tensor an async h2d copy reads: kept alive with the
        # handle, so its memory is not reused while the copy runs
        self._source = source

    @property
    def shape(self):
        return tuple(self.tensor.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.tensor.dtype

    @property
    def nbytes(self) -> int:
        return self.tensor.numel() * self.tensor.element_size()

    def is_ready(self) -> bool:
        """The producing work (compute or h2d copy) has finished."""
        return self._ready is None or self._ready.query()

    def block_until_ready(self) -> "DeviceArray":
        if self._ready is not None:
            self._ready.synchronize()
        return self

    def copy_to_host_async(self) -> None:
        """Start the device→host copy into page-locked memory on the d2h
        stream, behind the producing work; returns at once."""
        if self._host is not None:
            return
        t = self.tensor
        if not t.is_cuda:
            self._host = t.detach().clone()
            return
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        with torch.cuda.stream(self._d2h):
            if self._ready is not None:
                self._d2h.wait_event(self._ready)
            host.copy_(t, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(self._d2h)
        t.record_stream(self._d2h)
        self._host, self._copied = host, copied

    def __array__(self, dtype=None, copy=None):
        self.copy_to_host_async()
        if self._copied is not None:
            self._copied.synchronize()
        arr = _to_numpy(self._host).copy()
        return arr if dtype is None else arr.astype(dtype)

    def numpy_f32(self) -> np.ndarray:
        """Host values as float32 (bf16 bits widened exactly)."""
        arr = np.asarray(self)
        if self.tensor.dtype == torch.bfloat16:
            return bf16_bits_to_f32(arr)
        return arr.astype(np.float32)


# -- kernel KH: score sketch ------------------------------------------------------

def score_sketch_plain(
    scores, active, edges, counts=None, mask=None
) -> torch.Tensor:
    """Plain version of KH: per-slot histogram i32[T, 1, nbins] of the
    wire-cast scores of valid rows of active slots; bin = count of edges
    <= s (searchsorted side="right"); NaN scores dropped."""
    t, b = scores.shape
    nbins = edges.shape[0] + 1
    sf = scores.to(torch.float32)
    bins = torch.searchsorted(edges, sf.contiguous(), right=True)
    keep = (
        active.to(torch.bool)[:, None]
        & row_mask(scores.shape, counts, mask)
        & ~torch.isnan(sf)
    )
    bins = torch.where(keep, bins, nbins)
    flat = (torch.arange(t, device=scores.device)[:, None] * (nbins + 1) + bins)
    hist = torch.zeros((t * (nbins + 1),), dtype=torch.int32, device=scores.device)
    hist.index_add_(0, flat.reshape(-1), torch.ones_like(flat.reshape(-1), dtype=torch.int32))
    return hist.reshape(t, nbins + 1)[:, None, :nbins]


def score_sketch(scores, active, edges, counts=None, mask=None) -> torch.Tensor:
    """Kernel KH over scores [T, B]; CPU tensors take the plain version."""
    if not scores.is_cuda:
        return score_sketch_plain(scores, active, edges, counts, mask)
    if (counts is None) == (mask is None):
        raise ValueError("pass exactly one of counts and mask")
    t, b = scores.shape
    nbins = edges.shape[0] + 1
    # inputs bound to names: they must outlive the launch
    scores = scores.contiguous()
    active = active.to(torch.bool).contiguous()
    counts = None if counts is None else counts.to(torch.int32).contiguous()
    mask = None if mask is None else mask.to(torch.bool).contiguous()
    edges = edges.to(torch.float32).contiguous()
    out = torch.empty((t, 1, nbins), dtype=torch.int32, device=scores.device)
    p = kernels.ptr
    kernels.launch(
        "score_sketch", p(scores), VAL_KINDS[scores.dtype], p(active),
        p(counts), p(mask), p(edges), edges.shape[0], p(out), t, b,
        kernels.stream_handle(scores.device),
    )
    return out


# -- kernel KG: row compaction ------------------------------------------------------

def gather_rows_plain(scores, counts, size: int) -> torch.Tensor:
    """Plain version of KG: the valid rows of every lane (lane l holds
    ``counts`` of them at its front) in (slot, lane position) order, in a
    NaN-filled vector of ``size`` (rows past ``size`` dropped)."""
    t, l = scores.shape
    d = counts.shape[1]
    b = l // d
    lanepos = torch.arange(b, dtype=torch.int32, device=scores.device)
    valid = (lanepos[None, None, :] < counts[:, :, None]).reshape(-1)
    pos = torch.cumsum(valid.to(torch.int64), 0) - 1
    out = torch.full((size,), float("nan"), dtype=scores.dtype, device=scores.device)
    keep = valid & (pos < size)
    out[pos[keep]] = scores.reshape(-1)[keep]
    return out


def gather_rows(scores, counts, size: int) -> torch.Tensor:
    """Kernel KG over scores [T, D*B] and counts i32[T, D]; CPU tensors
    take the plain version."""
    if not scores.is_cuda:
        return gather_rows_plain(scores, counts, size)
    t, l = scores.shape
    d = counts.shape[1]
    scores = scores.contiguous()
    counts = counts.to(torch.int32).contiguous()
    out = torch.empty((size,), dtype=scores.dtype, device=scores.device)
    kernels.launch(
        "gather_rows", kernels.ptr(scores), VAL_KINDS[scores.dtype],
        kernels.ptr(counts), t * d, l // d, kernels.ptr(out), size,
        kernels.stream_handle(scores.device),
    )
    return out


# -- the scorer ------------------------------------------------------------------------

class ShardedScorer:
    """Stacked multi-tenant scoring of one model family on one device.

    ``step_counts`` (the service hot path) and ``step`` (mask mode) run one
    flush through KW, the family's flush-form scorer (KS, KD, or the
    transformer's KE..KN) and KH and return the score plane;
    ``gather_rows`` compacts it with KG. Window state is updated in
    place."""

    # smallest compacted-gather size: flushes with fewer rows pad up to it
    GATHER_FLOOR = 2048

    def __init__(
        self,
        mm: MeshManager,
        spec: ModelSpec,
        cfg,
        slots_per_shard: int = 8,
        max_streams: int = 4096,
        window: int = 32,
        seed: int = 0,
        wire_dtype: str = "f32",
        fuse_k: int = 1,
        param_dtype: str = "f32",
        base_params: Optional[Params] = None,
        plain: bool = False,
    ) -> None:
        """``base_params`` (a single-slot tree of tensors or numpy arrays,
        e.g. carried from the JAX package) is what every slot starts from
        and ``reset_slot`` restores; None draws it from ``seed``.
        ``plain`` runs the plain PyTorch versions instead of the kernels."""
        if spec.score_flush is None or spec.score_flush_plain is None:
            raise ValueError(f"model '{spec.name}' has no flush-form scorer")
        if param_dtype not in PARAM_DTYPES:
            raise ValueError(
                f"param_dtype must be one of {PARAM_DTYPES}, got {param_dtype!r}"
            )
        if int(fuse_k) < 1:
            raise ValueError(f"fuse_k must be >= 1, got {fuse_k}")
        if wire_dtype not in WIRE_TORCH:
            raise ValueError(f"wire_dtype must be f32|bf16|f16, got {wire_dtype}")
        self.mm = mm
        self.device = mm.device
        self.spec = spec
        self.cfg = cfg
        self.plain = bool(plain) or self.device.type == "cpu"
        self.fuse_k = int(fuse_k)
        self.k_steps = clamp_fuse_k(self.fuse_k, window)
        self.param_dtype = param_dtype
        self._kernel_params = None
        self._kernel_dirty = True
        self.nbins = SKETCH_NBINS
        self.sketch_edges = sketch_edges(*spec.score_range, self.nbins)
        self._edges = torch.from_numpy(self.sketch_edges).to(self.device)
        self.last_sketch: Optional[DeviceArray] = None
        self.slots_per_shard = slots_per_shard
        self.n_slots = mm.n_tenant_shards * slots_per_shard
        self.max_streams = max_streams
        self.window = window
        # wire format of step_counts: u16 ids when the capacity fits, values
        # and scores in the tenant's wire dtype (bf16 as raw uint16 bits)
        self.wire_dtype = wire_dtype
        self.ids_np_dtype = np.uint16 if max_streams <= 65536 else np.int32
        self.vals_np_dtype = {
            "f32": np.float32, "bf16": np.uint16, "f16": np.float16,
        }[wire_dtype]
        if base_params is None:
            gen = torch.Generator().manual_seed(int(seed))
            base = spec.init(gen, cfg, device=self.device)
        else:
            base = tree_map(
                lambda x: (
                    x if isinstance(x, torch.Tensor)
                    else torch.from_numpy(np.array(x, copy=True))
                ).to(self.device),
                base_params,
            )
        self._base_params = base
        self.params = tree_map(
            lambda x: x[None].expand((self.n_slots,) + tuple(x.shape)).clone(),
            base,
        )
        self.state: WindowState = init_window_state(
            max_streams, window, device=self.device, n_slots=self.n_slots
        )
        self.active = torch.zeros((self.n_slots,), dtype=torch.bool, device=self.device)
        # which slots may train (tenants opt in), and each slot's learning
        # rate: the optimizer is scale_by_adam, the lr scales its update
        self.train_mask = torch.zeros((self.n_slots,), dtype=torch.bool, device=self.device)
        self.slot_lr = torch.ones((self.n_slots,), dtype=torch.float32, device=self.device)
        self._opt_state: Optional[AdamState] = None    # init_optimizer
        self._train_feed_state: Optional[WindowState] = None  # init_train_feed
        if self.device.type == "cuda":
            self._h2d = torch.cuda.Stream(self.device)
            self._d2h = torch.cuda.Stream(self.device)
        else:
            self._h2d = self._d2h = None
        self._ladders: Dict[int, List[int]] = {}

    # -- kernel param view -----------------------------------------------
    def kernel_params(self) -> Params:
        """The param tree the step consumes: the f32 master stack, or a
        lazily re-derived quantized tree for ``bf16``/``int8``, derived
        from the masters again after they change (``_set_slot``,
        ``train_resident``, ``commit_swap``). KS, KD and the
        transformer's KE and KN read the quantized tree as it is stored,
        the transformer's projections through ``kernel_weight`` (KQ for
        int8); training reads the f32 masters."""
        if self.param_dtype == "f32":
            return self.params
        if self._kernel_dirty or self._kernel_params is None:
            # quantize_params passes the f32 biases through by reference,
            # and the train steps update the masters in place: the view
            # keeps copies, so it serves the previous weights, biases
            # included, until the next derive (commit_swap)
            self._kernel_params = tree_map(
                lambda x: x.clone() if x.dtype == torch.float32 else x,
                quantize_params(self.params, self.param_dtype),
            )
            self._kernel_dirty = False
        return self._kernel_params

    # -- host buffers and h2d staging --------------------------------------
    def host_buffer(self, shape, np_dtype) -> np.ndarray:
        """A zeroed host array for flush staging; page-locked on the card,
        so ``stage_inputs`` copies it asynchronously."""
        if self.device.type != "cuda":
            return np.zeros(shape, np_dtype)
        np_dtype = np.dtype(np_dtype)
        raw = torch.zeros(
            (int(np.prod(shape)) * np_dtype.itemsize,), dtype=torch.uint8,
            pin_memory=True,
        )
        return raw.numpy().view(np_dtype).reshape(shape)

    @staticmethod
    def _host_tensor(a, role: str) -> torch.Tensor:
        """A host wire array as a CPU tensor sharing its memory: ids
        int32/uint16, values float32/float16 or bf16 bits (uint16),
        counts int32, mask bool."""
        a = np.ascontiguousarray(a)
        if role == "vals" and a.dtype == np.uint16:
            return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        if role == "ids" and a.dtype == np.uint16:
            return torch.from_numpy(a.view(np.int16)).view(torch.uint16)
        want = {
            "ids": (np.int32,), "vals": (np.float32, np.float16),
            "counts": (np.int32,), "mask": (np.bool_,),
        }[role]
        if a.dtype not in want:
            a = a.astype(want[0])
        return torch.from_numpy(a)

    def stage_inputs(self, stream_ids, values, counts):
        """Start one flush's host→device copy of its wire buffers and
        return (ids, vals, counts) ``DeviceArray``s for ``step_counts``.
        On the card the copy runs on the h2d stream and the step waits on
        its event, so flush N+1's copy overlaps flush N's step. The host
        buffers must stay unmodified until the returned arrays are ready
        (``_StagingSet.ensure_reusable``)."""
        hosts = [
            self._host_tensor(stream_ids, "ids"),
            self._host_tensor(values, "vals"),
            self._host_tensor(counts, "counts"),
        ]
        if self._h2d is None:
            return tuple(DeviceArray(h.clone()) for h in hosts)
        with torch.cuda.stream(self._h2d):
            devs = [h.to(self.device, non_blocking=True) for h in hosts]
            ready = torch.cuda.Event()
            ready.record(self._h2d)
        return tuple(
            DeviceArray(d, ready, self._d2h, source=h) for d, h in zip(devs, hosts)
        )

    @staticmethod
    def stage_nbytes(staged) -> int:
        """Host→device bytes one staged flush moves."""
        return int(sum(a.nbytes for a in staged))

    def _tensor(self, x, role: str) -> torch.Tensor:
        """An input on this scorer's device, ordered after its producer."""
        if isinstance(x, DeviceArray):
            t = x.tensor
            if t.is_cuda and x._ready is not None:
                cur = torch.cuda.current_stream(self.device)
                cur.wait_event(x._ready)
                t.record_stream(cur)
            return t
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        return self._host_tensor(x, role).to(self.device)

    def _result(self, t: torch.Tensor) -> DeviceArray:
        if t.is_cuda:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
            return DeviceArray(t, ready, self._d2h)
        return DeviceArray(t)

    # -- device-time accounting ----------------------------------------------
    def flops_per_row(self, b_lane: int = 0) -> float:
        """Analytic matmul FLOPs per lane row of one flush (heads on the
        last ``k_steps`` positions, quantized weights at their MAC width)."""
        fn = getattr(self.spec, "flops_per_row", None)
        if fn is None:
            return 0.0
        return float(fn(self.cfg, self.window, k=self.k_steps,
                        param_dtype=self.param_dtype))

    def flops_per_flush(self, b_lane: int) -> float:
        """FLOPs of the full padded plane (every slot x lane row)."""
        plane_rows = self.n_slots * self.mm.n_data_shards * int(b_lane)
        return plane_rows * self.flops_per_row(b_lane)

    @property
    def device_label(self) -> str:
        return self.mm.device_label

    # -- d2h result path (device-side row gather) ------------------------
    def gather_ladder(self, b_lane: int) -> List[int]:
        """Gather output sizes for one bucket's plane: powers of two from
        GATHER_FLOOR up to the full plane (cached per bucket)."""
        cached = self._ladders.get(b_lane)
        if cached is not None:
            return cached
        plane = self.n_slots * self.mm.n_data_shards * b_lane
        sizes: List[int] = []
        g = min(self.GATHER_FLOOR, plane)
        while g < plane:
            sizes.append(g)
            g *= 2
        sizes.append(plane)
        self._ladders[b_lane] = sizes
        return sizes

    def gather_rows(self, scores_dev, counts_dev, n_rows: int) -> DeviceArray:
        """Compact one flush's scored rows out of the [T, D*B] plane on the
        device (KG): a wire-dtype vector of the smallest ladder size >=
        ``n_rows``; entries past the rows are NaN."""
        scores = self._tensor(scores_dev, "vals")
        counts = self._tensor(counts_dev, "counts")
        t, l = scores.shape
        b_lane = l // self.mm.n_data_shards
        size = next(
            (s for s in self.gather_ladder(b_lane) if s >= n_rows), t * l
        )
        fn = gather_rows_plain if self.plain else gather_rows
        return self._result(fn(scores, counts, size))

    # -- the flush -----------------------------------------------------------
    def _flush(self, ids, vals, counts, mask, out_dtype) -> DeviceArray:
        if ids.shape[0] != self.n_slots or vals.shape != ids.shape:
            raise ValueError(
                f"flush must be [{self.n_slots}, B], got ids "
                f"{tuple(ids.shape)} values {tuple(vals.shape)}"
            )
        if self.plain:
            update, score, sketch_fn = (
                window_update_plain, self.spec.score_flush_plain, score_sketch_plain
            )
        else:
            update, score, sketch_fn = (
                window_update, self.spec.score_flush, score_sketch
            )
        later = update(self.state, ids, vals, counts, mask)
        scores = score(
            self.kernel_params(), self.cfg, self.state, ids, later,
            self.active, counts, mask, self.k_steps, out_dtype,
        )
        sketch = sketch_fn(scores, self.active, self._edges, counts, mask)
        self.last_sketch = self._result(sketch)
        return self._result(scores)

    def step(self, stream_ids, values, valid) -> DeviceArray:
        """Mask mode: score one stacked micro-batch ids i32[T, B], values
        f32[T, B], valid bool[T, B]; returns f32[T, B] scores."""
        return self._flush(
            self._tensor(stream_ids, "ids"), self._tensor(values, "vals"),
            None, self._tensor(valid, "mask"), torch.float32,
        )

    def step_counts(self, stream_ids, values, counts) -> DeviceArray:
        """Wire-thin flush: rows fill each lane from the front, so validity
        is one count per lane (counts i32[T, 1]); ids/values ride the wire
        dtypes and scores return in the wire dtype, [T, B]."""
        return self._flush(
            self._tensor(stream_ids, "ids"), self._tensor(values, "vals"),
            self._tensor(counts, "counts"), None, WIRE_TORCH[self.wire_dtype],
        )

    def prewarm(self, lane_sizes) -> None:
        """Run every bucketed flush shape once with zero lane counts (state
        untouched): builds the kernels and settles every gather rung, so no
        first-use cost lands inside the scoring loop."""
        t, d = self.n_slots, self.mm.n_data_shards
        for b in sorted(set(int(x) for x in lane_sizes)):
            staged = self.stage_inputs(
                self.host_buffer((t, d * b), self.ids_np_dtype),
                self.host_buffer((t, d * b), self.vals_np_dtype),
                self.host_buffer((t, d), np.int32),
            )
            s = self.step_counts(*staged)
            np.asarray(s)
            for g in self.gather_ladder(b):
                np.asarray(self.gather_rows(s, staged[2], g))
            np.asarray(self.last_sketch)

    # -- slot management -----------------------------------------------------
    def _set_slot(self, global_slot: int, params: Params) -> None:
        """Write a single-slot tree (tensors or numpy arrays, the stacked
        tree's structure: nested dicts and lists) into one slot."""
        def put(stacked, p):
            if not isinstance(p, torch.Tensor):
                p = torch.from_numpy(np.asarray(p))
            stacked[global_slot].copy_(p.to(self.device, stacked.dtype))

        tree_map(put, self.params, params)
        self._kernel_dirty = True

    def activate(
        self, global_slot: int, params: Optional[Params] = None,
        trainable: bool = True, lr: Optional[float] = None,
    ) -> None:
        """Start scoring a slot, optionally with new params (a single-slot
        tree of tensors or numpy arrays) written into it; ``trainable``
        lets the train steps move it, at learning rate ``lr`` (None keeps
        the slot's)."""
        if params is not None:
            self._set_slot(global_slot, params)
        self.active[global_slot] = True
        self.train_mask[global_slot] = bool(trainable)
        if lr is not None:
            self.slot_lr[global_slot] = float(lr)

    def deactivate(self, global_slot: int) -> None:
        self.active[global_slot] = False
        self.train_mask[global_slot] = False

    def reset_slot(self, global_slot: int) -> None:
        """Wipe a slot's window state, params, Adam moments and step count,
        and train-feed rings back to pristine: a recycled slot must not
        leak the previous tenant's history, trained weights or momentum."""
        self.deactivate(global_slot)
        self.slot_lr[global_slot] = 1.0
        self._set_slot(global_slot, self._base_params)
        for st in (self.state, self._train_feed_state):
            if st is not None:
                st.values[global_slot] = 0.0
                st.pos[global_slot] = 0
                st.count[global_slot] = 0
        if self._opt_state is not None:
            self._opt_state.count[global_slot] = 0
            for x in tree_leaves((self._opt_state.mu, self._opt_state.nu)):
                x[global_slot] = 0.0

    def slot_params(self, global_slot: int) -> Params:
        return tree_map(lambda x: x[global_slot].clone(), self.params)

    # -- training (per-tenant divergence) -------------------------------------
    def init_optimizer(self, optimizer=None) -> None:
        """Attach the optimizer: optax's ``scale_by_adam`` defaults, its
        state stacked per slot like the params, the per-slot learning rates
        ``slot_lr`` applied inside the train step. Only this default is
        ported: a custom optimizer raises (ROADMAP queue 1), as does a
        family with no train form."""
        if optimizer is not None:
            raise NotImplementedError(
                "the port trains with the default scale_by_adam only; custom "
                "optimizers are not ported (ROADMAP queue 1)"
            )
        if self.spec.loss_ring is None or self.spec.loss_stacked_plain is None:
            raise NotImplementedError(
                f"model '{self.spec.name}' has no train form in the port yet "
                "(ROADMAP queue 1)"
            )
        self._opt_state = init_adam(self.params, self.n_slots)

    def _require_optimizer(self) -> AdamState:
        if self._opt_state is None:
            raise RuntimeError("call init_optimizer() first")
        return self._opt_state

    def _train_mask(self, slots_mask) -> torch.Tensor:
        mask = self.active & self.train_mask
        if slots_mask is not None:
            mask = mask & self._tensor(slots_mask, "mask").to(torch.bool)
        return mask

    # device bytes a kernel train step's saved activations may take: the
    # step differentiates the slots a chunk at a time (the family's
    # train_bytes_per_row sizes it; the plain twin's chunk is the family's
    # plain_train_rows). Slots are independent, so every chunking gives the
    # same gradients; the recurrent families at 32 x 8,192 rows fit one chunk
    TRAIN_SAVE_BYTES = 40_000_000_000

    def train_chunk_slots(self) -> int:
        """Slots one train step differentiates at once: as many as keep the
        kernel path's saves under ``TRAIN_SAVE_BYTES`` (the plain twin: the
        family's ``plain_train_rows``), at least one."""
        if self.plain:
            chunk = self.spec.plain_train_rows // self.max_streams
        else:
            fn = self.spec.train_bytes_per_row
            per_slot = self.max_streams * (fn(self.cfg, self.window) if fn else 0)
            chunk = self.TRAIN_SAVE_BYTES // per_slot if per_slot else self.n_slots
        return max(1, min(chunk, self.n_slots))

    def _train_step(self, state: WindowState, mask: torch.Tensor) -> torch.Tensor:
        """One optimizer step for the slots in ``mask`` on the windows of
        ``state``, with the reference's fused train step's semantics
        (``sharded.py:1111-1187``; its per-slot legacy twin ``:1018``
        gives the same): the row mask ``(n >= min(W, 8)) * mask``, the
        per-slot mean ``sum(loss * m) / max(sum(m), 1)``, one backward of
        their sum, then the Adam step (KO, or its plain version for the
        plain twin). Returns the per-slot loss f32[T]."""
        opt = self._require_optimizer()
        n = state.count.clamp(max=self.window)
        rows = (n >= min(self.window, 8)).to(torch.float32) * mask.to(torch.float32)[:, None]
        losses = torch.zeros((self.n_slots,), dtype=torch.float32, device=self.device)
        grads = tree_map(torch.zeros_like, self.params)
        chunk = self.train_chunk_slots()
        for lo in range(0, self.n_slots, chunk):
            sl = slice(lo, min(lo + chunk, self.n_slots))
            leaves = tree_map(lambda x: x[sl].detach().requires_grad_(True), self.params)
            ring = WindowState(*(x[sl] for x in state))
            if self.plain:
                per_row = self.spec.loss_stacked_plain(leaves, self.cfg, ring_windows(ring))
            else:
                per_row = self.spec.loss_ring(leaves, self.cfg, ring)
            m = rows[sl]
            per_slot = (per_row * m).sum(-1) / torch.clamp_min(m.sum(-1), 1.0)
            flat = tree_leaves(leaves)
            for g, d in zip(torch.autograd.grad(per_slot.sum(), flat), tree_leaves(grads)):
                d[sl] = g
            losses[sl] = per_slot.detach()
        update = adam_update_plain if self.plain else adam_update
        update(self.params, grads, opt, self.slot_lr, mask)
        return losses

    def train_resident(self, slots_mask=None) -> DeviceArray:
        """One optimizer step for every trainable active slot on its
        resident serve windows (``slots_mask`` bool[T] restricts further);
        returns the per-slot loss f32[T]. The live weights changed, so the
        kernel view is re-derived before the next flush."""
        losses = self._train_step(self.state, self._train_mask(slots_mask))
        self._kernel_dirty = True
        return self._result(losses)

    def train_lane_step(self, slots_mask=None, replay: bool = False) -> DeviceArray:
        """One train-lane step on the resident serve windows
        (``replay=False``) or the replay-fed feed rings (``replay=True``);
        returns the per-slot loss f32[T]. Unlike ``train_resident`` it
        leaves the kernel view alone: the lane's updates reach a
        bf16/int8 kernel view at ``commit_swap`` (f32 stacks score from the
        master weights, which the step updates in place)."""
        if replay and self._train_feed_state is None:
            raise RuntimeError("call init_train_feed() before a replay step")
        state = self._train_feed_state if replay else self.state
        return self._result(self._train_step(state, self._train_mask(slots_mask)))

    def init_train_feed(self) -> None:
        """Allocate the replay-fed train rings, ``[T, S, W]`` like the
        serve state (lazy: only a scorer with a replay-fed tenant pays)."""
        if self._train_feed_state is None:
            self._train_feed_state = init_window_state(
                self.max_streams, self.window, device=self.device, n_slots=self.n_slots
            )

    def train_feed_ingest(self, stream_ids, values, counts) -> None:
        """Scatter one staged replay microbatch (the ``step_counts`` wire:
        ids and values [T, B], lane counts i32[T, 1]) into the feed rings in
        place: KW in counts mode, with no score, sketch or gather."""
        self.init_train_feed()
        update = window_update_plain if self.plain else window_update
        update(self._train_feed_state, self._tensor(stream_ids, "ids"),
               self._tensor(values, "vals"), self._tensor(counts, "counts"))

    def prewarm_train_lane(self, lane_sizes=()) -> None:
        """Build the train lane's kernels before traffic with no effect: a
        zero-count ingest per lane size and one all-False-mask step on each
        ring set (the freeze passes params and Adam state through
        bitwise). Call ``init_optimizer`` first."""
        self._require_optimizer()
        self.init_train_feed()
        t, d = self.n_slots, self.mm.n_data_shards
        for b in sorted(set(int(x) for x in lane_sizes)) or [64]:
            self.train_feed_ingest(*self.stage_inputs(
                np.zeros((t, d * b), self.ids_np_dtype),
                np.zeros((t, d * b), self.vals_np_dtype),
                np.zeros((t, d), np.int32),
            ))
        none = np.zeros((self.n_slots,), bool)
        for replay in (False, True):
            np.asarray(self.train_lane_step(none, replay=replay))

    def commit_swap(self) -> None:
        """The train lane's between-flush weight commit: the steps updated
        the master stack in place, so committing re-derives the kernel
        view (for bf16/int8 stacks scoring keeps the previous weights until
        this runs). The reference also arms the shadow canary here; the
        canary comes with ROADMAP queue 1 item 4."""
        self._kernel_dirty = True

    def slot_opt_state(self, global_slot: int) -> Optional[AdamState]:
        """One slot's Adam state as host numpy copies (count an i32
        scalar array); None while no optimizer is attached."""
        if self._opt_state is None:
            return None
        return AdamState(*(
            tree_map(lambda x: x[global_slot].detach().cpu().numpy().copy(), part)
            for part in self._opt_state
        ))

    def restore_slot_opt(self, global_slot: int, opt) -> None:
        """Write one slot's saved Adam state back (numpy or tensors, the
        ``slot_opt_state`` layout or the reference's ``ScaleByAdamState``),
        so a paged-in tenant resumes mid-descent. No-op when either side
        has none."""
        if opt is None or self._opt_state is None:
            return

        def put(live, saved):
            if not isinstance(saved, torch.Tensor):
                saved = torch.from_numpy(np.array(saved, copy=True))
            live[global_slot].copy_(saved.to(self.device, live.dtype))

        for live, saved in zip(self._opt_state, opt):
            tree_map(put, live, saved)

    def train_flops_per_step(self) -> float:
        """Analytic matmul FLOPs of one train step: every slot x stream row
        runs the teacher-forced loss, forward and backward (3x the
        forward's matmul work), live or not (``sharded.py:1336-1349``)."""
        fn = getattr(self.spec, "flops_per_row", None)
        if fn is None:
            return 0.0
        return 3.0 * self.n_slots * self.max_streams * float(fn(self.cfg, self.window))
