"""Streaming media: device media streams + frame classification on the card —
the port of ``sitewhere_tpu/services/streaming_media.py``.

The stream registry (ordered chunk append and playback) is the
reference's. Classification runs the ViT-B/16 classifier (``models/vit.py``)
over camera frames: raw frames through kernel KP, the compressed wire's DCT
coefficients through kernel KJ, then the forward and kernel KT's softmax and
top-k, so only ``[B, k]`` comes back. The dispatch halves return the port's
``DeviceArray`` handles (``parallel/sharded.py``) with their device->host
copies already started; ``topk_results`` materializes them.

The service runs on ``device`` (default ``"cuda"``, which raises without a
card; pass ``"cpu"`` for the plain versions). ``decode_frame`` (PIL) waits
for the service slice (ROADMAP queue 1 item 7).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from sitewhere_tpu_torch.core.model import new_token
from sitewhere_tpu_torch.models import get_model
from sitewhere_tpu_torch.models import vit
from sitewhere_tpu_torch.models.common import tree_map, vit_flops_per_image
from sitewhere_tpu_torch.ops.dct import FrameLayout
from sitewhere_tpu_torch.parallel.sharded import DeviceArray


@dataclass
class MediaStream:
    stream_id: str
    assignment_token: str = ""
    content_type: str = "application/octet-stream"
    created_ts: int = field(default_factory=lambda: int(time.time() * 1000))
    chunks: List[Tuple[int, bytes]] = field(default_factory=list)  # (seq, data)

    @property
    def size_bytes(self) -> int:
        return sum(len(d) for _, d in self.chunks)


class StreamingMedia:
    """Per-tenant media chunk store + frame classification."""

    def __init__(self, tenant: str = "default", device="cuda",
                 generator: Optional[torch.Generator] = None) -> None:
        self.tenant = tenant
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: StreamingMedia classifies on the card; pass "
                "device='cpu' for the plain versions"
            )
        # the classifier's random init draws from this (a CPU generator)
        self.generator = generator if generator is not None else torch.Generator().manual_seed(0)
        self._streams: Dict[str, MediaStream] = {}
        self._classifier = None  # lazy (params are 86M for real B/16)
        self._classifier_tiny: Optional[bool] = None
        self._d2h = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

    # -- stream CRUD (reference surface) ---------------------------------
    def create_stream(
        self,
        assignment_token: str,
        stream_id: Optional[str] = None,
        content_type: str = "application/octet-stream",
    ) -> MediaStream:
        sid = stream_id or new_token("stream")
        if sid in self._streams:
            raise ValueError(f"stream '{sid}' exists")
        s = MediaStream(sid, assignment_token, content_type)
        self._streams[sid] = s
        return s

    def get_stream(self, stream_id: str) -> Optional[MediaStream]:
        return self._streams.get(stream_id)

    def list_streams(self, assignment_token: str = "") -> List[MediaStream]:
        return [
            s
            for s in self._streams.values()
            if not assignment_token or s.assignment_token == assignment_token
        ]

    def append_chunk(self, stream_id: str, seq: int, data: bytes) -> None:
        s = self._streams[stream_id]
        s.chunks.append((seq, data))

    def iter_chunks(self, stream_id: str) -> Iterator[bytes]:
        """Playback: chunks in sequence order (late arrivals sorted in)."""
        s = self._streams[stream_id]
        for _, data in sorted(s.chunks, key=lambda t: t[0]):
            yield data

    def get_chunk(self, stream_id: str, seq: int) -> Optional[bytes]:
        s = self._streams.get(stream_id)
        if s is None:
            return None
        for sq, data in s.chunks:
            if sq == seq:
                return data
        return None

    # -- frame classification ----------------------------------------------
    def _get_classifier(self, tiny: bool):
        if self._classifier is None:
            spec = get_model("vit_b16")
            cfg = vit.VIT_TINY_TEST if tiny else vit.VIT_B16
            params = spec.init(self.generator, cfg, device=self.device)
            self._classifier = (spec, cfg, params)
            self._classifier_tiny = tiny
        elif self._classifier_tiny != tiny:
            # one classifier per service instance: answering a B/16 request
            # with the tiny model (or the reverse) would be a wrong result,
            # not a fallback
            raise ValueError(
                f"classifier already initialized with tiny="
                f"{self._classifier_tiny}; requested tiny={tiny}"
            )
        return self._classifier

    def classifier_flops_per_frame(self, tiny: bool = False) -> float:
        """Analytic matmul FLOPs one frame costs through the classifier
        (``models.common.vit_flops_per_image``)."""
        return vit_flops_per_image(vit.VIT_TINY_TEST if tiny else vit.VIT_B16)

    def load_classifier_params(self, params, tiny: bool = False) -> None:
        """Install trained ViT params: a tree of tensors, or of numpy arrays
        (a JAX tree after ``np.asarray`` on each leaf), with the
        reference's keys."""
        spec, cfg, _ = self._get_classifier(tiny)
        params = tree_map(lambda a: (a if torch.is_tensor(a) else torch.from_numpy(
            np.array(a, copy=True))).to(self.device), params)
        self._classifier = (spec, cfg, params)

    def _handles(self, probs: torch.Tensor, ids: torch.Tensor) -> Tuple[DeviceArray, DeviceArray]:
        """Device handles of the top-k, their d2h copies started behind
        the work that produced them."""
        ready = None
        if probs.is_cuda:
            ready = torch.cuda.Event()
            ready.record()
        out = tuple(DeviceArray(t, ready, self._d2h) for t in (probs, ids))
        for a in out:
            a.copy_to_host_async()
        return out

    def classify_frames_dispatch(
        self, frames: np.ndarray, top_k: int = 5, tiny: bool = False
    ) -> Tuple[DeviceArray, DeviceArray]:
        """Dispatch one classify batch and START its device->host copy;
        returns ``(probs, ids)`` handles of shape [B, k].

        uint8 frames ship as they are and normalize ON the device (kernel
        KP; 4x less host->device traffic); float32 frames are taken as
        pre-normalized. The top-k reduces on the device (kernel KT, any
        ``top_k`` up to the class count, as the reference's
        ``jax.lax.top_k``), so only [B, k] comes back, copied
        asynchronously."""
        _, cfg, params = self._get_classifier(tiny)
        x = torch.from_numpy(np.ascontiguousarray(frames)).to(self.device)
        _, probs, ids = vit.classify(params, cfg, x, top_k)
        return self._handles(probs, ids)

    def classify_coeffs_dispatch(
        self,
        y_z: np.ndarray,
        cb_z: np.ndarray,
        cr_z: np.ndarray,
        layout: FrameLayout,
        top_k: int = 5,
        tiny: bool = False,
    ) -> Tuple[DeviceArray, DeviceArray]:
        """Compressed-wire classify dispatch: a truncated zigzag DCT
        coefficient batch (int16, ``layout.wire_bytes(B)`` bytes h2d) ->
        device top-k, the decode (dezigzag, IDCT, chroma upsample,
        YCbCr->RGB, normalize, patchify) fused into one kernel (KJ) ahead
        of the forward. Same async readback contract as
        ``classify_frames_dispatch``."""
        _, cfg, params = self._get_classifier(tiny)
        planes = [torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                  for a in (y_z, cb_z, cr_z)]
        _, probs, ids = vit.classify_dct(params, cfg, *planes, layout, top_k)
        return self._handles(probs, ids)

    @staticmethod
    def topk_results(pv, iv, n: Optional[int] = None) -> List[List[Tuple[int, float]]]:
        """Materialize a dispatched classify's output into per-frame top-k
        ``(class_id, probability)`` lists (first ``n`` frames). Blocks
        until the async copy lands."""
        pv = np.asarray(pv)
        iv = np.asarray(iv)
        if n is not None:
            pv, iv = pv[:n], iv[:n]
        return [
            [(int(i), float(p)) for i, p in zip(ir, pr)]
            for ir, pr in zip(iv, pv)
        ]

    def classify_frames(
        self, frames: np.ndarray, top_k: int = 5, tiny: bool = False
    ) -> List[List[Tuple[int, float]]]:
        """Synchronous dispatch + materialize (direct callers and tests)."""
        return self.topk_results(*self.classify_frames_dispatch(frames, top_k, tiny))

