"""The device mesh of the port (``sitewhere_tpu/parallel/mesh.py``).

This slice serves from one device: one tenant shard and one data shard,
so every stacked tenant slot and every stream lives on ``device``. The
class keeps the JAX MeshManager's surface that the scorer reads
(``n_tenant_shards``, ``n_data_shards``, ``n_devices``) and is the seam the
multi-GPU slice fills later (ROADMAP queue 1, slice F).

The device defaults to ``"cuda"``; with no card present construction
raises (pass ``device="cpu"`` to run the plain PyTorch versions). It never
falls back to the CPU on its own.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions of the kernels"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"device must be cuda or cpu, got {device!r}")
    return dev


class MeshManager:
    """One device: ``n_tenant_shards == n_data_shards == 1``."""

    n_tenant_shards = 1
    n_data_shards = 1
    n_devices = 1

    def __init__(self, device="cuda") -> None:
        self.device = resolve_device(device)

    @property
    def device_label(self) -> str:
        """Metric label of the device (``"cuda:0"`` / ``"cpu:0"``)."""
        return f"{self.device.type}:{self.device.index or 0}"
