"""Ranks over ``torch.distributed``: the port's counterpart of a named mesh
axis under ``shard_map`` (the reference's ``ops/ring_attention.py``,
``ops/pipeline_parallel.py`` and the tensor-parallel block run their bodies
per device over one axis name).

``Axis`` is one rank's view of the axis: its ``rank`` (``lax.axis_index``)
and ``size`` (``lax.psum(1, axis)``), ``ppermute_next`` (``lax.ppermute``
with the perm ``(j, j + 1 mod n)``, a ``batch_isend_irecv`` ring), ``psum``
(``all_reduce``), ``all_gather`` (a global result from the ranks' blocks)
and ``block`` (the rank's block of a global array, a sharded in-spec).

``run_ranks(fn, n, backend, device, *args)`` starts ``n`` ranks with
``torch.multiprocessing.spawn`` around a ``FileStore`` in a temp dir, calls
``fn(axis, *args)`` on each, and returns each rank's result with the kernel
launches it made (``kernels.launches()``). Arguments and results travel
through files in that dir (``torch.save``), not through the processes'
pipes. ``run_jobs`` is an ``fn`` that runs several entry points in one
world, so a caller pays for one spawn.

The backend is the caller's choice and never switched: under NCCL tensors
go to the collectives as they are (one rank a GPU); under gloo the ranks
may share one device, ``all_reduce`` takes CUDA tensors directly, and
send/recv and all_gather, which gloo takes on CPU tensors only, go through
host buffers. A rank that raises fails the whole run (``spawn`` stops the
other ranks and raises in the caller); nothing is caught and retried.
"""

from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field
from datetime import timedelta
from typing import Any, Callable, Dict, List, Sequence

import numpy as np
import torch

BACKENDS = ("gloo", "nccl")
TIMEOUT_S = 600  # a collective that waits longer fails the run (a rank hung)


class Axis:
    """One rank's view of a named mesh axis: the default process group."""

    def __init__(self, rank: int, size: int, backend: str, device) -> None:
        self.rank, self.size, self.backend = rank, size, backend
        self.device = torch.device(device)

    def _staged(self, t: torch.Tensor) -> bool:
        """gloo's send/recv and all_gather take CPU tensors only."""
        return self.backend == "gloo" and t.is_cuda

    def block(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block of ``x`` along ``dim`` (``P(..., axis, ...)``)."""
        n = x.shape[dim]
        if n % self.size:
            raise ValueError(f"dim {dim} of size {n} does not split over {self.size} ranks")
        b = n // self.size
        return x.narrow(dim, self.rank * b, b)

    def ppermute_next(self, *tensors: torch.Tensor):
        """Each rank sends ``tensors`` to rank + 1 and receives rank - 1's
        (mod size): ``lax.ppermute`` with ``[(j, (j + 1) % n)]``. At size 1
        the perm is the identity."""
        import torch.distributed as dist

        if self.size == 1:
            return tuple(tensors)
        dst, src = (self.rank + 1) % self.size, (self.rank - 1) % self.size
        sends = [t.detach().cpu() if self._staged(t) else t.contiguous() for t in tensors]
        recvs = [torch.empty_like(s) for s in sends]
        ops = [dist.P2POp(dist.isend, s, dst, tag=i) for i, s in enumerate(sends)]
        ops += [dist.P2POp(dist.irecv, r, src, tag=i) for i, r in enumerate(recvs)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return tuple(r.to(t.device) for r, t in zip(recvs, tensors))

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks, on every rank (``lax.psum``)."""
        import torch.distributed as dist

        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out)
        return out

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' blocks concatenated along ``dim`` in rank order, on
        every rank (the global array of a sharded out-spec)."""
        import torch.distributed as dist

        if self.size == 1:
            return t
        x = t.detach().cpu() if self._staged(t) else t.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x)
        return torch.cat(parts, dim).to(t.device)


@dataclass
class Shard:
    """A ``run_jobs`` argument that each rank replaces by its block of
    ``x`` along ``dim`` (a sharded in-spec)."""

    x: Any
    dim: int


@dataclass
class Job:
    """One entry point a world runs: ``fn(axis=axis, **kwargs)``. With
    ``rank0_only`` the other ranks return None for it (a global result each
    rank holds alike)."""

    name: str
    fn: Callable
    kwargs: Dict[str, Any] = field(default_factory=dict)
    rank0_only: bool = False


def to_device(obj, device, axis: Axis = None):
    """``obj`` with every tensor and numpy array on ``device`` (and each
    ``Shard`` replaced by ``axis``'s block), through dicts, lists and
    tuples (named ones too)."""
    if isinstance(obj, Shard):
        return axis.block(to_device(obj.x, device), obj.dim).contiguous()
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(obj)).to(device)
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, dict):
        return {k: to_device(v, device, axis) for k, v in obj.items()}
    if isinstance(obj, list):
        return [to_device(v, device, axis) for v in obj]
    if isinstance(obj, tuple):
        items = [to_device(v, device, axis) for v in obj]
        return type(obj)(*items) if hasattr(obj, "_fields") else tuple(items)
    return obj


def run_jobs(axis: Axis, jobs: Sequence[Job]) -> Dict[str, dict]:
    """Run each job on this rank in order -> {name: {"out", "seconds",
    "launches", "variant_launches"}}: the output on the host, the wall time
    to the job's end on the device, and the kernel launches it made."""
    from sitewhere_tpu_torch import kernels

    results = {}
    for job in jobs:
        kwargs = to_device(job.kwargs, axis.device, axis)
        kernels.reset_launches()
        _sync(axis.device)
        t0 = time.perf_counter()
        out = job.fn(axis=axis, **kwargs)
        _sync(axis.device)
        seconds = time.perf_counter() - t0
        keep = axis.rank == 0 or not job.rank0_only
        results[job.name] = {"out": to_device(out, "cpu") if keep else None,
                             "seconds": seconds, "launches": kernels.launches(),
                             "variant_launches": kernels.variant_launches()}
    return results


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def rank_device(backend: str, device, rank: int) -> torch.device:
    """The device of ``rank``: under NCCL card ``rank`` (one rank a GPU, as
    NCCL requires); under gloo every rank on ``device`` (ranks may share a
    card)."""
    dev = torch.device(device)
    if dev.type == "cuda" and backend == "nccl":
        return torch.device("cuda", rank)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", 0)
    return dev


def _rank_main(rank: int, n: int, backend: str, device: str, tmp: str) -> None:
    import torch.distributed as dist

    from sitewhere_tpu_torch import kernels

    dev = rank_device(backend, device, rank)
    if dev.type == "cpu":
        torch.set_num_threads(1)  # n ranks share the host's cores
    else:
        torch.cuda.set_device(dev)
        # the plain versions' matmuls in full f32, as the reference's
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")  # ranks of one host
    store = dist.FileStore(os.path.join(tmp, "store"), n)
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, store=store, rank=rank, world_size=n,
                            timeout=timedelta(seconds=TIMEOUT_S), **kw)
    try:
        dist.barrier()  # every rank connected before any rank can fail
        fn, args = torch.load(os.path.join(tmp, "args.pt"), map_location="cpu",
                              weights_only=False, mmap=True)
        kernels.reset_launches()
        out = fn(Axis(rank, n, backend, dev), *args)
        _sync(dev)
        torch.save({"out": to_device(out, "cpu"), "launches": kernels.launches(),
                    "variant_launches": kernels.variant_launches()},
                   os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, n: int, backend: str, device, *args) -> List[dict]:
    """Start ``n`` ranks, call ``fn(axis, *args)`` on each and return, rank
    by rank, {"out", "launches", "variant_launches"}. ``fn`` must be a
    module-level function of an importable module (the port's: the ranks
    import torch and the port, nothing else). On a CUDA device the kernels
    are built here first, so the ranks load one library and no two
    ``nvcc`` builds race."""
    from sitewhere_tpu_torch import kernels
    from sitewhere_tpu_torch.parallel.mesh import resolve_device

    import torch.multiprocessing as mp

    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if n < 1:
        raise ValueError(f"a world has at least one rank, got {n}")
    dev = resolve_device(device)
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("NCCL runs ranks on CUDA devices (gloo on the CPU or a card)")
        if n > torch.cuda.device_count():
            raise ValueError(f"NCCL takes one rank a GPU: {n} ranks, "
                             f"{torch.cuda.device_count()} GPUs (gloo ranks may share one)")
    if dev.type == "cuda":
        kernels.load()
    with tempfile.TemporaryDirectory(prefix="sw_ranks_") as tmp:
        torch.save((fn, args), os.path.join(tmp, "args.pt"))
        mp.spawn(_rank_main, args=(n, backend, str(dev), tmp), nprocs=n, join=True)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(n)]
