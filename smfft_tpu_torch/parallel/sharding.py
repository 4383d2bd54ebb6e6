"""Batch sharding of FFT workloads over the ranks of a device mesh.

Counterpart of ``smfft_tpu/parallel/sharding.py``.  The reference's only
parallelism is one FFT per CUDA block over a grid
(FFT-GPU-32bit.cu:586-595) in a single GPU.  Its scale-out is data
parallelism over the batch axis: each rank runs the same kernel on its
rows, there is no cross-FFT data flow, and no collective is called.

The mesh is a 1-D :class:`~torch.distributed.device_mesh.DeviceMesh` over
the ranks of the default process group; a sharded array is a
:class:`~torch.distributed.tensor.DTensor` whose batch axis is placed as
``Shard(0)`` (``Shard(1)`` for a bank's output).  These are PyTorch's
counterparts of JAX's ``Mesh``, ``NamedSharding`` and ``PartitionSpec``.

Usage, one process a rank (``torchrun --nproc-per-node=<cards>``):
    mesh = batch_mesh()                       # every rank on axis "batch"
    y = sharded_fft(x, mesh)                  # x: (B, N), B % ranks == 0
    y.to_local()                              # this rank's B/ranks rows

Each ``sharded_*`` call runs the package's own transform (``api.fft`` ...)
on the rank's local rows: a CUDA mesh launches the kernel, a CPU mesh runs
its plain version.  The process group must exist before the mesh is made
(``torch.distributed.init_process_group``; ``torchrun`` sets the
environment it reads).
"""

from __future__ import annotations

import collections
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Placement, Shard


def _mesh_size(mesh: DeviceMesh, axis_name: str) -> int:
    """The number of ranks along ``axis_name`` (the JAX error text when
    the mesh has no such axis)."""
    names = mesh.mesh_dim_names or ()
    shape = collections.OrderedDict(zip(names, mesh.shape))
    if axis_name not in shape:
        raise ValueError(f"mesh has no axis {axis_name!r}: {shape}")
    return shape[axis_name]


def _mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device a rank of ``mesh`` keeps its shards on: the CPU, or the
    card this process selected (``batch_mesh`` selects it)."""
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    raise ValueError(f"unsupported mesh device type {mesh.device_type!r}")


def _rank(mesh: DeviceMesh, axis_name: str) -> int:
    """This process's index along the mesh axis (``lax.axis_index``)."""
    return mesh.get_local_rank(axis_name)


def batch_mesh(devices=None, axis_name: str = "batch") -> DeviceMesh:
    """1-D mesh over every rank of the default process group, batch axis
    only.

    ``devices`` is the device type the shards live on: ``None`` or
    ``"cuda"`` (one rank a card: the rank's ``LOCAL_RANK``, as torchrun
    sets it, else its global rank, modulo the cards this host has) or
    ``"cpu"``.  A CUDA mesh without a card raises; the CPU is used only
    when asked for."""
    device_type = "cuda" if devices is None else devices
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"devices must be None, 'cuda' or 'cpu', got "
                         f"{devices!r}")
    if not dist.is_initialized():
        raise RuntimeError(
            "batch_mesh needs the default process group: call "
            "torch.distributed.init_process_group (or run under torchrun) "
            "first")
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for a 'cuda' mesh; pass "
                               "devices='cpu' to shard over the CPU")
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(local % torch.cuda.device_count())
    world = dist.get_world_size()
    return DeviceMesh(device_type, torch.arange(world),
                      mesh_dim_names=(axis_name,))


def _full(x: DTensor) -> torch.Tensor:
    """The global value of a DTensor on a 1-D mesh, on every rank: its
    shards gathered with the c10d ``all_gather`` on the mesh's group, or
    the local tensor of a replicated one.  (DTensor's own ``full_tensor``
    and ``redistribute`` run functional collectives, which crash under
    gloo on CUDA tensors with torch 2.11.0+cu128; the c10d collectives
    do not.)"""
    if len(x.placements) != 1:
        raise ValueError(f"expected a DTensor on a 1-D mesh, got "
                         f"placements {x.placements}")
    (p,) = x.placements
    local = x.to_local()
    if p.is_replicate():
        return local
    if not isinstance(p, Shard):
        raise ValueError(f"unsupported placement {p}")
    mesh = x.device_mesh
    parts = [torch.empty_like(local) for _ in range(mesh.size())]
    dist.all_gather(parts, local.contiguous(),
                    group=mesh.get_group(mesh.mesh_dim_names[0]))
    return torch.cat(parts, dim=p.dim)


def _block(x: torch.Tensor, mesh: DeviceMesh, axis_name: str,
           dim: int) -> torch.Tensor:
    """This rank's contiguous block of ``x`` along ``dim`` on the mesh's
    device.  A plain tensor is the same global value on every rank: each
    rank slices its block, with no communication.  A DTensor placed
    ``Shard(dim)`` is its local block; any other is gathered whole
    (:func:`_full`) and sliced."""
    d = _mesh_size(mesh, axis_name)
    dim = dim % x.dim()
    if isinstance(x, DTensor):
        if x.placements == (Shard(dim),):
            return x.to_local()
        x = _full(x)
    size = x.shape[dim]
    if size % d:
        raise ValueError(
            f"the global size of dimension {dim} should be divisible by "
            f"{d} (the {d}-rank mesh axis {axis_name!r}), but it is equal "
            f"to {size} (full shape: {tuple(x.shape)})")
    c = size // d
    return x.narrow(dim, _rank(mesh, axis_name) * c, c).to(
        _mesh_device(mesh))


def _sharded(local: torch.Tensor, mesh: DeviceMesh,
             placement: Placement) -> DTensor:
    """Wrap this rank's block as the global DTensor (even shards)."""
    return DTensor.from_local(local, mesh, [placement], run_check=False)


def _replicated(h: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """The whole of ``h`` on this rank (a filter or a bank)."""
    if isinstance(h, DTensor):
        h = _full(h)
    return h.to(_mesh_device(mesh))


def shard_batch(x: torch.Tensor, mesh: DeviceMesh,
                axis_name: str = "batch") -> DTensor:
    """Place x with its leading axis sharded over the mesh (``Shard(0)``).
    The leading axis must be divisible by the mesh size, as in JAX."""
    return _sharded(_block(x, mesh, axis_name, 0), mesh, Shard(0))


def sharded_fft(x: torch.Tensor, mesh: DeviceMesh, *, inverse: bool = False,
                ordered: bool = True, backend: str = "auto",
                precision: str = "highest", axis_name: str = "batch"):
    """Batched C2C FFT with the batch axis sharded across the mesh: each
    rank runs ``api.fft`` / ``api.ifft`` (one kernel launch) on its
    (B/ranks, N) rows."""
    from smfft_tpu_torch import api

    fn = api.ifft if inverse else api.fft
    out = fn(_block(x, mesh, axis_name, 0), ordered=ordered,
             backend=backend, precision=precision)
    return _sharded(out, mesh, Shard(0))


def sharded_rfft(x: torch.Tensor, mesh: DeviceMesh, *, backend: str = "auto",
                 precision: str = "highest", axis_name: str = "batch"):
    """Batched R2C with the batch axis sharded across the mesh."""
    from smfft_tpu_torch import api

    out = api.rfft(_block(x, mesh, axis_name, 0), backend=backend,
                   precision=precision)
    return _sharded(out, mesh, Shard(0))


def sharded_convolve(x: torch.Tensor, h: torch.Tensor, mesh: DeviceMesh, *,
                     backend: str = "auto", precision: str = "highest",
                     axis_name: str = "batch"):
    """Fused circular convolution with the batch axis sharded across the
    mesh and the filter (or (M, N) bank) replicated to every rank — the
    batch-parallel matched-filter shape: no collective on the signals,
    each rank convolves its local rows against the full bank.  A bank
    gives (M, B, N) sharded on dim 1."""
    from smfft_tpu_torch import api

    out = api.convolve(_block(x, mesh, axis_name, 0), _replicated(h, mesh),
                       backend=backend, precision=precision)
    return _sharded(out, mesh, Shard(1 if h.dim() == 2 else 0))


def sharded_irfft(spec_arr: torch.Tensor, mesh: DeviceMesh, n: int, *,
                  backend: str = "auto", precision: str = "highest",
                  norm: str | None = "backward",
                  axis_name: str = "batch"):
    """Batched C2R inverse with the batch axis sharded across the mesh.
    ``norm`` is "backward" or None; the port's ``irfft`` raises on any
    other (the JAX package reads them as None: ROADMAP C.3)."""
    from smfft_tpu_torch import api

    out = api.irfft(_block(spec_arr, mesh, axis_name, 0), n=n,
                    backend=backend, precision=precision, norm=norm)
    return _sharded(out, mesh, Shard(0))
