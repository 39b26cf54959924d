"""Mesh construction for the inner axes of one replica group.

The port of ``torchft_tpu/parallel/mesh.py``. Axes, in physical-locality
order (outermost = slowest-varying over the device order):

- ``dp``   pure data parallelism,
- ``pp``   pipeline parallelism,
- ``fsdp`` sharded data parallelism,
- ``ep``   expert parallelism,
- ``sp``   sequence/context parallelism (ring or Ulysses attention over
  this axis),
- ``tp``   tensor parallelism (innermost).

The axes are of two kinds.

- ``dp`` and ``fsdp`` are **process axes**: a replica group is
  ``WORLD_SIZE`` processes, one device each, as torchrun launches them
  (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``). They form a torch
  ``DeviceMesh`` over ("dp", "fsdp") (:func:`group_device_mesh`), over which
  FSDP2 shards parameters and AdamW state (``parallel/sharding.py``,
  ``parallel/train.py``); each rank holds its rows of every batch.
- ``pp``, ``ep``, ``sp`` and ``tp`` are **in-process axes**: a
  :class:`Mesh` is an array of ``torch.device``, and a process runs the
  ranks of these axes one after another over its own devices. A device may
  appear more than once: a mesh of one card repeated stands in for the JAX
  package's virtual host devices, so the ring and Ulysses run their ``sp``
  ranks, and the pipeline its ``pp`` stages, on that card. ``tp`` and
  ``ep`` above 1 raise (``sharding.TP_EP_ITEM``).

A group's :class:`Mesh` (:func:`group_mesh`) names this process's device at
every coordinate of the process axes and carries the process's rank over
them (``process_rank``). The fault-tolerant replica axis is not a mesh
axis: it is the Manager's (``device_mesh.py``).
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

MESH_AXES = ("dp", "pp", "fsdp", "ep", "sp", "tp")
# Axes over the processes of a replica group (torch DeviceMesh, FSDP2); the
# others run inside each process.
PROCESS_AXES = ("dp", "fsdp")


class Mesh:
    """``devices``: an object array of ``torch.device`` with one dim per
    name in ``axis_names``. ``shape`` maps each axis to its size, in axis
    order, as ``jax.sharding.Mesh.shape`` does. ``process_rank``: this
    process's rank over the process axes (row-major over dp, fsdp) in a
    group of processes; None for a mesh one process holds whole."""

    def __init__(
        self,
        devices: np.ndarray,
        axis_names: Sequence[str],
        process_rank: Optional[int] = None,
    ) -> None:
        if devices.ndim != len(axis_names):
            raise ValueError(
                f"devices have {devices.ndim} dims for axes {tuple(axis_names)}"
            )
        self.devices = devices
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.process_rank = process_rank

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along ``axis``, at index 0 of every other axis: the
        ranks of a ring, a Ulysses all-to-all or a pipeline over it."""
        i = self.axis_names.index(axis)
        return [
            self.devices[tuple(j if a == i else 0 for a in range(self.devices.ndim))]
            for j in range(self.devices.shape[i])
        ]

    def process_coordinate(self) -> Dict[str, int]:
        """This process's coordinate on the process axes (all 0 for a mesh
        one process holds whole)."""
        shape = [self.shape.get(a, 1) for a in PROCESS_AXES]
        coords = np.unravel_index(self.process_rank or 0, shape)
        return {a: int(c) for a, c in zip(PROCESS_AXES, coords)}

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={sorted({str(d) for d in self.devices.flat})})"


def _visible_devices() -> list:
    if not torch.cuda.is_available():
        raise ValueError(
            "no CUDA device visible: pass devices= (a list of torch.device, "
            "e.g. [torch.device('cpu')] * n)"
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(
    dp: int = 1,
    fsdp: int = 1,
    sp: int = 1,
    tp: int = 1,
    ep: int = 1,
    pp: int = 1,
    devices: Optional[Sequence[torch.device]] = None,
) -> Mesh:
    """A mesh of the first dp*pp*fsdp*ep*sp*tp of ``devices`` (default:
    every visible CUDA device) in ``MESH_AXES`` order."""
    if devices is None:
        devices = _visible_devices()
    n = dp * pp * fsdp * ep * sp * tp
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    arr = np.empty(n, dtype=object)
    for i, d in enumerate(devices[:n]):
        arr[i] = torch.device(d)
    return Mesh(arr.reshape(dp, pp, fsdp, ep, sp, tp), MESH_AXES)


def make_multislice_mesh(
    num_slices: int,
    dp: int = 1,
    fsdp: int = 1,
    sp: int = 1,
    tp: int = 1,
    ep: int = 1,
    pp: int = 1,
    devices: Optional[Sequence[torch.device]] = None,
) -> Mesh:
    """A mesh over ``num_slices`` slices (islands of fast links joined by a
    slower network) with the slice dimension folded into the OUTERMOST
    ``dp`` coordinate: ``dp`` is the per-slice factor and the mesh has
    ``dp = num_slices * dp``, so only the dp gradient average crosses
    slices. The JAX package's device order; a ``torch.device`` carries no
    slice index, so slices are contiguous equal blocks of ``devices``, as
    the JAX package lays them out where devices have none."""
    if devices is None:
        devices = _visible_devices()
    per = dp * pp * fsdp * ep * sp * tp
    need = num_slices * per
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    arr = np.empty(need, dtype=object)
    for i, d in enumerate(devices[:need]):
        arr[i] = torch.device(d)
    return Mesh(arr.reshape(num_slices * dp, pp, fsdp, ep, sp, tp), MESH_AXES)


def auto_mesh(
    n_devices: Optional[int] = None,
    devices: Optional[Sequence[torch.device]] = None,
) -> Mesh:
    """Factor ``n_devices`` into a (dp, fsdp, sp, tp) mesh that exercises
    every axis it can: hands out prime factors largest-first, each to the
    currently-smallest axis, preferring fsdp > tp > sp > dp on ties (the
    JAX package's factoring)."""
    if devices is None:
        devices = _visible_devices()
    if n_devices is None:
        n_devices = len(devices)
    sizes = {"dp": 1, "fsdp": 1, "sp": 1, "tp": 1}
    priority = ("fsdp", "tp", "sp", "dp")

    def prime_factors(n: int) -> list:
        out, d = [], 2
        while d * d <= n:
            while n % d == 0:
                out.append(d)
                n //= d
            d += 1
        if n > 1:
            out.append(n)
        return sorted(out, reverse=True)

    for f in prime_factors(n_devices):
        target = min(priority, key=lambda a: (sizes[a], priority.index(a)))
        sizes[target] *= f
    return make_mesh(
        dp=sizes["dp"],
        fsdp=sizes["fsdp"],
        sp=sizes["sp"],
        tp=sizes["tp"],
        devices=devices,
    )


def group_mesh(
    world_size: int, rank: int, device: torch.device
) -> Mesh:
    """The mesh of a replica group of ``world_size`` processes as seen by
    process ``rank``: :func:`auto_mesh`'s factoring of ``world_size`` (the
    JAX trainer's ``auto_mesh(n_dev)``), ``device`` at every coordinate,
    and ``rank`` as its ``process_rank``. Raises where the factoring needs
    an in-process axis above 1 (4 ranks factor as fsdp 2 x tp 2): those axes
    take devices of this process, not ranks."""
    from torchft_tpu_torch.parallel.sharding import TP_EP_ITEM

    mesh = auto_mesh(world_size, devices=[device] * world_size)
    inner = [f"{a}={mesh.shape[a]}" for a in ("sp", "tp") if mesh.shape[a] > 1]
    if inner:
        raise NotImplementedError(
            f"a group of {world_size} ranks factors as {mesh.shape}: "
            f"{', '.join(inner)} would need tensor or sequence parallelism "
            f"across ranks ({TP_EP_ITEM}); run groups of 1, 2 or 3 ranks"
        )
    mesh.process_rank = rank
    return mesh


def group_env() -> Tuple[int, int]:
    """``(rank, world_size)`` of this process in its replica group, from
    torchrun's ``RANK`` and ``WORLD_SIZE`` (default 0 and 1)."""
    return int(os.environ.get("RANK", 0)), int(os.environ.get("WORLD_SIZE", 1))


def init_group(device: torch.device) -> Tuple[int, int]:
    """Joins this process to its replica group's torch world (the default
    process group) and returns :func:`group_env`. Backend NCCL for a CUDA
    device, gloo for the CPU.

    The world rendezvouses at ``GROUP_INIT_METHOD`` (an ``init_method`` URL:
    ``tcp://host:port`` or ``file:///path``), never at ``MASTER_PORT``:
    group rank 0's Manager binds its own store there. A world of one
    process needs no rendezvous and uses an in-process store."""
    import torch.distributed as dist

    rank, world = group_env()
    if dist.is_initialized():
        if (dist.get_rank(), dist.get_world_size()) != (rank, world):
            raise RuntimeError(
                f"the default process group is rank {dist.get_rank()} of "
                f"{dist.get_world_size()}, the environment says {rank} of {world}"
            )
        return rank, world
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    init = os.environ.get("GROUP_INIT_METHOD")
    if init is not None:
        dist.init_process_group(
            backend, init_method=init, rank=rank, world_size=world
        )
    elif world == 1:
        dist.init_process_group(
            backend, store=dist.HashStore(), rank=0, world_size=1
        )
    else:
        raise ValueError(
            f"a group of {world} ranks needs GROUP_INIT_METHOD (its torch "
            "world's rendezvous; MASTER_PORT is the Manager's store)"
        )
    return rank, world


def group_device_mesh(mesh: Mesh) -> Any:
    """The torch ``DeviceMesh`` over the process axes ("dp", "fsdp") of
    ``mesh``, on the default process group (:func:`init_group`), whose
    size must be their product."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape = tuple(mesh.shape[a] for a in PROCESS_AXES)
    if dist.get_world_size() != shape[0] * shape[1]:
        raise ValueError(
            f"a world of {dist.get_world_size()} ranks for process axes {shape}"
        )
    device_type = mesh.devices.flat[0].type
    return init_device_mesh(device_type, shape, mesh_dim_names=PROCESS_AXES)
