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

- ``dp``, ``fsdp``, ``ep`` and ``tp`` are **process axes**: a replica
  group is ``WORLD_SIZE`` processes, one device each, as torchrun launches
  them (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``), a rank's coordinate
  row-major over them in ``MESH_AXES`` order. They form a torch
  ``DeviceMesh`` over ("dp", "fsdp", "ep", "tp") (:func:`group_device_mesh`).
  The tensor-parallel plan places the ``tp`` and ``ep`` dims of the
  parameters over their mesh dims, FSDP2 then shards the rest over
  (dp, fsdp) (``parallel/sharding.py``, ``parallel/train.py``); each rank
  holds the rows of every batch at its (dp, fsdp) coordinate, and the ranks
  that differ only in ``ep`` or ``tp`` hold the same rows.
- ``pp`` and ``sp`` are **in-process axes**: a :class:`Mesh` is an array of
  ``torch.device``, and a process runs the ranks of these axes one after
  another over its own devices. A device may appear more than once: a mesh
  of one card repeated stands in for the JAX package's virtual host
  devices, so the ring and Ulysses run their ``sp`` ranks, and the pipeline
  its ``pp`` stages, on that card. Placing them across ranks is not ported
  (``sharding.SP_PP_ITEM``).

"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

MESH_AXES = ("dp", "pp", "fsdp", "ep", "sp", "tp")
# Axes over the processes of a replica group (torch DeviceMesh: FSDP2 over
# dp and fsdp, the tensor-parallel plan over ep and tp), in MESH_AXES order;
# the others run inside each process.
PROCESS_AXES = ("dp", "fsdp", "ep", "tp")


class Mesh:
    """``devices``: an object array of ``torch.device`` with one dim per
    name in ``axis_names``. ``shape`` maps each axis to its size, in axis
    order, as ``jax.sharding.Mesh.shape`` does. ``process_rank``: this
    process's rank over the process axes (row-major over dp, fsdp, ep, tp)
    in a group of processes; None for a mesh one process holds whole."""

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
    world_size: int, rank: int, device: torch.device, family: str = "dense"
) -> Mesh:
    """The mesh of a replica group of ``world_size`` processes as seen by
    process ``rank``: the JAX trainer's mesh for that many devices
    (``train_hsdp.py``), ``device`` at every coordinate, and ``rank`` as
    its ``process_rank``. ``family`` is the trainer's model: dense models
    (any name but ``moe`` and ``pipeline``) take :func:`auto_mesh`'s
    factoring (4 ranks: fsdp 2 x tp 2). ``moe`` on an even world gives its
    experts an ``ep`` extent of 2: ``fsdp = 2 if (n/2) % 2 == 0 else 1``,
    ``tp = n / 2 / fsdp`` (2 ranks: ep 2; 4: fsdp 2 x ep 2). ``pipeline``
    runs its stages in-process over auto_mesh's ``fsdp``.

    Raises where the factoring needs ``sp`` above 1 (8 dense ranks factor
    as fsdp 2 x tp 2 x sp 2: sp is an in-process axis); for ``pipeline``
    where it needs ``tp`` (4 ranks: the JAX trainer places the GPipe stages
    on other ranks there, ``make_mesh(pp=2, dp=2)``); and for ``moe`` where
    it needs both ``ep`` and ``tp`` (6 ranks and up), a plan no test holds
    yet."""
    from torchft_tpu_torch.parallel.sharding import SP_PP_ITEM

    devices = [device] * world_size
    if family == "moe" and world_size % 2 == 0:
        rest = world_size // 2
        fsdp = 2 if rest % 2 == 0 else 1
        mesh = make_mesh(fsdp=fsdp, ep=2, tp=rest // fsdp, devices=devices)
    else:
        mesh = auto_mesh(world_size, devices=devices)
    where = f"a {family} group of {world_size} ranks factors as {mesh.shape}"
    if mesh.shape["sp"] > 1:
        raise NotImplementedError(
            f"{where}: sp={mesh.shape['sp']} would need sequence parallelism "
            f"across ranks ({SP_PP_ITEM}); run a group of fewer than 8 ranks"
        )
    if family == "pipeline" and mesh.shape["tp"] > 1:
        raise NotImplementedError(
            f"{where}: the JAX trainer puts the GPipe stages on other ranks "
            f"there, make_mesh(pp=2, dp={world_size // 2}) ({SP_PP_ITEM}); "
            "run a group of 1 or 2 ranks"
        )
    if mesh.shape["ep"] > 1 and mesh.shape["tp"] > 1:
        raise NotImplementedError(
            f"{where}: experts placed over both ep and tp have no test yet "
            "(ROADMAP.md queue 1, what is left of tensor and expert "
            "parallelism across ranks); run a group of 2 or 4 ranks"
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
    group rank 0's Manager binds its own store there. Under torchrun it is
    ``env://``: ``MASTER_PORT`` is then torchrun's store, and the Manager
    publishes its own store's address in it. A world of one
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
    """The torch ``DeviceMesh`` over the process axes of ``mesh``, on the
    default process group (:func:`init_group`), whose size must be their
    product: ``fsdp`` always, ``dp``, ``ep`` and ``tp`` where above 1, in
    that order. FSDP2 composes with the tensor-parallel plan on the
    concatenation of its (dp, fsdp) mesh and the plan's (ep, tp) mesh, so
    the group's mesh is exactly those dims."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    names = tuple(a for a in PROCESS_AXES if a == "fsdp" or mesh.shape[a] > 1)
    shape = tuple(mesh.shape[a] for a in names)
    if dist.get_world_size() != int(np.prod(shape)):
        raise ValueError(
            f"a world of {dist.get_world_size()} ranks for process axes "
            f"{dict(zip(names, shape))}"
        )
    device_type = mesh.devices.flat[0].type
    return init_device_mesh(device_type, shape, mesh_dim_names=names)
