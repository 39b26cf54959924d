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

A mesh is used in one of two ways.

- **A group of processes** (``process_rank`` set): a replica group is
  ``WORLD_SIZE`` processes, one device each, as torchrun launches them
  (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``), and every axis is a
  **process axis**: a rank's coordinate is row-major over ``MESH_AXES``
  (:meth:`Mesh.process_coordinate`). The tensor-parallel plan places the
  ``tp`` and ``ep`` dims of the parameters, FSDP2 shards the rest over
  (dp, fsdp) (``parallel/sharding.py``, ``parallel/train.py``); each rank
  holds the rows of every batch at its (dp, fsdp) coordinate and the
  sequence block at its ``sp`` coordinate; the rank at ``pp`` coordinate s
  holds stage s's layers (``parallel/pipeline.py``).

  ``sp`` and ``pp`` are not torch ``DeviceMesh`` dims of their own.
  FSDP2 on torch 2.11 composes with the tensor-parallel plan only when
  its root DeviceMesh is exactly its (dp, fsdp) dims and the plan's (ep,
  tp) dims, so :func:`group_device_mesh` is a mesh of those dims whose
  ``dp`` dim spans the (dp, sp) ranks: the parameters are replicated over
  ``sp`` as over dp, and FSDP2's replicate all-reduce averages their
  gradients over both. Over ``pp`` each stage has a DeviceMesh of its
  own. The exchanges of activations go over **c10d subgroups**:
  :func:`axis_group` makes, on every rank in one order, a group of the
  ranks that differ only in the named axes (the ring, Ulysses and the
  gathered default attention over sp's; the stages over pp's, which also
  sums the gradients of the embedding, final norm and head,
  ``parallel/train.py``).
- **One process holds the whole mesh** (``process_rank`` None): a
  :class:`Mesh` is an array of ``torch.device``, and the ring and Ulysses
  run their ``sp`` ranks, and the pipeline its ``pp`` stages, one after
  another over the mesh's devices. A device may appear more than once: a
  mesh of one card repeated stands in for the JAX package's virtual host
  devices.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

MESH_AXES = ("dp", "pp", "fsdp", "ep", "sp", "tp")
# Axes over the processes of a replica group: every axis.
PROCESS_AXES = MESH_AXES
# The process axes of a group's torch DeviceMesh (FSDP2 over dp and fsdp,
# the tensor-parallel plan over ep and tp), in MESH_AXES order.
DEVICE_MESH_AXES = ("dp", "fsdp", "ep", "tp")


class Mesh:
    """``devices``: an object array of ``torch.device`` with one dim per
    name in ``axis_names``. ``shape`` maps each axis to its size, in axis
    order, as ``jax.sharding.Mesh.shape`` does. ``process_rank``: this
    process's rank in a group of processes (its coordinate row-major over
    every axis); None for a mesh one process holds whole."""

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
        # axis_group's c10d groups, by their axes.
        self.groups: Dict[Tuple[str, ...], Any] = {}

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
    factoring (4 ranks: fsdp 2 x tp 2; 8: fsdp 2 x tp 2 x sp 2).
    ``pipeline`` on an even world puts its GPipe stages on other ranks,
    ``make_mesh(pp=2, dp=n/2)`` (2 ranks: pp 2; 4: pp 2 x dp 2), and on an
    odd one takes auto_mesh. ``moe`` on an even world gives its experts an
    ``ep`` extent of 2: ``fsdp = 2 if (n/2) % 2 == 0 else 1``, ``tp = n /
    2 / fsdp`` (2 ranks: ep 2; 4: fsdp 2 x ep 2; 8: fsdp 2 x ep 2 x tp 2;
    6: ep 2 x tp 3, which llama_moe_debug's 4 heads do not split:
    ``parallel.train.check_model_mesh`` refuses it)."""
    devices = [device] * world_size
    even = world_size % 2 == 0
    if family == "pipeline" and even:
        mesh = make_mesh(pp=2, dp=world_size // 2, devices=devices)
    elif family == "moe" and even:
        rest = world_size // 2
        fsdp = 2 if rest % 2 == 0 else 1
        mesh = make_mesh(fsdp=fsdp, ep=2, tp=rest // fsdp, devices=devices)
    else:
        mesh = auto_mesh(world_size, devices=devices)
    mesh.process_rank = rank
    return mesh


def axis_group(mesh: Mesh, axes: Sequence[str]) -> Any:
    """The c10d process group of the ranks of ``mesh``'s group of
    processes that differ from this one (``mesh.process_rank``) only in
    ``axes``, ranked row-major over them in ``MESH_AXES`` order: over one
    axis, a rank's group rank is its coordinate there. The whole world's
    group where that is every rank. The default process group must be up
    (:func:`init_group`).

    The first call for a set of axes makes every such group, on every rank
    in one order (``new_group`` is collective over the world), and keeps
    them on the mesh; later calls return the kept one. Every rank must
    therefore ask for the same sets of axes in the same order."""
    import torch.distributed as dist

    key = tuple(a for a in MESH_AXES if a in axes)
    if key not in mesh.groups:
        shape = [mesh.shape[a] for a in MESH_AXES]
        keep = [i for i, a in enumerate(MESH_AXES) if a in key]
        rest = [i for i, a in enumerate(MESH_AXES) if a not in key]
        size = int(np.prod([shape[i] for i in keep]))
        rows = np.arange(int(np.prod(shape))).reshape(shape)
        rows = rows.transpose(rest + keep).reshape(-1, size)
        if rows.shape[0] == 1:
            mine = dist.group.WORLD
        else:
            for row in rows:
                group = dist.new_group([int(r) for r in row])
                if mesh.process_rank in row:
                    mine = group
        mesh.groups[key] = mine
    return mesh.groups[key]


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
    """The torch ``DeviceMesh`` of FSDP2 and the tensor-parallel plan at
    this rank's pp coordinate of ``mesh``'s group of processes, on the
    default process group (:func:`init_group`), whose size must be the
    product of every axis: dims ``fsdp`` always, ``dp``, ``ep`` and ``tp``
    where above 1, in that order. Its ``dp`` dim spans the ranks that
    differ in dp or sp (row-major over the two): the parameters are
    replicated over sp as over dp, so FSDP2's replicate all-reduce averages
    the gradients over both. FSDP2 composes with the plan on the
    concatenation of its (dp, fsdp) mesh and the plan's (ep, tp) mesh, so
    the mesh is exactly those dims. Where pp and sp are 1 it spans the
    world in rank order (``init_device_mesh``); else it is built from
    :func:`axis_group`'s groups of its dims (``DeviceMesh.from_group``),
    each pp stage a mesh of its own."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    sizes = {a: mesh.shape[a] for a in DEVICE_MESH_AXES}
    sizes["dp"] *= mesh.shape["sp"]
    names = tuple(a for a in DEVICE_MESH_AXES if a == "fsdp" or sizes[a] > 1)
    shape = tuple(sizes[a] for a in names)
    if dist.get_world_size() != mesh.size:
        raise ValueError(
            f"a world of {dist.get_world_size()} ranks for the mesh {mesh.shape}"
        )
    device_type = mesh.devices.flat[0].type
    if mesh.shape["pp"] * mesh.shape["sp"] == 1:
        return init_device_mesh(device_type, shape, mesh_dim_names=names)
    # (dp, pp, fsdp, ep, sp, tp) -> this rank's stage, sp beside dp.
    ranks = np.arange(mesh.size).reshape([mesh.shape[a] for a in MESH_AXES])
    ranks = np.moveaxis(ranks[:, mesh.process_coordinate()["pp"]], 3, 1)
    ranks = ranks.reshape(shape)
    groups = [axis_group(mesh, ("dp", "sp") if a == "dp" else (a,)) for a in names]
    if len(names) == 1:
        return DeviceMesh.from_group(
            groups[0], device_type, mesh=ranks.tolist(), mesh_dim_names=names
        )
    return DeviceMesh.from_group(
        groups, device_type, mesh=torch.from_numpy(ranks), mesh_dim_names=names
    )


def gloo_for_device(group: Any, device: torch.device) -> bool:
    """Whether ``group`` carries ``device``'s tensors over gloo and the
    device is not the CPU (a world of ``cpu:gloo,cuda:gloo`` ranks sharing
    a card). gloo stages its collectives of such tensors through the host,
    but its point-to-point ``send`` of one aborts the process (torch 2.11,
    ``chip_smoke.py`` phase 21's probe): :func:`exchange` then stages
    through the host itself. Read from the group's backend
    configuration."""
    import torch.distributed as dist

    if device.type == "cpu":
        return False
    config = dist.get_backend_config(group)
    by_device = dict(
        item.split(":", 1) if ":" in item else (device.type, item)
        for item in config.split(",")
    )
    return by_device.get(device.type) == "gloo"


def exchange(
    group: Any,
    sends: Sequence[Tuple[torch.Tensor, int]],
    recvs: Sequence[Tuple[torch.Tensor, int]],
    tag: int = 0,
) -> List[torch.Tensor]:
    """Point-to-point over ``group``, one ``dist.batch_isend_irecv``: each
    ``(tensor, peer)`` of ``sends`` to that group rank, and into each
    ``(buffer, peer)`` of ``recvs`` what that group rank sends; returns the
    received tensors, on the buffers' devices (the buffers themselves where
    nothing is staged: pass fresh ones). The i-th send and the i-th
    receive carry tag ``tag + i``, so a peer's i-th receive takes this
    rank's i-th send. Where gloo carries the device's tensors
    (:func:`gloo_for_device`), both sides go through host copies."""
    import torch.distributed as dist

    devices = {t.device for t, _ in (*sends, *recvs)}
    staged = any(gloo_for_device(group, d) for d in devices)
    ops, bufs = [], []
    for i, (t, peer) in enumerate(sends):
        t = t.detach().contiguous()
        ops.append(dist.P2POp(
            dist.isend, t.cpu() if staged else t,
            dist.get_global_rank(group, peer), group, tag + i,
        ))
    for i, (buf, peer) in enumerate(recvs):
        if staged:
            buf = torch.empty(buf.shape, dtype=buf.dtype)
        bufs.append(buf)
        ops.append(dist.P2POp(
            dist.irecv, buf, dist.get_global_rank(group, peer), group, tag + i,
        ))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return [b.to(like.device) for b, (like, _) in zip(bufs, recvs)]
