"""ManagedMesh: the fault-tolerant replica axis beside a group's inner mesh.

The port of ``torchft_tpu/device_mesh.py`` (reference:
``torchft/device_mesh.py:50-336``, ``ManagedDeviceMesh`` /
``ft_init_device_mesh``). A :class:`ManagedMesh` pairs

- the inner :class:`~torchft_tpu_torch.parallel.mesh.Mesh` of this replica
  group (static axes): in a group of processes every axis is a process
  axis, over the group's ranks (one device each; ``parallel/mesh.py``),
  and a mesh one process holds whole runs its axes over the devices of
  that process; and
- the Manager's dynamic replica axis, sized by the live quorum
  (``num_participants``), which carries the outer gradient average. Each
  rank of a group runs its own Manager, and rank r of every group averages
  its own shards with the others' rank r.

It answers the questions a trainer holds a mesh for (axis sizes including
the dynamic replica axis, coordinates, composite ranks, sub-axis views,
the inner axes a view shards over) and carries the outer collective
(``allreduce_grads``, the port's ``DistributedDataParallel``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from torchft_tpu_torch.ddp import DistributedDataParallel
from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.parallel.mesh import Mesh


class MeshView:
    """A named-axis selection (or flattening) of a :class:`ManagedMesh`
    (reference ``ManagedDeviceMesh.__getitem__`` / ``_FlattenDeviceMesh``,
    device_mesh.py:92-236): sizes, coordinates and composite rank over the
    selected axes and, when the replica axis is selected, the outer
    ``allreduce_grads``. Views are cheap and immutable."""

    def __init__(
        self,
        parent: "ManagedMesh",
        names: Tuple[str, ...],
        flat_name: Optional[str] = None,
    ) -> None:
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate axis in view selection {names}")
        for n in names:
            if n != ManagedMesh.REPLICA_AXIS and n not in parent.mesh.shape:
                raise KeyError(
                    f"axis {n!r} not in {parent.axis_names} "
                    "(flattened names resolve via mesh[name], not views)"
                )
        self._parent = parent
        self.names = tuple(names)
        self.flat_name = flat_name

    # -- shape ------------------------------------------------------------

    @property
    def has_replica(self) -> bool:
        return ManagedMesh.REPLICA_AXIS in self.names

    def _axis_size(self, name: str) -> int:
        if name == ManagedMesh.REPLICA_AXIS:
            return self._parent.replica_size()
        return self._parent.mesh.shape[name]

    def size(self, axis: Optional[str] = None) -> int:
        """Product over the view's axes (or one axis's extent)."""
        if axis is not None:
            if axis not in self.names:
                raise KeyError(f"axis {axis!r} not in view {self.names}")
            return self._axis_size(axis)
        n = 1
        for name in self.names:
            n *= self._axis_size(name)
        return n

    def shape(self) -> Dict[str, int]:
        return {n: self._axis_size(n) for n in self.names}

    # -- coordinates ------------------------------------------------------

    def coordinate(self, device: Any = None) -> Dict[str, Optional[int]]:
        """Per-axis coordinate: the replica axis reads the manager's live
        participating rank (None while healing/spare); inner axes read
        ``device``'s position in the mesh (default: the mesh's first
        device)."""
        inner = [n for n in self.names if n != ManagedMesh.REPLICA_AXIS]
        inner_coords = self._parent.device_coordinate(device) if inner else {}
        return {
            n: (
                self._parent.replica_rank()
                if n == ManagedMesh.REPLICA_AXIS
                else inner_coords[n]
            )
            for n in self.names
        }

    def rank(self, device: Any = None) -> Optional[int]:
        """Row-major composite rank over the view's axes (with names
        ``(replica, *inner)``: ``inner_size * replica_rank + inner_rank``).
        None while this group is healing/spare."""
        coords = self.coordinate(device)
        rank = 0
        for n in self.names:
            c = coords[n]
            if c is None:
                return None
            rank = rank * self._axis_size(n) + int(c)
        return rank

    def partition_spec(self) -> Tuple[str, ...]:
        """The view's INNER axes in order, as a plain tuple of axis names
        (the JAX package's ``PartitionSpec`` of them): the replica axis is
        the Manager's, never an axis a tensor is sharded over."""
        return tuple(n for n in self.names if n != ManagedMesh.REPLICA_AXIS)

    # -- collectives -------------------------------------------------------

    def allreduce_grads(
        self,
        grads: Any,
        should_quantize: bool = False,
        quantize_bits: int = 8,
    ) -> Any:
        if not self.has_replica:
            raise ValueError(
                f"view {self.names} has no managed axis; inner-axis "
                "reductions are not manager collectives"
            )
        return self._parent.allreduce_grads(
            grads,
            should_quantize=should_quantize,
            quantize_bits=quantize_bits,
        )

    def __repr__(self) -> str:
        label = f" as {self.flat_name!r}" if self.flat_name else ""
        return f"MeshView({self.names}{label}, shape={self.shape()})"


class ManagedMesh:
    """An inner mesh + the managed (fault-tolerant) replica axis.

    ``size()`` of the replica axis is dynamic: the current quorum, clamped
    >= 1 as in the reference's ``ManagedDeviceMesh.size``; the inner axes
    are the mesh's static sizes."""

    REPLICA_AXIS = "replica"

    def __init__(
        self,
        manager: Manager,
        mesh: Mesh,
        bucket_cap_mb: float = 32.0,
    ) -> None:
        self.manager = manager
        self.mesh = mesh
        self._ddp = DistributedDataParallel(manager, bucket_cap_mb=bucket_cap_mb)
        self._flattened: Dict[str, MeshView] = {}
        self._coord_cache: Dict[Any, Dict[str, int]] = {}

    # -- shape ------------------------------------------------------------

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return (self.REPLICA_AXIS,) + tuple(self.mesh.axis_names)

    def size(self, axis: Optional[str] = None) -> int:
        if axis is None:
            return self.replica_size() * self.inner_size()
        if axis == self.REPLICA_AXIS:
            return self.replica_size()
        return self.mesh.shape[axis]

    def replica_size(self) -> int:
        """Live replica-group count (>=1 even before the first quorum)."""
        return max(self.manager.num_participants(), 1)

    def inner_size(self) -> int:
        return self.mesh.size

    def shape(self) -> Dict[str, int]:
        out = {self.REPLICA_AXIS: self.replica_size()}
        out.update(self.mesh.shape)
        return out

    @property
    def ndim(self) -> int:
        """Inner axes + the managed replica axis."""
        return len(self.mesh.axis_names) + 1

    # -- selection / flattening (reference device_mesh.py:92-236) ---------

    def __getitem__(self, names: Union[str, Tuple[str, ...]]) -> MeshView:
        """Sub-mesh selection by axis name(s), the replica axis and names
        registered by :meth:`flatten` included."""
        if isinstance(names, str):
            if names in self._flattened:
                return self._flattened[names]
            names = (names,)
        return MeshView(self, tuple(names))

    def flatten(
        self,
        names: Optional[Sequence[str]] = None,
        *,
        name: str,
    ) -> MeshView:
        """Registers (and returns) a flattened view over ``names`` (default:
        every axis, replica first) addressable as ``mesh[name]``."""
        if names is None:
            names = self.axis_names
        if name in self.axis_names:
            raise ValueError(
                f"flatten name {name!r} would shadow a real axis "
                f"({self.axis_names}) in __getitem__"
            )
        prior = self._flattened.get(name)
        if prior is not None:
            if prior.names == tuple(names):
                return prior  # idempotent re-register
            raise ValueError(
                f"flatten name {name!r} already registered over "
                f"{prior.names}; pick a distinct name"
            )
        view = MeshView(self, tuple(names), flat_name=name)
        self._flattened[name] = view
        return view

    # -- coordinates ------------------------------------------------------

    def replica_rank(self) -> Optional[int]:
        """This group's rank on the replica axis (None while healing or
        spare)."""
        return self.manager.participating_rank()

    def device_coordinate(self, device: Any = None) -> Dict[str, int]:
        """``device``'s per-axis position in the inner mesh (default: the
        mesh's first device; every torch device is local to its process).
        In a group of processes (``mesh.process_rank`` set) every axis is a
        process axis: the coordinate is this process's rank's, and a
        ``device`` given must be the mesh's device there. For a mesh one
        process holds whole, the device is looked up in it. Raises where
        the device is not there, or appears more than once (a mesh that
        repeats one device gives it no single coordinate)."""
        key = None if device is None else torch.device(device)
        cached = self._coord_cache.get(key)
        if cached is not None:
            return dict(cached)
        devs = self.mesh.devices
        if self.mesh.process_rank is not None:
            coords = self.mesh.process_coordinate()
            mine = devs[tuple(coords[a] for a in self.mesh.axis_names)]
            if key is not None and key != mine:
                raise ValueError(
                    f"device {key} is not this process's device {mine} in "
                    f"mesh {self.mesh}"
                )
        else:
            target = devs.flat[0] if key is None else key
            hits = [pos for pos, d in np.ndenumerate(devs) if d == target]
            if len(hits) != 1:
                raise ValueError(
                    f"device {target} appears {len(hits)} times in mesh "
                    f"{self.mesh}; a coordinate needs exactly one"
                )
            coords = {a: int(i) for a, i in zip(self.mesh.axis_names, hits[0])}
        self._coord_cache[key] = coords
        return dict(coords)

    def coordinate(self, device: Any = None) -> Dict[str, Any]:
        """Live replica rank + the device's inner-mesh position."""
        return {
            self.REPLICA_AXIS: self.replica_rank(),
            **self.device_coordinate(device),
        }

    # -- collectives ------------------------------------------------------

    def allreduce_grads(
        self,
        grads: Any,
        should_quantize: bool = False,
        quantize_bits: int = 8,
    ) -> Any:
        """Average a name -> gradient dict across the replica axis (what
        ManagedProcessGroup.allreduce is to DDP in the reference)."""
        return self._ddp.allreduce_grads(
            grads,
            should_quantize=should_quantize,
            quantize_bits=quantize_bits,
        )

    def __repr__(self) -> str:
        return (
            f"ManagedMesh(replica~{self.replica_size()}, "
            f"inner={self.mesh.shape})"
        )


def ft_init_device_mesh(
    manager: Manager,
    *,
    dp: int = 1,
    fsdp: int = 1,
    sp: int = 1,
    tp: int = 1,
    devices: Any = None,
    mesh: Optional[Mesh] = None,
) -> ManagedMesh:
    """Builds the inner mesh and wraps it with the managed replica axis
    (reference: ft_init_device_mesh, device_mesh.py:303-336)."""
    if mesh is None:
        from torchft_tpu_torch.parallel.mesh import auto_mesh, make_mesh

        if dp == fsdp == sp == tp == 1 and devices is None:
            mesh = auto_mesh()
        else:
            mesh = make_mesh(dp=dp, fsdp=fsdp, sp=sp, tp=tp, devices=devices)
    return ManagedMesh(manager, mesh)
