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

A :class:`Mesh` is an array of ``torch.device`` over those axes. A device
may appear more than once: a mesh of one card repeated stands in for the
JAX package's virtual host devices, so the ring and Ulysses run their
``sp`` ranks, and the pipeline its ``pp`` stages, one after another on that
card. ``sp`` (``ring_attention.py``, ``ulysses.py``) and ``pp``
(``pipeline.py``) have consumers in the port; sharding over the other axes
(experts over ``ep`` included) is not ported (ROADMAP.md queue 1:
``parallel/sharding.py`` + FSDP2). The fault-tolerant replica axis is not a
mesh axis: it is the Manager's (``device_mesh.py``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

MESH_AXES = ("dp", "pp", "fsdp", "ep", "sp", "tp")


class Mesh:
    """``devices``: an object array of ``torch.device`` with one dim per
    name in ``axis_names``. ``shape`` maps each axis to its size, in axis
    order, as ``jax.sharding.Mesh.shape`` does."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]) -> None:
        if devices.ndim != len(axis_names):
            raise ValueError(
                f"devices have {devices.ndim} dims for axes {tuple(axis_names)}"
            )
        self.devices = devices
        self.axis_names: Tuple[str, ...] = tuple(axis_names)

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
