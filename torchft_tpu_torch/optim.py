"""OptimizerWrapper: the two-line fault-tolerance integration point.

Reference: ``torchft/optim.py:24-63`` — ``zero_grad()`` starts the quorum for
the step and ``step()`` only applies the update if the distributed commit
gate passes. Here the optimizer is a ``torch.optim.Optimizer``, registered
with the Manager for live checkpoint heal (its parameters and state travel
as host numpy, or in the device form as the tensors themselves for the
sharded PG transport).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch._dtensor import is_dtensor, local as _local
from torchft_tpu_torch.parallel.sharding import local_slices


def _layout(t: torch.Tensor) -> Tuple[Tuple[int, int], ...]:
    """The global ``(start, stop)`` of each dim of the shard this rank
    holds: a DTensor's local shard, or the whole of a plain tensor."""
    if is_dtensor(t):
        return tuple((s.start, s.stop) for s in local_slices(t))
    return tuple((0, n) for n in t.shape)


def optimizer_state_dict(
    optimizer: torch.optim.Optimizer, device: bool = False
) -> Dict[str, Any]:
    """Parameters and per-parameter state of ``optimizer`` keyed by (group,
    index) position, so the receiver needs no ids: as host numpy, or with
    ``device=True`` as the live tensors on their devices (detached, not
    copied; AdamW's ``step`` stays the 0-d tensor torch keeps on the CPU).

    A DTensor parameter (sharded by FSDP2) and its state go as this rank's
    local shards: the host form holds the shard's numpy, the device form
    the DTensor itself (``checkpointing/sharded.py`` sends its local
    shard), and ``"layout"`` maps its key to the shard's global ``(start,
    stop)`` per dim, which a load checks against its own."""
    leaf = (
        (lambda t: t.detach()) if device
        else (lambda t: _local(t).detach().cpu().numpy())
    )
    params, state, layout = {}, {}, {}
    for g, group in enumerate(optimizer.param_groups):
        for i, p in enumerate(group["params"]):
            key = f"{g}.{i}"
            params[key] = leaf(p)
            state[key] = {
                name: (leaf(v) if torch.is_tensor(v) else v)
                for name, v in optimizer.state.get(p, {}).items()
            }
            if is_dtensor(p):
                layout[key] = _layout(p)
    out = {"params": params, "state": state}
    if layout:
        out["layout"] = layout
    return out


def init_adam_state(optimizer: torch.optim.Optimizer) -> None:
    """Creates the state torch's Adam and AdamW create at their first step
    (``step`` a 0-d float32 CPU tensor at 0, ``exp_avg`` and ``exp_avg_sq``
    zeros like the parameter) for every parameter that has none, so the
    first step computes the same bits. A sharded heal's receiver needs the
    state's tensors before that step: they name each leaf's device."""
    if not isinstance(optimizer, (torch.optim.Adam, torch.optim.AdamW)):
        raise TypeError(f"not an Adam optimizer: {type(optimizer).__name__}")
    for group in optimizer.param_groups:
        if group.get("amsgrad") or group.get("fused") or group.get("capturable"):
            raise ValueError("amsgrad, fused and capturable keep other state")
        for p in group["params"]:
            if not optimizer.state.get(p):
                optimizer.state[p] = {
                    "step": torch.tensor(0.0, dtype=torch.float32),
                    "exp_avg": torch.zeros_like(
                        p, memory_format=torch.preserve_format
                    ),
                    "exp_avg_sq": torch.zeros_like(
                        p, memory_format=torch.preserve_format
                    ),
                }


def load_optimizer_state_dict(
    optimizer: torch.optim.Optimizer, sd: Dict[str, Any]
) -> None:
    """Writes a :func:`optimizer_state_dict` payload (host numpy or the
    device form) into ``optimizer``'s parameters (in place, on their
    devices) and replaces its state with copies. Scalar state (AdamW's
    ``step``) stays where torch keeps it, on the CPU.

    A DTensor parameter takes the payload's local shard into its own, and
    its state is rebuilt as DTensors with its placements; the payload's
    shard must cover the same global slice as this rank's (a plain tensor
    covers the whole), else it raises: the sender's and receiver's
    layouts differ."""
    layouts = sd.get("layout", {})
    with torch.no_grad():
        for g, group in enumerate(optimizer.param_groups):
            for i, p in enumerate(group["params"]):
                key = f"{g}.{i}"
                src = sd["params"][key]
                if is_dtensor(p):
                    if is_dtensor(src):
                        got = _layout(src)
                    elif key in layouts:
                        got = layouts[key]
                    else:
                        got = tuple((0, n) for n in np.shape(src))
                    if tuple(map(tuple, got)) != _layout(p):
                        raise ValueError(
                            f"parameter {key}: the checkpoint holds the "
                            f"shard {tuple(got)}, this rank holds "
                            f"{_layout(p)} (sender/receiver shardings differ)"
                        )
                _local(p).copy_(torch.as_tensor(_local(src)))
                new = {}
                for name, v in sd["state"][key].items():
                    t = torch.as_tensor(_local(v))
                    if t.dim() == 0:
                        new[name] = t.to("cpu", copy=True)
                        continue
                    t = t.to(_local(p).device, copy=True)
                    if is_dtensor(p):
                        from torch.distributed.tensor import DTensor

                        t = DTensor.from_local(
                            t, p.device_mesh, p.placements,
                            shape=p.shape, stride=p.stride(),
                        )
                    new[name] = t
                optimizer.state[p] = new


class OptimizerWrapper:
    def __init__(
        self,
        manager: Manager,
        optimizer: torch.optim.Optimizer,
        register: bool = True,
        key: str = "optimizer",
    ) -> None:
        self.manager = manager
        self.optimizer = optimizer
        if register:
            manager.register_state_dict_fn(
                key, self.state_dict, self.load_state_dict
            )

    def zero_grad(self, set_to_none: bool = True) -> None:
        """Starts the quorum for this step (reference: optim.py:48-50)."""
        self.manager.start_quorum()
        self.optimizer.zero_grad(set_to_none=set_to_none)

    def step(self, on_commit: Optional[Callable[[], None]] = None) -> bool:
        """Applies the parameters' ``.grad`` iff the commit gate passes
        (optim.py:52-55). Returns whether the step was committed.

        The commit decision (which bumps the manager step) and the update
        run under the state-dict WRITE lock: a concurrent checkpoint send
        (async-quorum heal of a peer) must never snapshot the bumped step
        with pre-update params. ``on_commit`` runs inside the fence after
        the update, for auxiliary state that must advance with the params."""
        with self.manager.fenced_state_dict():
            if not self.manager.should_commit():
                return False
            self.optimizer.step()
            if on_commit is not None:
                on_commit()
            return True

    def state_dict(self) -> Dict[str, Any]:
        return optimizer_state_dict(self.optimizer)

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        load_optimizer_state_dict(self.optimizer, state)
