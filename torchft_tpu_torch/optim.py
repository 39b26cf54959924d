"""OptimizerWrapper: the two-line fault-tolerance integration point.

Reference: ``torchft/optim.py:24-63`` — ``zero_grad()`` starts the quorum for
the step and ``step()`` only applies the update if the distributed commit
gate passes. Here the optimizer is a ``torch.optim.Optimizer``, registered
with the Manager for live checkpoint heal (its parameters and state travel
as host numpy).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from torchft_tpu_torch.manager import Manager


def optimizer_state_dict(optimizer: torch.optim.Optimizer) -> Dict[str, Any]:
    """Parameters and per-parameter state of ``optimizer`` as host numpy,
    keyed by (group, index) position so the receiver needs no ids."""
    params, state = {}, {}
    for g, group in enumerate(optimizer.param_groups):
        for i, p in enumerate(group["params"]):
            key = f"{g}.{i}"
            params[key] = p.detach().cpu().numpy()
            state[key] = {
                name: (v.detach().cpu().numpy() if torch.is_tensor(v) else v)
                for name, v in optimizer.state.get(p, {}).items()
            }
    return {"params": params, "state": state}


def load_optimizer_state_dict(
    optimizer: torch.optim.Optimizer, sd: Dict[str, Any]
) -> None:
    """Writes a :func:`optimizer_state_dict` payload into ``optimizer``'s
    parameters (in place, on their devices) and replaces its state. Scalar
    state (AdamW's ``step``) stays where torch keeps it, on the CPU."""
    with torch.no_grad():
        for g, group in enumerate(optimizer.param_groups):
            for i, p in enumerate(group["params"]):
                key = f"{g}.{i}"
                p.copy_(torch.from_numpy(sd["params"][key]))
                new = {}
                for name, v in sd["state"][key].items():
                    t = torch.as_tensor(v)
                    new[name] = (
                        t.to(p.device).clone() if t.dim() > 0 else t.clone()
                    )
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
