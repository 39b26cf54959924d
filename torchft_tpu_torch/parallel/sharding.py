"""Parameter sharding rules for the Llama family inside one replica group.

The port of ``torchft_tpu/parallel/sharding.py``. JAX's rules map each flax
parameter to a ``PartitionSpec`` over the (dp, fsdp, ep, sp, tp) mesh;
here the same rules are written over the port's parameter names and
layouts: an ``nn.Linear`` weight is ``[out, in]`` where a flax kernel is
``[in, out]`` (the q/k/v kernels ``[H, heads, Dh]`` become ``[heads*Dh,
H]``, the output kernel ``[heads, Dh, H]`` becomes ``[H, heads*Dh]``), and
each layer is its own module where JAX stacks them under a leading
``[num_layers]`` dim. A spec is a plain tuple, one axis name or None per
dim of the parameter.

- Contraction-input dims shard over ``fsdp``, head and feature output dims
  over ``tp``, experts over ``ep``; norms replicate.
- Batches shard their rows over (dp, fsdp), contiguous, as JAX's
  ``P(("dp", "fsdp"), "sp")`` lays them out; the sequence dim stays whole on
  a rank (``sp`` is an in-process axis: ring and Ulysses split it).

FSDP2 places what the rules say on the process axes: ``Shard(d)`` for the
``fsdp`` dim over the group's ``fsdp`` mesh dim, replicated over ``dp``
(:func:`param_placements`). It shards every parameter it manages, so a
parameter whose spec names no ``fsdp`` dim (the norm scales) takes its dim
0, where JAX replicates it: a placement, not another value. The ``tp`` and
``ep`` entries stay data here (checked against JAX by the tests); above 1
they raise (:data:`TP_EP_ITEM`).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from torchft_tpu_torch.parallel.mesh import Mesh

# Tensor and expert parallelism: the tp rules onto a torch tensor-parallel
# plan, experts placed over ep, a pipeline whose stages sit on other ranks.
TP_EP_ITEM = "ROADMAP.md queue 1: tensor and expert parallelism across ranks"

Spec = Tuple[Optional[str], ...]

# Name of a parameter's module and its own name -> spec over the port's dims
# (JAX's _RULES, keyed by flax container and leaf, laid out as torch lays the
# weight out).
_RULES: Dict[Tuple[str, str], Spec] = {
    ("embed", "weight"): ("tp", "fsdp"),  # [V, H]
    ("wq", "weight"): ("tp", "fsdp"),  # [Hq*Dh, H]
    ("wk", "weight"): ("tp", "fsdp"),
    ("wv", "weight"): ("tp", "fsdp"),
    ("wo", "weight"): ("fsdp", "tp"),  # [H, Hq*Dh]
    ("gate", "weight"): ("tp", "fsdp"),  # [I, H]
    ("up", "weight"): ("tp", "fsdp"),
    ("down", "weight"): ("fsdp", "tp"),  # [H, I]
    ("lm_head", "weight"): ("tp", "fsdp"),  # [V, H]
    # MoE: [E, in, out] as flax keeps them; experts over ep, within an
    # expert the FFN as the dense MLP. The fp32 router [E, H] shards H.
    ("mlp", "experts_gate"): ("ep", "fsdp", "tp"),
    ("mlp", "experts_up"): ("ep", "fsdp", "tp"),
    ("mlp", "experts_down"): ("ep", "tp", "fsdp"),
    ("router", "weight"): (None, "fsdp"),
}


def spec_for(name: str, ndim: int) -> Spec:
    """The spec of the parameter called ``name`` (a dotted
    ``named_parameters`` name) with ``ndim`` dims: its rule, or replicated
    (every dim None) where no rule names it."""
    parts = tuple(name.split("."))
    rule = _RULES.get(parts[-2:])
    if rule is None:
        return (None,) * ndim
    if len(rule) != ndim:
        raise ValueError(f"{name}: rule {rule} for a {ndim}-dim parameter")
    return rule


def param_specs(model: torch.nn.Module) -> Dict[str, Spec]:
    """{parameter name: spec} for every parameter of ``model``."""
    return {
        name: spec_for(name, p.dim()) for name, p in model.named_parameters()
    }


def tree_specs_like(tree: Any, spec_by_name: Dict[str, Spec]) -> Any:
    """Specs for a nested dict whose leaves mirror parameters
    (``spec_by_name`` is :func:`param_specs`; AdamW's
    ``exp_avg`` and ``exp_avg_sq`` under a parameter's name): a leaf whose
    dotted path ends with a known parameter name takes that parameter's
    spec; anything else (the ``step`` count, scalars) is replicated, ``()``."""

    def walk(x: Any, path: Tuple[str, ...]) -> Any:
        if isinstance(x, dict):
            return {k: walk(v, path + (str(k),)) for k, v in x.items()}
        for start in range(len(path)):
            spec = spec_by_name.get(".".join(path[start:]))
            if spec is not None:
                return spec
        return ()

    return walk(tree, ())


def check_process_mesh(mesh: Mesh) -> None:
    """Raises where ``mesh`` needs ``tp`` or ``ep`` above 1: their rules
    are data here, their placement across ranks is not ported."""
    over = [f"{a}={mesh.shape[a]}" for a in ("tp", "ep") if mesh.shape[a] > 1]
    if over:
        raise NotImplementedError(
            f"a mesh with {', '.join(over)}: tensor and expert parallelism "
            f"are not placed across ranks ({TP_EP_ITEM})"
        )


def shard_dim(spec: Spec) -> int:
    """The dim FSDP2 shards: the one the spec gives ``fsdp``, else 0."""
    return spec.index("fsdp") if "fsdp" in spec else 0


def param_placements(model: torch.nn.Module, device_mesh: Any) -> Dict[str, tuple]:
    """{parameter name: DTensor placements over ``device_mesh``} (the
    group's ("dp", "fsdp") mesh of :func:`parallel.mesh.group_device_mesh`):
    ``Replicate()`` over dp and ``Shard(d)`` over fsdp, ``d`` from
    :func:`shard_dim`. What ``fully_shard``'s ``shard_placement_fn``
    returns, and what a sharded state is checked against."""
    from torch.distributed.tensor import Replicate, Shard

    return {
        name: tuple(
            Shard(shard_dim(spec)) if axis == "fsdp" else Replicate()
            for axis in device_mesh.mesh_dim_names
        )
        for name, spec in param_specs(model).items()
    }


# The JAX package's export name for the placements.
param_shardings = param_placements


def batch_sharding(mesh: Mesh, rank: int, batch_size: int) -> slice:
    """The rows of a global ``[batch_size, S]`` batch that process ``rank``
    of the group holds: the batch split over (dp, fsdp) in contiguous
    blocks, rank row-major over (dp, fsdp), as JAX's ``P(("dp", "fsdp"),
    "sp")`` lays it out."""
    n = mesh.shape["dp"] * mesh.shape["fsdp"]
    if batch_size % n:
        raise ValueError(f"batch {batch_size} not divisible by dp*fsdp={n}")
    if not 0 <= rank < n:
        raise ValueError(f"rank {rank} outside a group of {n}")
    rows = batch_size // n
    return slice(rank * rows, (rank + 1) * rows)


def local_slices(t: Any) -> Tuple[slice, ...]:
    """The global index of the shard of DTensor ``t`` this rank holds: one
    ``slice(start, stop)`` per dim."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )

    shape, offset = compute_local_shape_and_global_offset(
        t.shape, t.device_mesh, t.placements
    )
    return tuple(slice(o, o + n) for o, n in zip(offset, shape))
