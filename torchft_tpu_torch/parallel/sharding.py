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
- Batches shard their rows over (dp, fsdp) and their sequence over
  ``sp``, contiguous, as JAX's ``P(("dp", "fsdp"), "sp")`` lays them out;
  the ranks that differ only in ``pp``, ``ep`` or ``tp`` take the same
  block.

The parameters are placed in two steps, as FSDP2 composes with tensor
parallelism. First the **tensor-parallel plan** (:func:`tp_plan`): each
parameter whose spec names ``tp`` or ``ep`` on a mesh dim above 1 becomes a
DTensor over the mesh's ep and tp dims above 1 (the same dims for every
such parameter, the one plan mesh FSDP2 composes with), ``Shard(d)`` over
each the spec names, as torch's ``ColwiseParallel`` (``wq``, ``wk``,
``wv``, ``gate``, ``up``, ``lm_head``: the output dim) and
``RowwiseParallel`` (``wo``, ``down``: the input dim; ``embed``: the vocab)
place them, the experts over ``ep`` with their feature dims over ``tp``,
and ``Replicate()`` over a dim it does not name (the attention, the
embedding and the head over ``ep`` where both are above 1). The model
reads each rank's local shard and runs the plan's collectives itself
(``models/llama.py``), because its projections cast
input and weight to ``cfg.dtype`` outside ``nn.Linear.forward``, where
those styles' hooks would sit. Then FSDP2 shards the ``fsdp`` dim over the
group's (dp, fsdp) mesh dims, replicated over ``dp``
(:func:`param_placements`). It shards every parameter it manages, so a
parameter whose spec names no ``fsdp`` dim (the norm scales) takes its dim
0, where JAX replicates it: a placement, not another value. The
parameters are replicated over ``sp``; over ``pp`` a rank holds its stage's
layers and the embedding, the final norm and the head
(``parallel/pipeline.py``), as JAX's ``pipeline_param_specs`` shards the
stacked layer dim over ``pp`` and replicates the rest.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from torchft_tpu_torch.parallel.mesh import PROCESS_AXES, Mesh

# The process axes the tensor-parallel plan places, in mesh order.
MODEL_AXES = ("ep", "tp")

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


def model_dims(
    spec: Spec, shape: Mapping[str, int]
) -> Tuple[Tuple[str, Optional[int]], ...]:
    """``((axis, dim), ...)``: the plan's mesh dims of a parameter with
    ``spec`` on a mesh of ``shape`` (axis -> size): where the spec names
    ``ep`` or ``tp`` on a dim above 1, each of ``ep`` and ``tp`` (in mesh
    order) that ``shape`` gives above 1, with the parameter dim the spec
    shards over it, None where the spec does not name it (replicated
    there); empty where the spec names neither."""
    above = tuple(a for a in MODEL_AXES if shape.get(a, 1) > 1)
    if not any(a in spec for a in above):
        return ()
    return tuple((a, spec.index(a) if a in spec else None) for a in above)


def tp_plan(
    model: torch.nn.Module, mesh: Mesh
) -> Dict[str, Tuple[Tuple[str, Optional[int]], ...]]:
    """The tensor-parallel plan of ``model`` on ``mesh``: {parameter name:
    :func:`model_dims`} for every parameter with a dim over ``ep`` or
    ``tp`` above 1 (none where both are 1). Raises where such a dim does
    not divide evenly."""
    plan = {}
    for name, p in model.named_parameters():
        dims = model_dims(spec_for(name, p.dim()), mesh.shape)
        for axis, d in dims:
            if d is not None and p.shape[d] % mesh.shape[axis]:
                raise ValueError(
                    f"{name} {tuple(p.shape)}: dim {d} does not split over "
                    f"{axis}={mesh.shape[axis]}"
                )
        if dims:
            plan[name] = dims
    return plan


def shard_dim(spec: Spec) -> int:
    """The dim FSDP2 shards: the one the spec gives ``fsdp``, else 0."""
    return spec.index("fsdp") if "fsdp" in spec else 0


def param_placements(model: torch.nn.Module, device_mesh: Any) -> Dict[str, tuple]:
    """{parameter name: DTensor placements} as the sharded state holds them
    (``parallel.train.init_train_state``) over the group's ``device_mesh``
    (:func:`parallel.mesh.group_device_mesh`): ``Replicate()`` over dp
    where dp is above 1, ``Shard(d)`` over fsdp (``d`` from
    :func:`shard_dim`; what ``fully_shard``'s ``shard_placement_fn``
    returns), then over each of the plan's ep and tp dims
    (:func:`model_dims`) ``Shard(d)``, or ``Replicate()`` where ``d`` is
    None: the order of FSDP2's mesh, its (dp, fsdp) mesh followed by the
    plan's."""
    from torch.distributed.tensor import Replicate

    shape = dict(zip(device_mesh.mesh_dim_names, device_mesh.mesh.shape))
    dp = (Replicate(),) if shape.get("dp", 1) > 1 else ()
    return {
        name: dp + (placement(shard_dim(spec)),)
        + tuple(placement(d) for _, d in model_dims(spec, shape))
        for name, spec in param_specs(model).items()
    }


def placement(dim: Optional[int]) -> Any:
    """``Shard(dim)``, or ``Replicate()`` where ``dim`` is None."""
    from torch.distributed.tensor import Replicate, Shard

    return Replicate() if dim is None else Shard(dim)


# The JAX package's export name for the placements.
param_shardings = param_placements


def batch_sharding(
    mesh: Mesh, rank: int, shape: Tuple[int, int]
) -> Tuple[slice, slice]:
    """``(rows, cols)``: the block of a global ``shape`` = ``[B, S]`` batch
    that process ``rank`` of the group holds, as JAX's ``P(("dp", "fsdp"),
    "sp")`` lays it out: the rows split over (dp, fsdp) in contiguous
    blocks, the rank's (dp, fsdp) coordinate (row-major over the process
    axes) picking the block, and the sequence split over ``sp`` the same
    way. Ranks that differ only in pp, ep or tp take the same block."""
    B, S = shape
    n, sp = mesh.shape["dp"] * mesh.shape["fsdp"], mesh.shape["sp"]
    if B % n:
        raise ValueError(f"batch {B} not divisible by dp*fsdp={n}")
    if S % sp:
        raise ValueError(f"sequence {S} not divisible by sp={sp}")
    if not 0 <= rank < mesh.size:
        raise ValueError(f"rank {rank} outside a group of {mesh.size}")
    coord = dict(zip(
        PROCESS_AXES,
        np.unravel_index(rank, [mesh.shape[a] for a in PROCESS_AXES]),
    ))
    block = int(coord["dp"]) * mesh.shape["fsdp"] + int(coord["fsdp"])
    rows, cols, s = B // n, S // sp, int(coord["sp"])
    return slice(block * rows, (block + 1) * rows), slice(s * cols, (s + 1) * cols)


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
