"""ResNet v1.5 family: the PyTorch twin of ``torchft_tpu/models/resnet.py``,
the fault-tolerant DDP vision model of BASELINE config #3 (ResNet-50 at
224x224, 1000 classes).

The reference's choices are kept: the v1.5 variant (the stride on the 3x3,
not the 1x1), bf16 compute with fp32 parameters and batch statistics
(``dtype`` selects the compute type; the tests run fp32), NHWC inputs
``[B, H, W, 3]``, and flax's initializers in distribution (lecun-normal
kernels truncated at two standard deviations, zero biases, BatchNorm scale
1 and ``bn3``'s scale 0). Inside, the convolutions run on an NCHW view of
the NHWC input, which is channels-last memory.

Three places where a stock PyTorch layer would compute something else:

- **SAME padding with stride 2 is asymmetric** in flax/XLA: on an even
  input the strided 3x3 pads 0 before and 1 after, where
  ``F.conv2d(padding=1)`` pads 1 and 1 and gives the same shape with other
  values. :class:`Conv` pads by TF/XLA's SAME rule.
- **BatchNorm keeps the biased batch variance**, E[x^2] - E[x]^2 in fp32
  (flax's ``use_fast_variance``), and ``torch.nn.BatchNorm2d`` the
  unbiased one. :class:`BatchNorm` is written out; its running statistics
  are buffers ``mean`` and ``var``, moved by :meth:`ResNet.update_batch_stats`
  as ``0.9 * running + 0.1 * batch``.
- **Module names are flax's** (``conv_init``, ``bn_init``,
  ``stage{s}_block{b}.{conv1,bn1,...,proj,bn_proj}``, ``head``; BatchNorm's
  ``scale`` and ``bias``), so :func:`params_from_jax` and
  :func:`params_to_jax` map a flax tree by name, transposing HWIO kernels to
  OIHW and dense kernels to ``[out, in]``.
"""

from __future__ import annotations

import math
from collections.abc import Mapping
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

MOMENTUM = 0.9
EPSILON = 1e-5
# flax's lecun_normal: a normal of variance 1/fan_in truncated at two
# standard deviations, rescaled by the truncated normal's own deviation.
_TRUNC_STD = 0.87962566103423978

BatchStats = Dict[str, Tuple[torch.Tensor, torch.Tensor]]


def lecun_normal_(weight: torch.Tensor, fan_in: int) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std)


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """TF/XLA's SAME padding of one spatial dim: (before, after), the odd
    pixel after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax ``nn.Conv`` on NCHW: an OIHW ``weight``, SAME padding unless
    ``padding`` is given, computed in ``dtype``."""

    def __init__(
        self, cin: int, cout: int, kernel: int, stride: int = 1,
        padding: Optional[int] = None, bias: bool = False,
        dtype: torch.dtype = torch.bfloat16,
    ) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel))
        lecun_normal_(self.weight, cin * kernel * kernel)
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.kernel, self.stride, self.padding = kernel, stride, padding
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pad = self.padding
        if pad is None:
            (ht, hb), (wl, wr) = (
                same_padding(s, self.kernel, self.stride) for s in x.shape[2:]
            )
            if (ht, wl) == (hb, wr):
                pad = (ht, wl)
            else:
                x = F.pad(x, (wl, wr, ht, hb))
                pad = 0
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(
            x.to(self.dtype), self.weight.to(self.dtype), bias, self.stride, pad
        )


class Dense(nn.Module):
    """flax ``nn.Dense``: a ``[out, in]`` weight and a bias, in ``dtype``."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        lecun_normal_(self.weight, cin)
        self.bias = nn.Parameter(torch.zeros(cout))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(
            x.to(self.dtype), self.weight.to(self.dtype), self.bias.to(self.dtype)
        )


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over NCHW (momentum 0.9, epsilon 1e-5). In
    train mode (``batch`` a dict) it normalizes with the batch's mean and
    biased variance, computed in fp32, and records them in
    ``batch[self]``; otherwise with the running ``mean`` and ``var``."""

    def __init__(
        self, features: int, zero_scale: bool = False,
        dtype: torch.dtype = torch.bfloat16,
    ) -> None:
        super().__init__()
        init = torch.zeros if zero_scale else torch.ones
        self.scale = nn.Parameter(init(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.dtype = dtype

    def forward(self, x: torch.Tensor, batch: Optional[dict]) -> torch.Tensor:
        x32 = x.float()
        if batch is None:
            mean, var = self.mean, self.var
        else:
            mean = x32.mean((0, 2, 3))
            var = torch.clamp(x32.square().mean((0, 2, 3)) - mean.square(), min=0.0)
            batch[self] = (mean.detach(), var.detach())
        mul = torch.rsqrt(var + EPSILON) * self.scale
        y = (x32 - mean[:, None, None]) * mul[:, None, None]
        return (y + self.bias[:, None, None]).to(self.dtype)

    @torch.no_grad()
    def update(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """The running statistics' step, ``0.9 * running + 0.1 * batch``,
        in flax's order of operations."""
        self.mean.copy_(MOMENTUM * self.mean + (1 - MOMENTUM) * mean)
        self.var.copy_(MOMENTUM * self.var + (1 - MOMENTUM) * var)


class BottleneckBlock(nn.Module):
    def __init__(
        self, cin: int, features: int, stride: int = 1,
        dtype: torch.dtype = torch.bfloat16,
    ) -> None:
        super().__init__()
        cout = features * 4
        self.conv1 = Conv(cin, features, 1, dtype=dtype)
        self.bn1 = BatchNorm(features, dtype=dtype)
        # v1.5: the stride lives on the 3x3.
        self.conv2 = Conv(features, features, 3, stride, dtype=dtype)
        self.bn2 = BatchNorm(features, dtype=dtype)
        self.conv3 = Conv(features, cout, 1, dtype=dtype)
        self.bn3 = BatchNorm(cout, zero_scale=True, dtype=dtype)
        # flax projects when the residual's shape differs from the output's.
        if stride != 1 or cin != cout:
            self.proj = Conv(cin, cout, 1, stride, dtype=dtype)
            self.bn_proj = BatchNorm(cout, dtype=dtype)
        else:
            self.proj = None

    def forward(self, x: torch.Tensor, batch: Optional[dict]) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x), batch))
        y = F.relu(self.bn2(self.conv2(y), batch))
        y = self.bn3(self.conv3(y), batch)
        residual = x if self.proj is None else self.bn_proj(self.proj(x), batch)
        return F.relu(y + residual.to(y.dtype))


class ResNet(nn.Module):
    """stage_sizes (3, 4, 6, 3) is ResNet-50, (3, 4, 23, 3) ResNet-101."""

    def __init__(
        self, stage_sizes: Sequence[int], num_classes: int = 1000,
        dtype: torch.dtype = torch.bfloat16,
    ) -> None:
        super().__init__()
        self.dtype = dtype
        self.conv_init = Conv(3, 64, 7, 2, padding=3, dtype=dtype)
        self.bn_init = BatchNorm(64, dtype=dtype)
        self.blocks = []
        cin = 64
        for stage, n_blocks in enumerate(stage_sizes):
            for block in range(n_blocks):
                name = f"stage{stage + 1}_block{block}"
                features = 64 * 2**stage
                stride = 2 if stage > 0 and block == 0 else 1
                self.add_module(
                    name, BottleneckBlock(cin, features, stride, dtype=dtype)
                )
                self.blocks.append(name)
                cin = features * 4
        self.head = Dense(cin, num_classes, dtype=dtype)

    def forward(
        self, x: torch.Tensor, train: bool = True
    ) -> Tuple[torch.Tensor, BatchStats]:
        """``x``: NHWC ``[B, H, W, 3]``. Returns fp32 logits and, in train
        mode, each BatchNorm's batch ``(mean, var)`` by module name (empty
        in eval mode, which normalizes with the running statistics)."""
        batch: Optional[dict] = {} if train else None
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        x = F.relu(self.bn_init(self.conv_init(x), batch))
        x = F.max_pool2d(x, 3, 2, 1)
        for name in self.blocks:
            x = getattr(self, name)(x, batch)
        x = x.float().mean((2, 3)).to(self.dtype)  # global average pool
        logits = self.head(x).float()
        if batch is None:
            return logits, {}
        return logits, {n: batch[m] for n, m in self.norms() if m in batch}

    def norms(self):
        """(name, BatchNorm) of every BatchNorm layer."""
        return [(n, m) for n, m in self.named_modules() if isinstance(m, BatchNorm)]

    def batch_stats(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """The running statistics: {layer: {"mean", "var"}} (the buffers)."""
        return {n: {"mean": m.mean, "var": m.var} for n, m in self.norms()}

    @torch.no_grad()
    def load_batch_stats(self, stats: Dict[str, Dict[str, Any]]) -> None:
        """Copies {layer: {"mean", "var"}} (tensors or host arrays) into
        the running statistics."""
        for n, m in self.norms():
            m.mean.copy_(torch.as_tensor(stats[n]["mean"]))
            m.var.copy_(torch.as_tensor(stats[n]["var"]))

    def update_batch_stats(self, batch: BatchStats) -> None:
        """Steps every layer's running statistics with its batch
        ``(mean, var)`` (a train-mode forward's second output)."""
        for n, m in self.norms():
            m.update(*batch[n])


def resnet50(**kw: Any) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3), **kw)


def resnet101(**kw: Any) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 23, 3), **kw)


def resnet_tiny(**kw: Any) -> ResNet:
    """Depth-1 bottleneck stages (a bottleneck ResNet-14) for CPU tests and
    CIFAR-shaped inputs; 10 classes unless ``num_classes`` says otherwise."""
    kw.setdefault("num_classes", 10)
    return ResNet(stage_sizes=(1, 1, 1, 1), **kw)


# ---------------------------------------------------------------------------
# flax <-> port maps (numpy on the flax side)
# ---------------------------------------------------------------------------


def _flat(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flat(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _nest(flat: Dict[Tuple[str, ...], np.ndarray]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, value in flat.items():
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    return out


def params_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A flax parameter tree of :class:`ResNet` (or of ``train_ddp``'s
    ``Net``; numpy leaves, with or without the ``"params"`` level) as a
    name -> fp32 tensor dict for ``load_state_dict(strict=False)``: HWIO
    conv kernels become OIHW ``weight``s, dense ``[in, out]`` kernels
    ``[out, in]`` ones; every other leaf keeps its flax name."""
    if "params" in params:
        params = params["params"]
    out = {}
    for path, value in _flat(params):
        a = np.array(value, np.float32)
        if path[-1] == "kernel":
            a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
            path = path[:-1] + ("weight",)
        out[".".join(path)] = torch.from_numpy(np.ascontiguousarray(a))
    return out


def params_to_jax(tensors: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of :func:`params_from_jax` for parameters (or gradients
    of the same names): a flax-shaped tree of numpy arrays."""
    flat = {}
    for name, t in tensors.items():
        a = t.detach().float().cpu().numpy()
        path = tuple(name.split("."))
        if path[-1] == "weight":
            a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T
            path = path[:-1] + ("kernel",)
        flat[path] = np.ascontiguousarray(a)
    return _nest(flat)


def batch_stats_from_jax(stats: Dict[str, Any]) -> Dict[str, Dict[str, torch.Tensor]]:
    """A flax ``batch_stats`` tree (with or without the ``"batch_stats"``
    level) as {layer: {"mean", "var"}} for :meth:`ResNet.load_batch_stats`."""
    if "batch_stats" in stats:
        stats = stats["batch_stats"]
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for path, value in _flat(stats):
        out.setdefault(".".join(path[:-1]), {})[path[-1]] = torch.from_numpy(
            np.array(value, np.float32)
        )
    return out


def batch_stats_to_jax(stats: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
    """The inverse of :func:`batch_stats_from_jax`: a flax-shaped tree of
    numpy arrays."""
    return _nest({
        tuple(layer.split(".")) + (k,): np.array(
            torch.as_tensor(v).detach().float().cpu().numpy()
        )
        for layer, kv in stats.items() for k, v in kv.items()
    })
