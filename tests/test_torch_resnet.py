"""The port's ResNet family (``torchft_tpu_torch/models/resnet.py``)
against the JAX package's flax ResNet (``torchft_tpu/models/resnet.py``):
the same seeded numpy inputs and the flax weights mapped by
``params_from_jax`` go through both.

- The strided 3x3 conv alone at even and odd sizes: flax pads SAME
  asymmetrically on an even input (0 before, 1 after).
- One BatchNorm in train mode at B=2 on 1x1 spatial: the biased batch
  variance and the 0.9 / 0.1 running update.
- ``resnet_tiny`` in train mode: logits, the new running statistics and
  every gradient, in fp32 (tight) and bf16 (loose: no further from the
  fp32 reference than 3x the JAX package's own bf16 run is).
- ResNet-50's parameter and statistics names, shapes and count against
  flax's ``eval_shape``.
- ``params_to_jax(params_from_jax(p)) == p`` and the statistics' twin, bit
  for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from flax import linen as nn

from torchft_tpu.models import resnet as jresnet
from torchft_tpu_torch.models import resnet as tresnet

# fp32: the two packages sum in different orders; errors measured on the
# CPU are 2e-5 on logits of magnitude ~2, and, relative to each leaf's
# largest value, 3e-6 on the statistics and 1.5e-4 on the gradients of
# stage 4, whose BatchNorms see B * 1 * 1 = 4 values each.
FP32_LOGITS_ATOL = 1e-4
FP32_STATS_RTOL = 1e-5
FP32_GRAD_RTOL = 1e-3
# bf16: rounding noise dominates at this size (both packages' bf16
# gradients are 15-25% off the fp32 ones in L2), so bf16 is held to the
# JAX package's own bf16 error: the port's distance from the fp32
# reference may be at most BF16_FACTOR times JAX's.
BF16_FACTOR = 3.0
B, S = 4, 32


def _rel_l2(a: dict, b: dict) -> float:
    """Relative L2 distance of two name -> array dicts, over all leaves."""
    x = np.concatenate([np.asarray(a[n], np.float32).ravel() for n in sorted(b)])
    y = np.concatenate([np.asarray(b[n], np.float32).ravel() for n in sorted(b)])
    return float(np.linalg.norm(x - y) / np.linalg.norm(y))


@functools.lru_cache(maxsize=None)
def _weights():
    """resnet_tiny's flax params with every BatchNorm scale and bias moved
    off its init (bn3's zero scale would cut the residual branches'
    gradients), running statistics moved off theirs, and a batch."""
    rng = np.random.default_rng(0)
    v = jresnet.resnet_tiny(dtype=jnp.float32).init(
        jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3))
    )

    def move(path, a):
        a = np.asarray(a, np.float32)
        if path[-1].key in ("scale", "bias"):
            a = a + 0.2 * rng.standard_normal(a.shape).astype(np.float32)
        return a

    params = jax.tree_util.tree_map_with_path(move, v["params"])
    stats = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * np.abs(rng.standard_normal(a.shape))).astype(
            np.float32
        ),
        v["batch_stats"],
    )
    x = rng.standard_normal((B, S, S, 3)).astype(np.float32)
    y = rng.integers(0, 10, B)
    return params, stats, x, y


@functools.lru_cache(maxsize=None)
def _jax_step(dtype: str):
    """flax resnet_tiny in train mode: logits, the new running statistics
    and the gradients, as the port's names."""
    params, stats, x, y = _weights()
    model = jresnet.resnet_tiny(
        dtype={"fp32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    )

    def loss_fn(p):
        logits, upd = model.apply(
            {"params": p, "batch_stats": stats}, x, mutable=["batch_stats"]
        )
        loss = optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()
        return loss, (logits, upd["batch_stats"])

    (_, (logits, new_stats)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True)
    )(params)
    host = functools.partial(jax.tree_util.tree_map, np.asarray)
    return (
        np.asarray(logits),
        _stats_flat(tresnet.batch_stats_from_jax(host(new_stats))),
        {n: t.numpy() for n, t in tresnet.params_from_jax(host(grads)).items()},
    )


def _stats_flat(stats) -> dict:
    return {
        f"{n}.{k}": np.asarray(torch.as_tensor(v).numpy())
        for n, kv in stats.items() for k, v in kv.items()
    }


def _port_step(dtype: str):
    params, stats, x, y = _weights()
    model = tresnet.resnet_tiny(
        dtype={"fp32": torch.float32, "bf16": torch.bfloat16}[dtype]
    )
    missing, unexpected = model.load_state_dict(
        tresnet.params_from_jax(params), strict=False
    )
    assert not unexpected and all(k.endswith((".mean", ".var")) for k in missing)
    model.load_batch_stats(tresnet.batch_stats_from_jax(stats))
    logits, batch = model(torch.from_numpy(x))
    F.cross_entropy(logits, torch.from_numpy(y)).backward()
    model.update_batch_stats(batch)
    return (
        logits.detach().numpy(),
        _stats_flat({n: {k: v.clone() for k, v in kv.items()}
                     for n, kv in model.batch_stats().items()}),
        {n: p.grad.numpy() for n, p in model.named_parameters()},
    )


@pytest.mark.parametrize("size", [8, 7], ids=["even", "odd"])
def test_strided_conv_pads_same_as_flax(size):
    """The stride-2 3x3 of a bottleneck's conv2 (``resnet.py:52-55``)."""
    rng = np.random.default_rng(size)
    x = rng.standard_normal((2, size, size, 4)).astype(np.float32)
    conv = nn.Conv(8, (3, 3), strides=(2, 2), use_bias=False)
    v = conv.init(jax.random.PRNGKey(1), x)
    want = np.asarray(conv.apply(v, x))
    port = tresnet.Conv(4, 8, 3, 2, dtype=torch.float32)
    port.load_state_dict(tresnet.params_from_jax(v))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = port(xt).permute(0, 2, 3, 1).detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    # The symmetric padding of F.conv2d(padding=1) is right only on odd
    # sizes: on even ones it has the shape and other values.
    naive = F.conv2d(xt, port.weight, stride=2, padding=1)
    naive = naive.permute(0, 2, 3, 1).detach().numpy()
    assert naive.shape == want.shape
    assert np.allclose(naive, want, atol=1e-5) == (size % 2 == 1)


def test_batchnorm_train_mode_biased_variance_at_two_values():
    """B=2 on 1x1 spatial: each channel's statistics see two values, where
    the unbiased variance is twice the biased one."""
    rng = np.random.default_rng(3)
    C = 6
    x = rng.standard_normal((2, 1, 1, C)).astype(np.float32)
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    params = {
        "scale": (1 + 0.3 * rng.standard_normal(C)).astype(np.float32),
        "bias": (0.3 * rng.standard_normal(C)).astype(np.float32),
    }
    ra = {
        "mean": (0.5 * rng.standard_normal(C)).astype(np.float32),
        "var": (1 + np.abs(rng.standard_normal(C))).astype(np.float32),
    }
    y, upd = bn.apply(
        {"params": params, "batch_stats": ra}, x, mutable=["batch_stats"]
    )
    port = tresnet.BatchNorm(C, dtype=torch.float32)
    port.load_state_dict(
        {**{k: torch.from_numpy(a) for k, a in params.items()},
         **{k: torch.from_numpy(a) for k, a in ra.items()}}
    )
    batch = {}
    got = port(torch.from_numpy(x).permute(0, 3, 1, 2), batch)
    port.update(*batch[port])
    np.testing.assert_allclose(
        got.permute(0, 2, 3, 1).detach().numpy(), np.asarray(y), atol=1e-5
    )
    for k in ("mean", "var"):
        np.testing.assert_allclose(
            getattr(port, k).numpy(), np.asarray(upd["batch_stats"][k]), rtol=1e-6
        )
    # torch's own BatchNorm keeps the unbiased variance: another result.
    rv = torch.from_numpy(ra["var"].copy())
    F.batch_norm(
        torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(ra["mean"].copy()),
        rv, training=True, momentum=0.1, eps=1e-5,
    )
    assert not np.allclose(rv.numpy(), np.asarray(upd["batch_stats"]["var"]), rtol=1e-3)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_resnet_tiny_train_step_matches_flax(dtype):
    logits, stats, grads = _port_step(dtype)
    j_logits, j_stats, j_grads = _jax_step(dtype)
    assert set(grads) == set(j_grads) and set(stats) == set(j_stats)
    assert logits.dtype == np.float32 and logits.shape == (B, 10)
    if dtype == "fp32":
        np.testing.assert_allclose(logits, j_logits, atol=FP32_LOGITS_ATOL)
        for n in stats:
            np.testing.assert_allclose(
                stats[n], j_stats[n], atol=FP32_STATS_RTOL * np.abs(j_stats[n]).max(),
                err_msg=n,
            )
        for n in grads:
            scale = np.abs(j_grads[n]).max()
            assert scale > 0, f"{n}: no gradient reaches this leaf"
            np.testing.assert_allclose(grads[n], j_grads[n],
                                       atol=FP32_GRAD_RTOL * scale, err_msg=n)
        return
    ref_logits, ref_stats, ref_grads = _jax_step("fp32")
    for name, port, jax_, ref in (
        ("logits", {"l": logits}, {"l": j_logits}, {"l": ref_logits}),
        ("statistics", stats, j_stats, ref_stats),
        ("gradients", grads, j_grads, ref_grads),
    ):
        ours, theirs = _rel_l2(port, ref), _rel_l2(jax_, ref)
        assert ours <= BF16_FACTOR * theirs, (name, ours, theirs)


def test_resnet_tiny_eval_mode_matches_flax():
    """``train=False`` normalizes with the running statistics and leaves
    them as they are."""
    params, stats, x, _ = _weights()
    want = jresnet.resnet_tiny(dtype=jnp.float32).apply(
        {"params": params, "batch_stats": stats}, x, train=False
    )
    model = tresnet.resnet_tiny(dtype=torch.float32)
    model.load_state_dict(tresnet.params_from_jax(params), strict=False)
    model.load_batch_stats(tresnet.batch_stats_from_jax(stats))
    logits, batch = model(torch.from_numpy(x), train=False)
    assert batch == {}
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want),
                               atol=FP32_LOGITS_ATOL)


def test_resnet50_names_shapes_and_count_match_flax():
    """ResNet-50 (``tests/test_models.py:239-256``) at 224x224, 1000
    classes, without a forward: every flax leaf maps to one port tensor of
    the transposed shape, and nothing else exists."""
    shapes = jax.eval_shape(
        lambda: jresnet.resnet50().init(
            jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3))
        )
    )
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes["params"])[0]:
        keys = [p.key for p in path]
        shape = leaf.shape
        if keys[-1] == "kernel":
            keys[-1] = "weight"
            shape = (shape[3], shape[2], shape[0], shape[1]) if len(shape) == 4 else shape[::-1]
        want[".".join(keys)] = tuple(shape)
    with torch.device("meta"):
        model = tresnet.resnet50()
    got = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert got == want
    n = sum(int(np.prod(s)) for s in got.values())
    assert n == 25_557_032, n  # ResNet-50 v1.5's published count
    stats = {
        ".".join(p.key for p in path): tuple(leaf.shape)
        for path, leaf in jax.tree_util.tree_flatten_with_path(shapes["batch_stats"])[0]
    }
    assert stats == {
        f"{n}.{k}": tuple(v.shape)
        for n, kv in model.batch_stats().items() for k, v in kv.items()
    }
    # The wire lays leaves out in sorted name order, JAX's flatten order.
    assert sorted(got) == list(want)


def test_params_and_stats_round_trip_bit_for_bit():
    params, stats, _, _ = _weights()
    back = tresnet.params_to_jax(tresnet.params_from_jax({"params": params}))
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert np.asarray(a).tobytes() == b.tobytes() and a.shape == b.shape, path
    back = tresnet.batch_stats_to_jax(tresnet.batch_stats_from_jax({"batch_stats": stats}))
    for (path, a), (_, b) in zip(
        jax.tree_util.tree_flatten_with_path(stats)[0],
        jax.tree_util.tree_flatten_with_path(back)[0],
    ):
        assert np.asarray(a).tobytes() == b.tobytes(), path
