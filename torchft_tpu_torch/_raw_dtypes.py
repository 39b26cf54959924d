"""Dtypes the port's numpy lacks, carried as the raw bits of an integer of
their width.

The JAX package holds bfloat16 in numpy through ``ml_dtypes``, and its
socket headers, native engine metas and checkpoint metas name it
``"bfloat16"``. The port needs no ``ml_dtypes``: a bfloat16 buffer is an
int16 array whose dtype names ``"bfloat16"`` in its metadata (:data:`BF16`).
It goes on every wire under the JAX package's name, and a received
``"bfloat16"`` is read back as the same carrier, so the bytes and the header
are the JAX package's in both directions.

Arithmetic on a carrier goes through fp32 and rounds to nearest even, as
``ml_dtypes`` does for its bfloat16 ufuncs, so a bfloat16 reduce on the port
gives the JAX package's bits.
"""

from __future__ import annotations

from typing import Any

import numpy as np

BF16 = np.dtype(np.int16, metadata={"wire": "bfloat16"})
_CARRIERS = {"bfloat16": BF16}


def wire_name(dtype: np.dtype) -> str:
    """The name a buffer of ``dtype`` travels under: a carrier's own name,
    else numpy's (``"bfloat16"`` for an ``ml_dtypes`` array too)."""
    meta = dtype.metadata
    if meta and "wire" in meta:
        return meta["wire"]
    return str(dtype)


def from_wire_name(name: str) -> np.dtype:
    """The numpy dtype a buffer named ``name`` on the wire is read as."""
    return _CARRIERS.get(name) or np.dtype(name)


def is_raw_name(name: str) -> bool:
    """Whether ``name`` is a dtype numpy lacks, which travels in a carrier."""
    return name in _CARRIERS


def is_raw(dtype: np.dtype) -> bool:
    """Whether ``dtype`` holds a dtype numpy lacks (a carrier, or
    ``ml_dtypes``' bfloat16 where it is installed)."""
    return is_raw_name(wire_name(dtype))


def as_carrier(arr: Any) -> np.ndarray:
    """``arr`` as the port handles it: an ``ml_dtypes`` bfloat16 array
    becomes a carrier view of the same memory; anything else is itself."""
    a = np.asarray(arr)
    name = wire_name(a.dtype)
    if name in _CARRIERS and a.dtype.metadata is None:
        return a.view(_CARRIERS[name])
    return a


def bf16_to_f32(bits: np.ndarray) -> np.ndarray:
    """The fp32 values of bfloat16 bits (exact)."""
    wide = bits.view(np.uint16).astype(np.uint32) << np.uint32(16)
    return wide.view(np.float32)


def f32_to_bf16(x: np.ndarray) -> np.ndarray:
    """fp32 values rounded to nearest even bfloat16, as int16 bits; a NaN
    becomes the quiet NaN of its sign (0x7FC0 or 0xFFC0), as in
    ``ml_dtypes``."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    rounded = (u + (np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1)))) >> np.uint32(16)
    nan = (u & np.uint32(0x7FFFFFFF)) > np.uint32(0x7F800000)
    quiet = np.where(u >> np.uint32(31), np.uint32(0xFFC0), np.uint32(0x7FC0))
    return np.where(nan, quiet, rounded).astype(np.uint16).view(np.int16)
