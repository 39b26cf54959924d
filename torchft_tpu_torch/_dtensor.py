"""Type tests for torch DTensors, shared by the collective, optimizer and
checkpoint layers (none of which needs the rest of ``parallel``)."""

from __future__ import annotations

from typing import Any


def is_dtensor(x: Any) -> bool:
    """Whether ``x`` is a torch DTensor (without importing torch)."""
    return type(x).__name__ == "DTensor" and hasattr(x, "to_local")


def local(x: Any) -> Any:
    """This rank's shard of a DTensor; anything else as it is."""
    return x.to_local() if is_dtensor(x) else x
