"""The training step inside one replica group (mesh-free part)."""

from torchft_tpu_torch.parallel.train import (  # noqa: F401
    default_optimizer,
    grad_step,
)
