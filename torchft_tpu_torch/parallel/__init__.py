"""The training step inside one replica group: meshes, ring and Ulysses
attention, the GPipe pipeline, model building, loss, gradients and the
optimizer."""

from torchft_tpu_torch.parallel.mesh import (  # noqa: F401
    MESH_AXES,
    Mesh,
    auto_mesh,
    make_mesh,
)
from torchft_tpu_torch.parallel.pipeline import (  # noqa: F401
    gpipe_loop,
    make_pipeline_loss,
)
from torchft_tpu_torch.parallel.ring_attention import (  # noqa: F401
    make_ring_attention,
    ring_attention_shard,
    ring_attention_shard_flash,
)
from torchft_tpu_torch.parallel.train import (  # noqa: F401
    build_model,
    default_optimizer,
    grad_step,
    pipeline_grad_step,
)
from torchft_tpu_torch.parallel.ulysses import make_ulysses_attention  # noqa: F401
