"""The training step inside one replica group: meshes (process axes dp and
fsdp, in-process axes pp, ep, sp and tp), sharding rules, ring and Ulysses
attention, the GPipe pipeline, model building, the sharded train state and
steps, loss, gradients and the optimizer."""

from torchft_tpu_torch.parallel.mesh import (  # noqa: F401
    MESH_AXES,
    Mesh,
    auto_mesh,
    make_mesh,
    make_multislice_mesh,
)
from torchft_tpu_torch.parallel.sharding import (  # noqa: F401
    batch_sharding,
    param_shardings,
    param_specs,
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
    TrainState,
    build_model,
    default_optimizer,
    grad_step,
    init_train_state,
    make_eval_step,
    make_grad_step,
    make_train_step,
    pipeline_grad_step,
)
from torchft_tpu_torch.parallel.ulysses import make_ulysses_attention  # noqa: F401
