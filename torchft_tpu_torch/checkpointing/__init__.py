from torchft_tpu_torch.checkpointing.http_transport import HTTPTransport  # noqa: F401
from torchft_tpu_torch.checkpointing.transport import CheckpointTransport  # noqa: F401
