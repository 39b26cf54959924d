"""Model zoo of the PyTorch port: the Llama-3-style decoder and the ResNet
v1.5 family."""

from torchft_tpu_torch.models.llama import (  # noqa: F401
    LlamaConfig,
    Transformer,
    llama3_8b,
    llama_debug,
    llama_moe_debug,
    llama_small,
)
from torchft_tpu_torch.models.resnet import (  # noqa: F401
    BottleneckBlock,
    ResNet,
    resnet50,
    resnet101,
    resnet_tiny,
)
