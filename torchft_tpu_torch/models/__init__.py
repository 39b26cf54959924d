"""Model zoo of the PyTorch port (the flagship Llama-3-style decoder)."""

from torchft_tpu_torch.models.llama import (  # noqa: F401
    LlamaConfig,
    Transformer,
    llama3_8b,
    llama_debug,
    llama_small,
)
