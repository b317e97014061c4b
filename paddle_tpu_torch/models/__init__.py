"""Models of the PyTorch port."""

from .llama import LlamaConfig, LlamaForCausalLM
from .mamba import MambaConfig, MambaForCausalLM
from .unet import UNet2DConditionModel, UNetConfig

__all__ = ["LlamaConfig", "LlamaForCausalLM", "MambaConfig",
           "MambaForCausalLM", "UNet2DConditionModel", "UNetConfig"]
