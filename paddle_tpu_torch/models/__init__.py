"""Models of the PyTorch port."""

from .llama import LlamaConfig, LlamaForCausalLM
from .mamba import MambaConfig, MambaForCausalLM
from .unet import UNet2DConditionModel, UNetConfig
from .unet_sites import unet_gn_sites

__all__ = ["LlamaConfig", "LlamaForCausalLM", "MambaConfig",
           "MambaForCausalLM", "UNet2DConditionModel", "UNetConfig",
           "unet_gn_sites"]
