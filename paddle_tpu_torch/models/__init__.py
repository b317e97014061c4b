"""Models of the PyTorch port."""

from .bert import (
    BertConfig,
    BertForMaskedLM,
    BertForSequenceClassification,
    BertModel,
    ErnieConfig,
    ErnieForMaskedLM,
    ErnieForSequenceClassification,
    ErnieModel,
)
from .ernie_moe import ErnieMoEConfig, ErnieMoEForCausalLM
from .gpt import GPTConfig, GPTForCausalLM, GPTModel
from .llama import (
    LlamaConfig,
    LlamaForCausalLM,
    LlamaPipeBlock,
    llama_pipeline_module,
)
from .mamba import MambaConfig, MambaForCausalLM
from .rwkv import (
    RWKVBlock,
    RWKVChannelMix,
    RWKVConfig,
    RWKVForCausalLM,
    RWKVTimeMix,
    wkv_associative,
    wkv_reference,
)
from .t5 import T5Config, T5ForConditionalGeneration, T5Model
from .unet import UNet2DConditionModel, UNetConfig
from .unet_sites import unet_gn_sites
from .vit import ViT, ViTBlock, ViTConfig

__all__ = ["BertConfig", "BertForMaskedLM", "BertForSequenceClassification",
           "BertModel", "ErnieConfig", "ErnieForMaskedLM",
           "ErnieForSequenceClassification", "ErnieModel", "ErnieMoEConfig",
           "ErnieMoEForCausalLM", "GPTConfig", "GPTForCausalLM", "GPTModel",
           "LlamaConfig", "LlamaForCausalLM", "MambaConfig",
           "MambaForCausalLM", "RWKVBlock", "RWKVChannelMix", "RWKVConfig",
           "RWKVForCausalLM", "RWKVTimeMix", "T5Config", "T5ForConditionalGeneration",
           "T5Model", "UNet2DConditionModel", "UNetConfig", "ViT",
           "ViTBlock", "ViTConfig", "unet_gn_sites", "wkv_associative",
           "wkv_reference"]
