"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu`` for one
NVIDIA H100.

It mirrors the JAX package's layout module for module and is held
against it: the same weights go in and the same numbers come out. Where
the JAX package has a Pallas kernel on the path, the port has a kernel
written by hand for Hopper (``kernels/csrc``), built with ``nvcc`` at
first use. The port imports neither JAX nor anything of ``paddle_tpu``.

Every layer and model is a ``nn.Layer`` (``core/module.py``: Paddle's
module API on ``nn.Module``). It serves Llama through the
continuous-batching engine (``inference/serving.py``) with contiguous KV
caches or a paged pool (``inference/paged.py``), float or int8, over bf16
weights or int8/int4 weight-only quantized ones (``quantization``), and
trains it on one card (``trainer.TrainStep`` with ``optimizer.AdamW``,
float32 masters and the flash-attention kernels), as it trains Mamba
(the selective-scan kernels, with quantization-aware training through
``quantization.QAT``), RWKV and the SD UNet (channels-last, the fused
GroupNorm kernels). ``distributed`` trains over a mesh of processes
(data, tensor, sequence, expert and pipeline parallelism, ZeRO 1-3) and
saves sharded checkpoints in the JAX package's layout. ``fft``,
``signal``, ``audio``, ``metric`` and ``errors`` are the JAX package's
modules of those names; ROADMAP.md lists what comes next.
"""

from . import errors, flags

# PT_FLAGS_default_matmul_precision: applied once at import, as the JAX
# package applies it; empty leaves torch's defaults
flags.apply_matmul_precision()

from .core.dtype import get_default_dtype, set_default_dtype
from .core.parameter import ParamAttr
from .core.random import get_seed, seed
from .device import get_device, set_device
from . import audio, fft, metric, signal

__all__ = ["ParamAttr", "audio", "errors", "fft", "flags", "get_default_dtype",
           "get_device", "get_seed", "metric", "seed", "set_default_dtype",
           "set_device", "signal"]
