"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu`` for one
NVIDIA H100.

It mirrors the JAX package's layout module for module and is held
against it: the same weights go in and the same numbers come out. Where
the JAX package has a Pallas kernel on the path, the port has a kernel
written by hand for Hopper (``kernels/csrc``), built with ``nvcc`` at
first use. The port imports neither JAX nor anything of ``paddle_tpu``.

``import paddle_tpu_torch as paddle`` gives the Paddle namespace of the
JAX package's top level: the tensor functions (``tensor.py``:
``to_tensor``, the creation, math and random functions), the dtypes,
``Layer``/``Parameter``/``ParamAttr``, ``seed``, ``save``/``load``,
``no_grad``/``grad``/``set_grad_enabled``, ``DataParallel``, the
places, ``Model`` with ``summary``/``flops`` and the subpackages (``amp``,
``autograd``, ``io``, ``nn``, ``optimizer``, ``distributed``,
``inference``, ``models``, ``jit`` and ``static`` on ``torch.export``,
``linalg``, ``distribution``, ``sparse``, ``profiler``, ...). Importing it builds nothing and touches
no CUDA context; the tensor is ``torch.Tensor``, whose methods the port
does not patch.

Every layer and model is a ``nn.Layer`` (``core/module.py``: Paddle's
module API on ``nn.Module``). It serves Llama through the
continuous-batching engine (``inference/serving.py``) with contiguous KV
caches or a paged pool (``inference/paged.py``), float or int8, over bf16
weights or int8/int4 weight-only quantized ones (``quantization``), and
trains it on one card (``trainer.TrainStep`` with ``optimizer.AdamW``,
float32 masters and the flash-attention kernels, or ``Model.fit``), as
it trains Mamba (the selective-scan kernels, with quantization-aware
training through ``quantization.QAT``), RWKV and the SD UNet
(channels-last, the fused GroupNorm kernels). ``distributed`` trains
over a mesh of processes (data, tensor, sequence, expert and pipeline
parallelism, ZeRO 1-3) and saves sharded checkpoints in the JAX
package's layout. ROADMAP.md lists what comes next.
"""

from . import errors, flags

# PT_FLAGS_default_matmul_precision: applied once at import, as the JAX
# package applies it; empty leaves torch's defaults
flags.apply_matmul_precision()

import torch as _torch  # noqa: E402

from . import amp  # noqa: F401,E402
from . import audio  # noqa: F401,E402
from . import autograd  # noqa: F401,E402
from . import device  # noqa: F401,E402
from . import distribution  # noqa: F401,E402
from . import fft  # noqa: F401,E402
from . import generation  # noqa: F401,E402
from . import incubate  # noqa: F401,E402
from . import jit  # noqa: F401,E402
from . import linalg  # noqa: F401,E402
from . import metric  # noqa: F401,E402
from . import nn  # noqa: F401,E402
from . import optimizer  # noqa: F401,E402
from . import signal  # noqa: F401,E402
from . import static  # noqa: F401,E402
from . import utils  # noqa: F401,E402
from .hapi.summary import flops, summary  # noqa: F401,E402
from . import sparse  # noqa: F401,E402
from . import vision  # noqa: F401,E402
from .core.dtype import (  # noqa: F401,E402
    bfloat16,
    bool_,
    complex64,
    complex128,
    float16,
    float32,
    float64,
    get_default_dtype,
    int8,
    int16,
    int32,
    int64,
    set_default_dtype,
    uint8,
)
from .core.functional import functional_call  # noqa: F401,E402
from .core.module import Layer  # noqa: F401,E402
from .core.parameter import Parameter  # noqa: F401,E402
from .core.random import get_rng_state_tracker, get_seed, seed  # noqa: F401,E402,E501
from .tensor import *  # noqa: F401,F403,E402
from .tensor import to_tensor  # noqa: F401,E402
from .version import full_version as __version__  # noqa: F401,E402


def save(obj, path):
    """Parity: ``paddle.save`` (``framework.io.save``)."""
    from .framework import io

    return io.save(obj, path)


def load(path, return_numpy=False, device=None):
    """Parity: ``paddle.load`` (``framework.io.load``): tensors on
    ``device``, the card by default."""
    from .framework import io

    return io.load(path, return_numpy=return_numpy, device=device)


no_grad = autograd.no_grad


def iinfo(dtype):
    from .core.dtype import convert_dtype

    return _torch.iinfo(convert_dtype(dtype))


def finfo(dtype):
    from .core.dtype import convert_dtype

    return _torch.finfo(convert_dtype(dtype))


from . import observability  # noqa: F401,E402
from . import distributed  # noqa: F401,E402
from . import inference  # noqa: F401,E402
from . import profiler  # noqa: F401,E402
from . import io  # noqa: F401,E402
from . import models  # noqa: F401,E402
from .core.parameter import ParamAttr  # noqa: F401,E402
from .device import get_device, set_device  # noqa: F401,E402

#: the tensor type is torch.Tensor (see tensor.py's module docstring)
Tensor = _torch.Tensor
bool = bool_  # noqa: A001  (paddle.bool is a public dtype name)


class CPUPlace:
    """Parity: ``paddle.CPUPlace``: the host (``device`` is
    ``torch.device("cpu")``); ``to_tensor(place=...)`` takes it."""

    @property
    def device(self) -> _torch.device:
        return _torch.device("cpu")

    def __repr__(self):
        return "Place(cpu)"

    def __eq__(self, other):
        return type(other) is type(self)

    def __hash__(self):
        return hash(type(self))


class CUDAPlace:
    """Parity: ``paddle.CUDAPlace(id)``: the card ``cuda:id``."""

    def __init__(self, device_id: int = 0):
        self.device_id = device_id

    @property
    def device(self) -> _torch.device:
        return _torch.device("cuda", self.device_id)

    def __repr__(self):
        return f"Place(gpu:{self.device_id})"

    def __eq__(self, other):
        return (type(other) is type(self)
                and other.device_id == self.device_id)

    def __hash__(self):
        return hash((type(self), self.device_id))


XPUPlace = CUDAPlace


def grad(outputs, inputs=None, grad_outputs=None, **kw):
    """Parity adapter for ``paddle.grad`` with the JAX package's contract:
    ``outputs`` is the callable producing the outputs and ``inputs`` its
    arguments; ``grad(f, (x, y))`` returns (df/dx, df/dy) at (x, y)
    (``torch.func.grad``). Passing tensors raises with the hint (the
    port adds no tape form that the JAX package lacks)."""
    if callable(outputs) and inputs is not None:
        args = tuple(inputs) if isinstance(inputs, (list, tuple)) \
            else (inputs,)
        return _torch.func.grad(outputs,
                                argnums=tuple(range(len(args))))(*args)
    raise TypeError(
        "paddle_tpu_torch.grad takes the function and its inputs, e.g. "
        "grad(lambda x: loss(x), (x,)); see autograd.functional for "
        "vjp/jvp/jacobian/hessian")


#: torch's: sets the mode when called and restores it when its block
#: ends, and ``is_grad_enabled`` reads it (as the JAX flag does)
set_grad_enabled = _torch.set_grad_enabled
is_grad_enabled = _torch.is_grad_enabled


class DataParallel(Layer):
    """Parity: ``paddle.DataParallel(model)``, a passthrough as in JAX:
    over a mesh, ``TrainStep`` (``distributed``) reduces the gradients.
    It exists so migrating training scripts keep their structure; its
    ``state_dict`` is the unwrapped model's, so a checkpoint loads into
    the bare model."""

    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        super().__init__()
        self._layers = layers

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, use_structured_name=True):
        return self._layers.set_state_dict(state_dict, use_structured_name)

    load_dict = set_state_dict

    def __getattr__(self, name):
        try:
            return super().__getattr__(name)
        except AttributeError:
            if name == "_layers":
                raise
            return getattr(self._layers, name)


from .hapi import Model  # noqa: F401,E402
from .hapi import callbacks  # noqa: F401,E402
from . import onnx  # noqa: F401,E402
from . import hub  # noqa: F401,E402
