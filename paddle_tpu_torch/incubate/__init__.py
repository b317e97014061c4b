"""paddle.incubate surfaces of the PyTorch port (counterpart of
``paddle_tpu/incubate``): the fused nn functional ops (``incubate.nn.
functional``) and the ``LookAhead``, ``ModelAverage`` and ``EMA``
optimizer wrappers. The segment and graph ops, the fused softmax masks
and ``identity_loss`` of the JAX package are not ported yet (ROADMAP.md
Queue A, A8)."""

from . import nn
from .optimizer import EMA, LookAhead, ModelAverage

__all__ = ["nn", "LookAhead", "ModelAverage", "EMA"]
