"""The vision domain of the port (counterpart of
``paddle_tpu/vision/``): the model zoo. ``datasets``, ``transforms`` and
``ops`` are not ported yet (ROADMAP.md Queue A8)."""

from . import models
from .models import *  # noqa: F401,F403
from .models import __all__ as _models

__all__ = ["models", *_models]
