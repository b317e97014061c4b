"""The vision domain of the port (counterpart of
``paddle_tpu/vision/``): the model zoo (``models``), the detection ops
(``ops``), the host-side transforms (``transforms``) and the datasets
over local files (``datasets``)."""

from . import datasets, ops, transforms  # noqa: F401
from . import models
from .models import *  # noqa: F401,F403
from .models import __all__ as _models

__all__ = ["models", "datasets", "ops", "transforms", *_models]
