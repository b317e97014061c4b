"""The high-level API of the PyTorch port (counterpart of
``paddle_tpu/hapi``): ``Model``, the callbacks, ``summary`` and
``flops``."""

from .callbacks import (  # noqa: F401
    Callback,
    EarlyStopping,
    LRScheduler,
    LRSchedulerCallback,
    ReduceLROnPlateau,
    VisualDL,
    ModelCheckpoint,
    ProgBarLogger,
)
from .model import Model  # noqa: F401

from .summary import flops, summary  # noqa: F401,E402
