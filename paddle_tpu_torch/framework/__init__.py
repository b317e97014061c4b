"""paddle.framework surfaces of the PyTorch port (counterpart of
``paddle_tpu/framework``): ``io``, the single-file ``save``/``load``."""

from . import io  # noqa: F401
