"""paddle_tpu_torch.nn.initializer (parity: ``paddle.nn.initializer``): the
initializers live in ``core/initializer.py``; this is the public
namespace."""

from ..core.initializer import (  # noqa: F401
    Assign,
    Bilinear,
    Constant,
    Dirac,
    Initializer,
    KaimingNormal,
    KaimingUniform,
    Normal,
    Orthogonal,
    TruncatedNormal,
    Uniform,
    XavierNormal,
    XavierUniform,
    calculate_gain,
)
