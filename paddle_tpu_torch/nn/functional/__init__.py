"""Functional ops on the port's paths (counterparts of
``paddle_tpu/nn/functional``)."""

from .activation import (
    celu,
    elu,
    gelu,
    glu,
    hardshrink,
    hardsigmoid,
    hardswish,
    hardtanh,
    leaky_relu,
    log_sigmoid,
    log_softmax,
    mish,
    prelu,
    relu,
    relu6,
    rrelu,
    selu,
    sigmoid,
    silu,
    softmax,
    softplus,
    softshrink,
    softsign,
    swiglu,
    tanh,
    tanhshrink,
    thresholded_relu,
)
from .common import (
    alpha_dropout,
    bilinear,
    channel_shuffle,
    cosine_similarity,
    dropout,
    dropout2d,
    dropout3d,
    fold,
    gumbel_softmax,
    interpolate,
    label_smooth,
    linear,
    pad,
    pairwise_distance,
    sequence_mask,
    temporal_shift,
    unfold,
    upsample,
    zeropad2d,
)
from .conv import (
    conv1d,
    conv1d_transpose,
    conv2d,
    conv2d_transpose,
    conv3d,
    conv3d_transpose,
)
from .flash_attention import flash_attention, scaled_dot_product_attention
from .input import embedding
from .loss import cross_entropy
from .norm import (
    group_norm,
    layer_norm,
    local_response_norm,
    normalize,
    rms_norm,
)
from .pooling import (
    adaptive_avg_pool1d,
    adaptive_avg_pool2d,
    adaptive_avg_pool3d,
    adaptive_max_pool1d,
    adaptive_max_pool2d,
    avg_pool1d,
    avg_pool2d,
    avg_pool3d,
    max_pool1d,
    max_pool2d,
    max_pool3d,
)
from .vision import affine_grid, grid_sample, pixel_shuffle, pixel_unshuffle

__all__ = [
    "adaptive_avg_pool1d", "adaptive_avg_pool2d", "adaptive_avg_pool3d",
    "adaptive_max_pool1d", "adaptive_max_pool2d", "affine_grid",
    "alpha_dropout", "avg_pool1d", "avg_pool2d", "avg_pool3d", "bilinear",
    "celu", "channel_shuffle", "conv1d", "conv1d_transpose", "conv2d",
    "conv2d_transpose", "conv3d", "conv3d_transpose", "cosine_similarity",
    "cross_entropy", "dropout", "dropout2d", "dropout3d", "elu",
    "embedding", "flash_attention", "fold", "gelu", "glu", "grid_sample",
    "group_norm", "gumbel_softmax", "hardshrink", "hardsigmoid",
    "hardswish", "hardtanh", "interpolate", "label_smooth", "layer_norm",
    "leaky_relu", "linear", "local_response_norm", "log_sigmoid",
    "log_softmax", "max_pool1d", "max_pool2d", "max_pool3d", "mish",
    "normalize", "pad", "pairwise_distance", "pixel_shuffle",
    "pixel_unshuffle", "prelu", "relu", "relu6", "rms_norm", "rrelu",
    "scaled_dot_product_attention", "selu", "sequence_mask", "sigmoid",
    "silu", "softmax", "softplus", "softshrink", "softsign", "swiglu",
    "tanh", "tanhshrink", "temporal_shift", "thresholded_relu", "unfold",
    "upsample", "zeropad2d"]
