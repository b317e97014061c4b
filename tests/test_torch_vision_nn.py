"""The port's vision nn surface against the JAX package on the CPU:
every pooling function, the convolutions (1-3-D, transposed, string and
per-side paddings), ``normalize`` and ``local_response_norm``, the rest
of ``functional/common.py`` and ``functional/vision.py``, and every
layer that wraps them, in both layouts where a function has two.
Inputs come from numpy seeds; forwards within 1e-5, gradients (the
vector-Jacobian product of a seeded cotangent) within 1e-4 of each
tensor's largest entry (``tests/torch_parity.py``). The random
functions are held by their deterministic limits and their statistics,
not their masks. BatchNorm's buffers are held against the JAX layer run
eagerly."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import nn as jnn
from paddle_tpu.nn import functional as JF
from paddle_tpu.nn import layout as jlayout
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.convert import load_numpy_state_dict
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.nn import layout as tlayout
from torch_parity import as_np, close, jit_o0, scaled_close


def _rand(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _first(out):
    return out[0] if isinstance(out, (tuple, list)) else out


def _outs(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def jax_side(jfn, arrays, kw=None, grad=True):
    """Traceable: ``jfn``'s outputs and, with ``grad``, the gradients of
    ``sum(first output * the seeded cotangent)`` with respect to every
    float array."""
    kw = kw or {}
    fl = [i for i, a in enumerate(arrays) if a.dtype.kind == "f"]
    outs = _outs(jfn(*[jnp.asarray(a) for a in arrays], **kw))
    if not grad:
        return outs, ()

    def f(*floats):
        args = [jnp.asarray(a) for a in arrays]
        for i, v in zip(fl, floats):
            args[i] = v
        return _first(jfn(*args, **kw))

    _, vjp = jax.vjp(f, *[jnp.asarray(arrays[i]) for i in fl])
    return outs, vjp(jnp.asarray(_rand(tuple(outs[0].shape), seed=99)))


# cases whose JAX function reads a value on the host (not traceable)
EAGER = ("sequence_mask_bool",)


def jax_group(cases):
    """Every case's ``jax_side`` in one jitted call (one compile for the
    group, not one a primitive): ``{id: (outputs, gradients)}``; the
    ``EAGER`` cases run eagerly."""
    def body():
        return {cid: jax_side(*c) for cid, c in cases.items()
                if cid not in EAGER}

    out = jit_o0(body)
    out.update({cid: jax_side(*c) for cid, c in cases.items()
                if cid in EAGER})
    return jax.tree_util.tree_map(np.asarray, out)


def torch_check(tfn, arrays, kw, want, tol=1e-5):
    """``tfn`` on the arrays as tensors against ``want`` from
    ``jax_side``."""
    outs, grads = want
    fl = [i for i, a in enumerate(arrays) if a.dtype.kind == "f"]
    tx = [torch.tensor(a, requires_grad=bool(grads) and i in fl)
          for i, a in enumerate(arrays)]
    got = _outs(tfn(*tx, **(kw or {})))
    assert len(got) == len(outs)
    for g, w in zip(got, outs):
        assert tuple(g.shape) == tuple(w.shape)
        if g.dtype.is_floating_point:
            close(g, w, tol)
        else:
            np.testing.assert_array_equal(g.numpy(), w)
    if not grads:
        return
    ct = torch.tensor(_rand(tuple(got[0].shape), seed=99))
    (got[0] * ct).sum().backward()
    for i, w in zip(fl, grads):
        # an input the output does not reach (a nearest sample's grid)
        # has no torch gradient and zeros in JAX
        scaled_close(tx[i].grad if tx[i].grad is not None
                     else torch.zeros(arrays[i].shape), w)


def run(jfn, tfn, arrays, kw=None, grad=True, tol=1e-5):
    """One case: ``jax_side`` jitted, then ``torch_check``."""
    want = jax.tree_util.tree_map(np.asarray, jit_o0(
        lambda: jax_side(jfn, arrays, kw, grad)))
    torch_check(tfn, arrays, kw, want, tol)


def _nhwc(a):
    return np.ascontiguousarray(np.moveaxis(a, 1, -1))


X4 = _rand((2, 3, 9, 10))
X3 = _rand((2, 4, 11))
X5 = _rand((2, 3, 6, 7, 8))


def _fn(name):
    return getattr(JF, name), getattr(TF, name)


# (name, function name, arrays, keyword arguments[, grad])
POOL_CASES = [
    ("max2d", "max_pool2d", [X4], dict(kernel_size=3, stride=2, padding=1)),
    ("max2d_pairs", "max_pool2d", [X4],
     dict(kernel_size=(3, 2), stride=(2, 1), padding=[(2, 0), (0, 1)])),
    ("max2d_nhwc", "max_pool2d", [_nhwc(X4)],
     dict(kernel_size=3, stride=2, padding=1, data_format="NHWC")),
    ("avg2d", "avg_pool2d", [X4], dict(kernel_size=3, stride=1, padding=1)),
    ("avg2d_nopad", "avg_pool2d", [X4], dict(kernel_size=2)),
    ("avg2d_pairs", "avg_pool2d", [X4],
     dict(kernel_size=3, stride=2, padding=[(0, 2), (1, 1)])),
    ("avg2d_nhwc", "avg_pool2d", [_nhwc(X4)],
     dict(kernel_size=3, stride=2, padding=1, data_format="NHWC")),
    ("adaptive_avg2d_div", "adaptive_avg_pool2d", [X4[:, :, :8, :10]],
     dict(output_size=(4, 5))),
    ("adaptive_avg2d", "adaptive_avg_pool2d", [X4], dict(output_size=4)),
    ("adaptive_avg2d_nhwc", "adaptive_avg_pool2d", [_nhwc(X4)],
     dict(output_size=(4, 3), data_format="NHWC")),
    ("adaptive_avg2d_nhwc_div", "adaptive_avg_pool2d", [_nhwc(X4)],
     dict(output_size=(3, 5), data_format="NHWC")),
    ("max3d", "max_pool3d", [X5], dict(kernel_size=2, stride=2)),
    ("max3d_ndhwc", "max_pool3d", [np.moveaxis(X5, 1, -1).copy()],
     dict(kernel_size=3, stride=2, padding=1, data_format="NDHWC")),
    ("avg3d", "avg_pool3d", [X5], dict(kernel_size=3, stride=2, padding=1)),
    ("avg3d_ndhwc", "avg_pool3d", [np.moveaxis(X5, 1, -1).copy()],
     dict(kernel_size=2, data_format="NDHWC")),
    ("adaptive_avg1d_div", "adaptive_avg_pool1d", [X3[:, :, :10]],
     dict(output_size=5)),
    ("adaptive_avg1d", "adaptive_avg_pool1d", [X3], dict(output_size=4)),
    ("adaptive_avg3d_div", "adaptive_avg_pool3d", [X5],
     dict(output_size=(3, 7, 4))),
    ("adaptive_avg3d", "adaptive_avg_pool3d", [X5],
     dict(output_size=(4, 3, 5))),
    ("adaptive_avg3d_ndhwc", "adaptive_avg_pool3d",
     [np.moveaxis(X5, 1, -1).copy()],
     dict(output_size=4, data_format="NDHWC")),
    ("adaptive_max2d_div", "adaptive_max_pool2d", [X4[:, :, :8, :10]],
     dict(output_size=(2, 5))),
    ("adaptive_max2d", "adaptive_max_pool2d", [X4], dict(output_size=4)),
    ("adaptive_max2d_mask", "adaptive_max_pool2d", [X4],
     dict(output_size=(4, 3), return_mask=True)),
    ("adaptive_max2d_nhwc_mask", "adaptive_max_pool2d", [_nhwc(X4)],
     dict(output_size=(3, 4), return_mask=True, data_format="NHWC")),
    ("max1d", "max_pool1d", [X3], dict(kernel_size=3, stride=2, padding=1)),
    ("max1d_nlc", "max_pool1d", [np.moveaxis(X3, 1, -1).copy()],
     dict(kernel_size=2, data_format="NLC")),
    ("avg1d", "avg_pool1d", [X3], dict(kernel_size=4, stride=3, padding=2)),
    ("avg1d_nlc", "avg_pool1d", [np.moveaxis(X3, 1, -1).copy()],
     dict(kernel_size=3, stride=1, padding=1, data_format="NLC")),
    ("adaptive_max1d", "adaptive_max_pool1d", [X3], dict(output_size=4)),
    ("adaptive_max1d_mask", "adaptive_max_pool1d", [X3],
     dict(output_size=3, return_mask=True)),
]


def _group(cases, grad=lambda name: True):
    return jax_group({c[0]: (getattr(JF, c[1]), c[2], c[3], grad(c[1]))
                      for c in cases})


@pytest.fixture(scope="module")
def pool_want():
    return _group(POOL_CASES)


@pytest.mark.parametrize("case", POOL_CASES, ids=[c[0] for c in POOL_CASES])
def test_pooling_matches_jax(case, pool_want):
    cid, name, arrays, kw = case
    torch_check(getattr(TF, name), arrays, kw, pool_want[cid])


def test_pools_resolve_nchw_to_nhwc_in_the_channels_last_scope():
    x = _nhwc(X4)
    for name, kw in (("max_pool2d", dict(kernel_size=3, stride=2,
                                         padding=1)),
                     ("avg_pool2d", dict(kernel_size=2)),
                     ("adaptive_avg_pool2d", dict(output_size=4)),
                     ("adaptive_max_pool2d", dict(output_size=(3, 4),
                                                  return_mask=True))):
        jfn, tfn = _fn(name)
        with jlayout.channels_last_scope(), tlayout.channels_last_scope():
            run(jfn, tfn, [x], kw, grad=False)


W2 = _rand((4, 3, 3, 2), seed=1)
W2G = _rand((6, 1, 3, 3), seed=1)       # groups 3
W1 = _rand((5, 4, 3), seed=2)
W3 = _rand((4, 3, 2, 3, 2), seed=3)
B4, B5, B6 = (_rand((n,), seed=4) for n in (4, 5, 6))
WT2 = _rand((3, 2, 3, 3), seed=5)       # [in, out / groups, kh, kw]
WT2G = _rand((4, 3, 3, 2), seed=5)      # groups 2: out 6
WT1 = _rand((4, 3, 4), seed=6)
WT3 = _rand((3, 2, 2, 3, 2), seed=7)

CONV_CASES = [
    ("conv2d_int_pair", "conv2d", [X4, W2, B4],
     dict(stride=2, padding=(1, 2))),
    ("conv2d_same_stride", "conv2d", [X4, W2, B4],
     dict(stride=2, padding="SAME")),
    ("conv2d_same_lower", "conv2d", [X4, W2],
     dict(stride=(3, 2), padding="same", dilation=(1, 2))),
    ("conv2d_valid", "conv2d", [X4, W2], dict(padding="VALID")),
    ("conv2d_per_side", "conv2d", [X4, W2, B4],
     dict(padding=[(1, 2), (0, 1)])),
    ("conv2d_nhwc_groups", "conv2d", [_nhwc(X4), W2G, B6],
     dict(padding=1, groups=3, data_format="NHWC")),
    ("conv2d_nhwc_same", "conv2d", [_nhwc(X4), W2],
     dict(stride=2, padding="SAME", data_format="NHWC")),
    ("conv1d", "conv1d", [X3, W1, B5], dict(stride=2, padding=1)),
    ("conv1d_same_nlc", "conv1d", [np.moveaxis(X3, 1, -1).copy(), W1, B5],
     dict(padding="SAME", dilation=2, data_format="NLC")),
    ("conv1d_pairs", "conv1d", [X3, W1], dict(padding=[(2, 0)])),
    ("conv3d", "conv3d", [X5, W3, B4], dict(stride=(1, 2, 1), padding=1)),
    ("conv3d_ndhwc_same", "conv3d", [np.moveaxis(X5, 1, -1).copy(), W3],
     dict(stride=2, padding="SAME", data_format="NDHWC")),
    ("conv2d_transpose", "conv2d_transpose", [X4, WT2, _rand((2,))],
     dict(stride=2, padding=1, output_padding=1)),
    ("conv2d_transpose_groups_dilation", "conv2d_transpose",
     [X4[:, :2].repeat(2, 1), WT2G, B6],
     dict(stride=(2, 1), padding=(0, 1), dilation=2, groups=2)),
    ("conv2d_transpose_nhwc", "conv2d_transpose", [_nhwc(X4), WT2],
     dict(stride=2, padding=1, data_format="NHWC")),
    ("conv1d_transpose", "conv1d_transpose", [X3, WT1, _rand((3,))],
     dict(stride=3, padding=1, output_padding=2)),
    ("conv1d_transpose_nlc", "conv1d_transpose",
     [np.moveaxis(X3, 1, -1).copy(), WT1],
     dict(stride=2, data_format="NLC")),
    ("conv3d_transpose", "conv3d_transpose", [X5, WT3, _rand((2,))],
     dict(stride=2, padding=(1, 0, 1))),
    ("conv3d_transpose_ndhwc", "conv3d_transpose",
     [np.moveaxis(X5, 1, -1).copy(), WT3],
     dict(stride=(1, 2, 1), data_format="NDHWC")),
]


@pytest.fixture(scope="module")
def conv_want():
    return _group(CONV_CASES)


@pytest.mark.parametrize("case", CONV_CASES, ids=[c[0] for c in CONV_CASES])
def test_convolutions_match_jax(case, conv_want):
    cid, name, arrays, kw = case
    torch_check(getattr(TF, name), arrays, kw, conv_want[cid])


def test_conv2d_resolves_nchw_to_nhwc_in_the_channels_last_scope():
    with jlayout.channels_last_scope(), tlayout.channels_last_scope():
        run(JF.conv2d, TF.conv2d, [_nhwc(X4), W2, B4],
            dict(stride=2, padding="SAME"))
        run(JF.conv2d_transpose, TF.conv2d_transpose, [_nhwc(X4), WT2],
            dict(stride=2, padding=1, output_padding=1))


NORM_CASES = [
    ("normalize_l2", "normalize", [X4], dict(axis=1)),
    ("normalize_l1", "normalize", [X3], dict(p=1, axis=-1)),
    ("normalize_inf", "normalize", [X3], dict(p=float("inf"), axis=2)),
    ("normalize_p3", "normalize", [X3], dict(p=3, axis=1)),
    ("lrn", "local_response_norm", [X4 * 3], dict(size=3)),
    ("lrn_even_3d", "local_response_norm", [X3 * 3],
     dict(size=4, alpha=1e-2, beta=0.5, k=2.0)),
    ("lrn_nhwc", "local_response_norm", [_nhwc(X4) * 3],
     dict(size=5, alpha=1e-2, data_format="NHWC")),
]


@pytest.fixture(scope="module")
def norm_want():
    return _group(NORM_CASES)


@pytest.mark.parametrize("case", NORM_CASES, ids=[c[0] for c in NORM_CASES])
def test_norm_functions_match_jax(case, norm_want):
    cid, name, arrays, kw = case
    torch_check(getattr(TF, name), arrays, kw, norm_want[cid])


X4S = _rand((2, 3, 5, 6), seed=8)
GRID = np.random.default_rng(9).uniform(-1.3, 1.3, (2, 4, 7, 2)).astype(
    np.float32)
COMMON_CASES = [
    ("pad_flat", "pad", [X4], dict(pad_width=[1, 2, 0, 3], value=0.5)),
    ("pad_pairs_reflect", "pad", [X4],
     dict(pad_width=[(0, 0), (0, 0), (2, 1), (3, 0)], mode="reflect")),
    ("pad_edge", "pad", [X3], dict(pad_width=[2, 3], mode="edge")),
    ("pad_wrap", "pad", [X3], dict(pad_width=[3, 12], mode="wrap")),
    ("pad_symmetric", "pad", [X3],
     dict(pad_width=[(0, 0), (1, 2), (4, 3)], mode="symmetric")),
    ("cosine_similarity", "cosine_similarity", [X4, _rand(X4.shape, 3)],
     dict(axis=1)),
    ("nearest_3d", "interpolate", [X3], dict(size=17)),
    ("linear_3d", "interpolate", [X3], dict(scale_factor=1.5, mode="linear")),
    ("linear_3d_align", "interpolate", [X3],
     dict(size=5, mode="linear", align_corners=True)),
    ("nearest_nwc", "interpolate", [np.moveaxis(X3, 1, -1).copy()],
     dict(size=7, data_format="NWC")),
    ("linear_nwc", "interpolate", [np.moveaxis(X3, 1, -1).copy()],
     dict(size=7, mode="linear", data_format="NWC")),
    ("bilinear", "interpolate", [X4S], dict(size=(8, 11), mode="bilinear")),
    ("bilinear_align", "interpolate", [X4S],
     dict(scale_factor=2, mode="bilinear", align_corners=True)),
    ("bilinear_mode1", "interpolate", [X4S],
     dict(size=(3, 9), mode="bilinear", align_mode=1)),
    ("bilinear_nhwc", "interpolate", [_nhwc(X4S)],
     dict(size=(7, 4), mode="bilinear", data_format="NHWC")),
    ("bicubic", "interpolate", [X4S], dict(size=(9, 13), mode="bicubic")),
    ("bicubic_align_down", "interpolate", [X4S],
     dict(size=(3, 4), mode="bicubic", align_corners=True)),
    ("area", "interpolate", [X4], dict(size=(4, 6), mode="area")),
    ("area_nhwc", "interpolate", [_nhwc(X4)],
     dict(size=(3, 5), mode="area", data_format="NHWC")),
    ("nearest_5d", "interpolate", [X5], dict(size=(4, 9, 5))),
    ("trilinear", "interpolate", [X5],
     dict(scale_factor=(1.5, 0.5, 2), mode="trilinear")),
    ("trilinear_ndhwc", "interpolate", [np.moveaxis(X5, 1, -1).copy()],
     dict(size=5, mode="trilinear", align_corners=True,
          data_format="NDHWC")),
    ("upsample", "upsample", [X4S], dict(scale_factor=2, mode="bilinear")),
    ("unfold", "unfold", [X4],
     dict(kernel_sizes=(3, 2), strides=(2, 1), paddings=1, dilations=(1, 2))),
    ("unfold_4pad", "unfold", [X4],
     dict(kernel_sizes=3, strides=2, paddings=(1, 0, 2, 1))),
    ("fold", "fold", [_rand((2, 3 * 6, 30), 4)],
     dict(output_sizes=(9, 10), kernel_sizes=(3, 2), strides=(2, 2),
          paddings=1)),
    ("fold_4pad", "fold", [_rand((2, 3 * 4, 20), 4)],
     dict(output_sizes=(7, 8), kernel_sizes=2, strides=(2, 2),
          paddings=(1, 0, 2, 1))),
    ("zeropad2d", "zeropad2d", [X4], dict(padding=[1, 0, 2, 3])),
    ("zeropad2d_nhwc", "zeropad2d", [_nhwc(X4)],
     dict(padding=[0, 2, 1, 1], data_format="NHWC")),
    ("bilinear_fn", "bilinear",
     [_rand((4, 3)), _rand((4, 5), 1), _rand((2, 3, 5), 2), _rand((2,), 3)],
     {}),
    ("pairwise_distance", "pairwise_distance", [X3, _rand(X3.shape, 5)], {}),
    ("pairwise_distance_p1", "pairwise_distance", [X3, _rand(X3.shape, 5)],
     dict(p=1.0, keepdim=True)),
    ("pairwise_distance_inf", "pairwise_distance", [X3, _rand(X3.shape, 5)],
     dict(p=float("inf"))),
    ("pairwise_distance_ninf", "pairwise_distance",
     [X3, _rand(X3.shape, 5)], dict(p=float("-inf"), keepdim=True)),
    ("sequence_mask", "sequence_mask", [np.array([[3, 0], [5, 2]])],
     dict(maxlen=6)),
    ("sequence_mask_bool", "sequence_mask", [np.array([1, 4, 2])],
     dict(dtype="bool")),
    ("temporal_shift", "temporal_shift", [_rand((6, 8, 3, 2))],
     dict(seg_num=3)),
    ("temporal_shift_nhwc", "temporal_shift", [_rand((4, 3, 2, 10))],
     dict(seg_num=2, shift_ratio=0.2, data_format="NHWC")),
    ("channel_shuffle", "channel_shuffle", [_rand((2, 6, 3, 2))],
     dict(groups=3)),
    ("channel_shuffle_nhwc", "channel_shuffle", [_rand((2, 3, 2, 8))],
     dict(groups=2, data_format="NHWC")),
    ("label_smooth", "label_smooth",
     [np.eye(5, dtype=np.float32)[[0, 3, 1]]], dict(epsilon=0.2)),
    ("label_smooth_prior", "label_smooth",
     [np.eye(4, dtype=np.float32)[[2, 1]], _rand((4,), 1)],
     dict(epsilon=0.3)),
    ("pixel_shuffle", "pixel_shuffle", [_rand((2, 8, 3, 2))],
     dict(upscale_factor=2)),
    ("pixel_shuffle_nhwc", "pixel_shuffle", [_rand((2, 3, 2, 18))],
     dict(upscale_factor=3, data_format="NHWC")),
    ("pixel_unshuffle", "pixel_unshuffle", [_rand((2, 3, 4, 6))],
     dict(downscale_factor=2)),
    ("pixel_unshuffle_nhwc", "pixel_unshuffle", [_rand((2, 6, 3, 2))],
     dict(downscale_factor=3, data_format="NHWC")),
    ("affine_grid", "affine_grid", [_rand((2, 2, 3))],
     dict(out_shape=(2, 3, 5, 4))),
    ("affine_grid_unaligned", "affine_grid", [_rand((2, 2, 3))],
     dict(out_shape=(2, 3, 4, 6), align_corners=False)),
] + [
    (f"grid_sample_{mode}_{pad}_{int(ac)}", "grid_sample", [X4S, GRID],
     dict(mode=mode, padding_mode=pad, align_corners=ac))
    for mode in ("bilinear", "nearest")
    for pad in ("zeros", "border", "reflection")
    for ac in (True, False)
]


@pytest.fixture(scope="module")
def common_want():
    return _group(COMMON_CASES, grad=lambda name: name != "sequence_mask")


@pytest.mark.parametrize("case", COMMON_CASES,
                         ids=[c[0] for c in COMMON_CASES])
def test_common_and_vision_functions_match_jax(case, common_want):
    cid, name, arrays, kw = case
    torch_check(getattr(TF, name), arrays, kw, common_want[cid])


def test_interpolate_nearest_nhwc_resolves_in_the_channels_last_scope():
    with jlayout.channels_last_scope(), tlayout.channels_last_scope():
        run(JF.interpolate, TF.interpolate, [_nhwc(X4S)],
            dict(size=(7, 4), mode="bilinear"))
        run(JF.interpolate, TF.interpolate, [_nhwc(X4S)],
            dict(scale_factor=2))


# ------------------------------------------------------------ random ones


DROPOUT_CASES = [
    ("dropout2d", (64, 32, 3, 3), {}),
    ("dropout2d", (64, 3, 3, 32), dict(data_format="NHWC")),
    ("dropout3d", (64, 32, 2, 2, 2), {}),
    ("dropout3d", (64, 2, 2, 2, 32), dict(data_format="NDHWC")),
]
DROPOUT_X = [np.abs(_rand(shape, 11)) + 0.1 for _, shape, _ in DROPOUT_CASES]
ALPHA_X = _rand((200, 500), 12)
ALPHA_LIMITS = (dict(p=0.2, training=False), dict(p=0.0), dict(p=1.0))
GUMBEL_LOGITS = np.array([1.0, 0.0, -1.0, 0.5], np.float32)


@pytest.fixture(scope="module")
def random_want():
    """The JAX random functions' deterministic limits and draws (keys from
    ``seed(3)``), in one jitted call."""
    def body():
        pt.seed(3)
        out = {}
        for i, ((name, _, kw), x) in enumerate(zip(DROPOUT_CASES,
                                                   DROPOUT_X)):
            f, x = getattr(JF, name), jnp.asarray(x)
            out[f"dropout{i}"] = (f(x, p=0.0, training=True, **kw),
                                  f(x, p=0.5, training=False, **kw),
                                  f(x, p=0.3, **kw))
        x = jnp.asarray(ALPHA_X)
        out["alpha"] = tuple(JF.alpha_dropout(x, **kw)
                             for kw in ALPHA_LIMITS + (dict(p=0.2),))
        out["gumbel"] = JF.gumbel_softmax(
            jnp.asarray(np.tile(GUMBEL_LOGITS, (4000, 1))), temperature=0.5)
        return out

    return jax.tree_util.tree_map(np.asarray, jit_o0(body))


@pytest.mark.parametrize("i", range(len(DROPOUT_CASES)), ids=[
    f"{n}_{kw.get('data_format', 'cf')}" for n, _, kw in DROPOUT_CASES])
def test_channel_dropouts_match_jax_limits_and_statistics(i, random_want):
    """p = 0 and not training give x on both sides; at p = 0.3 whole
    channels drop (every spatial value of a (sample, channel) pair alike)
    and the kept ones are x / 0.7; the kept fraction of each side is
    within 4 standard errors of 0.7."""
    name, shape, kw = DROPOUT_CASES[i]
    tfn, x = getattr(TF, name), DROPOUT_X[i]
    zero_p, no_train, want = random_want[f"dropout{i}"]
    close(tfn(torch.tensor(x), p=0.0, training=True, **kw), zero_p, 0)
    close(tfn(torch.tensor(x), p=0.5, training=False, **kw), no_train, 0)
    close(zero_p, x, 0)
    got = tfn(torch.tensor(x), p=0.3, generator=torch.Generator().manual_seed(
        3), **kw).numpy()
    n_ch = shape[0] * (shape[1] if "data_format" not in kw else shape[-1])
    se = (0.3 * 0.7 / n_ch) ** 0.5
    for y in (want, got):
        kept = y != 0
        np.testing.assert_allclose(y[kept], (x / 0.7)[kept], rtol=1e-6)
        axes = tuple(range(2, y.ndim)) if "data_format" not in kw \
            else tuple(range(1, y.ndim - 1))
        per_channel = kept.mean(axis=axes)
        assert set(np.unique(per_channel)) <= {0.0, 1.0}
        assert abs(per_channel.mean() - 0.7) < 4 * se


def test_alpha_dropout_matches_jax_limits_and_statistics(random_want):
    """Not training and p = 0 give x, p = 1 zeros; at p = 0.2 on SELU-
    normalised inputs both sides keep the mean near 0 and the variance
    near 1, and every value is a x + b or the saturation a alpha' + b."""
    x = ALPHA_X
    *limits, want = random_want["alpha"]
    for kw, w in zip(ALPHA_LIMITS, limits):
        close(TF.alpha_dropout(torch.tensor(x), **kw), w, 0)
    got = TF.alpha_dropout(torch.tensor(x), p=0.2,
                           generator=torch.Generator().manual_seed(5)).numpy()
    alpha_p, q = -1.7580993408473766, 0.8
    a = (q + alpha_p * alpha_p * 0.2 * q) ** -0.5
    b = -a * alpha_p * 0.2
    for y in (want, got):
        keep = np.isclose(y, a * x + b, atol=1e-5)
        drop = np.isclose(y, a * alpha_p + b, atol=1e-5)
        assert (keep | drop).all()
        assert abs(drop.mean() - 0.2) < 0.01
        assert abs(y.mean()) < 0.02 and abs(y.var() - 1.0) < 0.03


def test_gumbel_softmax_matches_jax_statistics(random_want):
    """Each row sums to 1 (hard: one-hot, with the soft gradients); the
    argmax frequencies of both sides over 4000 draws of the same logits
    are within 0.03 of softmax(logits)."""
    logits = GUMBEL_LOGITS
    tx = torch.tensor(np.tile(logits, (4000, 1)), requires_grad=True)
    got = TF.gumbel_softmax(tx, temperature=0.5,
                            generator=torch.Generator().manual_seed(7))
    probs = np.exp(logits) / np.exp(logits).sum()
    for y in (random_want["gumbel"], got.detach().numpy()):
        np.testing.assert_allclose(y.sum(-1), 1.0, rtol=1e-5)
        freq = np.bincount(y.argmax(-1), minlength=4) / len(y)
        np.testing.assert_allclose(freq, probs, atol=0.03)
    hard = TF.gumbel_softmax(tx, hard=True,
                             generator=torch.Generator().manual_seed(7))
    np.testing.assert_array_equal(np.sort(hard.detach().numpy(), -1)[:, -1],
                                  1.0)
    (hard[:, 0]).sum().backward()
    assert tx.grad.abs().sum() > 0


# ---------------------------------------------------------------- layers


def _carry(jlayer, tlayer):
    return load_numpy_state_dict(
        tlayer, {k: np.asarray(v) for k, v in jlayer.state_dict().items()})


def layer_side(jlayer, arrays, grad=True):
    """Traceable: the JAX layer's outputs through ``functional_call`` and,
    with ``grad``, the gradients of ``sum(first output * the seeded
    cotangent)`` by parameter name and by input."""
    from paddle_tpu.core.functional import extract_params, functional_call

    params = extract_params(jlayer)
    xs = [jnp.asarray(a) for a in arrays]
    outs = _outs(functional_call(jlayer, params, *xs))
    if not grad:
        return outs, (), {}
    ct = jnp.asarray(_rand(tuple(outs[0].shape), seed=98))

    def f(p, *v):
        return jnp.sum(_first(functional_call(jlayer, p, *v)) * ct)

    gp, *gx = jax.grad(f, argnums=tuple(range(len(xs) + 1)))(params, *xs)
    return outs, tuple(gx), gp


def layer_check(tlayer, arrays, want, tol=1e-5):
    """The port layer (weights carried across) on the same inputs against
    ``layer_side``'s outputs and gradients."""
    outs, gx, gp = want
    grad = bool(gx)
    tx = [torch.tensor(a, requires_grad=grad) for a in arrays]
    got = _outs(tlayer(*tx))
    for g, w in zip(got, outs):
        if g.dtype.is_floating_point:
            close(g, w, tol)
        else:
            np.testing.assert_array_equal(g.numpy(), w)
    if not grad:
        return
    ct = torch.tensor(_rand(tuple(got[0].shape), seed=98))
    (got[0] * ct).sum().backward()
    for t, w in zip(tx, gx):
        scaled_close(t.grad, w)
    assert set(dict(tlayer.named_parameters())) == set(gp)
    for name, p in tlayer.named_parameters():
        scaled_close(p.grad, gp[name])


def layer_group(pairs, grad=lambda name: True):
    """``{id: (jax layer, port layer, arrays)}``: weights carried across,
    every ``layer_side`` in one jitted call."""
    for jl, tl, _ in pairs.values():
        _carry(jl, tl)

    def body():
        return {k: layer_side(jl, arrays, grad(k))
                for k, (jl, _, arrays) in pairs.items()}

    return jax.tree_util.tree_map(np.asarray, jit_o0(body))


def _conv_layer(cls, *a, **kw):
    """The port layer drawn from seed 1 and the JAX layer built under
    JAX's meta init (no initializer runs: each would compile) with the
    port's weights."""
    from paddle_tpu.core.meta import meta_init

    tl = getattr(tnn, cls)(*a, **kw, device="cpu",
                           generator=torch.Generator().manual_seed(1))
    with meta_init():
        jl = getattr(jnn, cls)(*a, **kw)
    jl.set_state_dict({k: v.numpy() for k, v in tl.state_dict().items()})
    return jl, tl


LAYER_CASES = {
    "Conv2D": lambda: (*_conv_layer("Conv2D", 3, 4, (3, 2), stride=2,
                                    padding="SAME"), [X4]),
    "Conv2D_nobias_nhwc": lambda: (*_conv_layer(
        "Conv2D", 3, 6, 3, padding=1, groups=3, bias_attr=False,
        data_format="NHWC"), [_nhwc(X4)]),
    "Conv1D": lambda: (*_conv_layer("Conv1D", 4, 5, 3, padding=[(1, 2)]),
                       [X3]),
    "Conv1D_nlc": lambda: (*_conv_layer("Conv1D", 4, 5, 3, stride=2,
                                        data_format="NLC"),
                           [np.moveaxis(X3, 1, -1).copy()]),
    "Conv3D": lambda: (*_conv_layer("Conv3D", 3, 2, 2, stride=2), [X5]),
    "Conv3D_ndhwc": lambda: (*_conv_layer("Conv3D", 3, 2, 3, padding=1,
                                          data_format="NDHWC"),
                             [np.moveaxis(X5, 1, -1).copy()]),
    "Conv2DTranspose": lambda: (*_conv_layer(
        "Conv2DTranspose", 3, 4, 3, stride=2, padding=1, output_padding=1),
        [X4]),
    "Conv2DTranspose_nhwc": lambda: (*_conv_layer(
        "Conv2DTranspose", 3, 6, 2, stride=2, groups=3, data_format="NHWC"),
        [_nhwc(X4)]),
    "Conv1DTranspose": lambda: (*_conv_layer("Conv1DTranspose", 4, 2, 3,
                                             stride=2), [X3]),
    "Conv3DTranspose": lambda: (*_conv_layer(
        "Conv3DTranspose", 3, 2, 2, stride=2, bias_attr=False), [X5]),
    "MaxPool2D": lambda: (jnn.MaxPool2D(3, 2, 1), tnn.MaxPool2D(3, 2, 1),
                          [X4]),
    "AvgPool2D_nhwc": lambda: (jnn.AvgPool2D(2, data_format="NHWC"),
                               tnn.AvgPool2D(2, data_format="NHWC"),
                               [_nhwc(X4)]),
    "AdaptiveAvgPool2D": lambda: (jnn.AdaptiveAvgPool2D((4, 3)),
                                  tnn.AdaptiveAvgPool2D((4, 3)), [X4]),
    "MaxPool1D": lambda: (jnn.MaxPool1D(3, 2, 1), tnn.MaxPool1D(3, 2, 1),
                          [X3]),
    "AvgPool1D": lambda: (jnn.AvgPool1D(4, 3, 2), tnn.AvgPool1D(4, 3, 2),
                          [X3]),
    "MaxPool3D": lambda: (jnn.MaxPool3D(2), tnn.MaxPool3D(2), [X5]),
    "AvgPool3D_ndhwc": lambda: (
        jnn.AvgPool3D(3, 2, 1, data_format="NDHWC"),
        tnn.AvgPool3D(3, 2, 1, data_format="NDHWC"),
        [np.moveaxis(X5, 1, -1).copy()]),
    "AdaptiveAvgPool1D": lambda: (jnn.AdaptiveAvgPool1D(4),
                                  tnn.AdaptiveAvgPool1D(4), [X3]),
    "AdaptiveAvgPool3D": lambda: (jnn.AdaptiveAvgPool3D((4, 3, 5)),
                                  tnn.AdaptiveAvgPool3D((4, 3, 5)), [X5]),
    "AdaptiveMaxPool2D_mask": lambda: (
        jnn.AdaptiveMaxPool2D(4, return_mask=True),
        tnn.AdaptiveMaxPool2D(4, return_mask=True), [X4]),
    "AdaptiveMaxPool2D_nhwc": lambda: (
        jnn.AdaptiveMaxPool2D((3, 5), data_format="NHWC"),
        tnn.AdaptiveMaxPool2D((3, 5), data_format="NHWC"), [_nhwc(X4)]),
    "LocalResponseNorm": lambda: (jnn.LocalResponseNorm(3, alpha=1e-2),
                                  tnn.LocalResponseNorm(3, alpha=1e-2),
                                  [X4 * 2]),
    "InstanceNorm2D": lambda: (jnn.InstanceNorm2D(3),
                               tnn.InstanceNorm2D(3, device="cpu"), [X4]),
    "InstanceNorm2D_nhwc_noaffine": lambda: (
        jnn.InstanceNorm2D(3, weight_attr=False, bias_attr=False,
                           data_format="NHWC"),
        tnn.InstanceNorm2D(3, weight_attr=False, bias_attr=False,
                           data_format="NHWC", device="cpu"), [_nhwc(X4)]),
    "Bilinear": lambda: (*_conv_layer("Bilinear", 3, 5, 2),
                         [_rand((4, 3)), _rand((4, 5), 1)]),
    "PixelShuffle": lambda: (jnn.PixelShuffle(2), tnn.PixelShuffle(2),
                             [_rand((2, 8, 3, 2))]),
    "PixelUnshuffle_nhwc": lambda: (
        jnn.PixelUnshuffle(2, "NHWC"), tnn.PixelUnshuffle(2, "NHWC"),
        [_rand((2, 4, 6, 3))]),
    "Pad2D_reflect": lambda: (jnn.Pad2D([1, 2, 2, 0], mode="reflect"),
                              tnn.Pad2D([1, 2, 2, 0], mode="reflect"), [X4]),
    "Pad2D_nhwc_constant": lambda: (
        jnn.Pad2D(1, value=2.0, data_format="NHWC"),
        tnn.Pad2D(1, value=2.0, data_format="NHWC"), [_nhwc(X4)]),
    "Pad1D_replicate": lambda: (jnn.Pad1D([2, 1], mode="replicate"),
                                tnn.Pad1D([2, 1], mode="replicate"), [X3]),
    "Pad1D_nlc": lambda: (jnn.Pad1D(2, data_format="NLC"),
                          tnn.Pad1D(2, data_format="NLC"),
                          [np.moveaxis(X3, 1, -1).copy()]),
    "Pad3D_circular": lambda: (
        jnn.Pad3D([1, 0, 2, 1, 0, 2], mode="circular"),
        tnn.Pad3D([1, 0, 2, 1, 0, 2], mode="circular"), [X5]),
    "Pad3D_ndhwc": lambda: (
        jnn.Pad3D(1, mode="reflect", data_format="NDHWC"),
        tnn.Pad3D(1, mode="reflect", data_format="NDHWC"),
        [np.moveaxis(X5, 1, -1).copy()]),
    "ZeroPad2D": lambda: (jnn.ZeroPad2D([2, 1, 0, 3]),
                          tnn.ZeroPad2D([2, 1, 0, 3]), [X4]),
    "CosineSimilarity": lambda: (jnn.CosineSimilarity(1),
                                 tnn.CosineSimilarity(1),
                                 [X4, _rand(X4.shape, 6)]),
    "PairwiseDistance": lambda: (jnn.PairwiseDistance(3.0, keepdim=True),
                                 tnn.PairwiseDistance(3.0, keepdim=True),
                                 [X3, _rand(X3.shape, 6)]),
    "Unflatten": lambda: (jnn.Unflatten(-1, (2, 5)),
                          tnn.Unflatten(-1, (2, 5)), [X4]),
    "Upsample_bicubic": lambda: (
        jnn.Upsample((7, 8), mode="bicubic", align_corners=True),
        tnn.Upsample((7, 8), mode="bicubic", align_corners=True), [X4S]),
    "Upsample_trilinear": lambda: (
        jnn.Upsample(scale_factor=2, mode="trilinear"),
        tnn.Upsample(scale_factor=2, mode="trilinear"), [X5]),
    "UpsamplingNearest2D": lambda: (jnn.UpsamplingNearest2D(scale_factor=2),
                                    tnn.UpsamplingNearest2D(scale_factor=2),
                                    [X4S]),
    "UpsamplingBilinear2D_nhwc": lambda: (
        jnn.UpsamplingBilinear2D((9, 4), data_format="NHWC"),
        tnn.UpsamplingBilinear2D((9, 4), data_format="NHWC"), [_nhwc(X4S)]),
    "Unfold": lambda: (jnn.Unfold(3, 2, 1), tnn.Unfold(3, 2, 1), [X4]),
    "Fold": lambda: (jnn.Fold((9, 10), 3, 2, 1), tnn.Fold((9, 10), 3, 2, 1),
                     [_rand((2, 27, 25), 7)]),
}


@pytest.fixture(scope="module")
def layers():
    pairs = {name: make() for name, make in LAYER_CASES.items()}
    return pairs, layer_group(pairs, lambda n: not n.endswith("_mask"))


@pytest.mark.parametrize("name", sorted(LAYER_CASES))
def test_layers_match_jax(name, layers):
    pairs, want = layers
    _, tlayer, arrays = pairs[name]
    layer_check(tlayer, arrays, want[name])


@pytest.mark.parametrize("cls", ["Dropout2D", "Dropout3D", "AlphaDropout"])
def test_random_layers_are_the_identity_out_of_training(cls):
    """In eval mode, and at p = 0 in training, both packages' layers give
    x; the port's training forward draws from the ``generator`` given."""
    x = _rand((4, 3, 2, 2, 2) if cls == "Dropout3D" else (4, 3, 2, 2))
    for p, train in ((0.5, False), (0.0, True)):
        jl, tl = getattr(jnn, cls)(p), getattr(tnn, cls)(p)
        if not train:
            jl.eval()
            tl.eval()
        close(tl(torch.tensor(x)), jl(jnp.asarray(x)), 0)
    tl = getattr(tnn, cls)(0.5)
    y1 = tl(torch.tensor(x), generator=torch.Generator().manual_seed(1))
    y2 = tl(torch.tensor(x), generator=torch.Generator().manual_seed(1))
    assert torch.equal(y1, y2) and not torch.equal(y1, torch.tensor(x))


def test_spectral_norm_matches_jax_and_keeps_its_vectors():
    """Two power iterations a call from the JAX layer's own u and v
    (carried across): the normalised weight and its gradient (through
    the iteration, as JAX differentiates it), then the buffers after an
    eager call, equal JAX's."""
    from paddle_tpu.core.functional import extract_params, functional_call

    pt.seed(2)
    w = _rand((6, 3, 2, 2), 4)
    jl = jnn.SpectralNorm(w.shape, dim=1, power_iters=2)
    tl = tnn.SpectralNorm(w.shape, dim=1, power_iters=2, device="cpu")
    _carry(jl, tl)
    ct = jnp.asarray(_rand(w.shape, 98))

    def fwd_vjp(v):
        y, vjp = jax.vjp(
            lambda u: functional_call(jl, extract_params(jl), u), v)
        return y, vjp(ct)[0]

    # traced: the JAX layer keeps its vectors, as before the call
    want, want_grad = jit_o0(fwd_vjp, jnp.asarray(w))
    tw = torch.tensor(w, requires_grad=True)
    got = tl(tw)
    close(got, want)
    (got * torch.tensor(np.asarray(ct))).sum().backward()
    scaled_close(tw.grad, want_grad)
    _carry(jl, tl)
    jl(jnp.asarray(w))
    tl(torch.tensor(w))
    for k in ("weight_u", "weight_v"):
        close(getattr(tl, k), jl.state_dict()[k], 1e-6)


# ---------------------------------------------------------- BatchNorm


def _bn_pair(cls, c, **kw):
    pt.seed(0)
    jl = getattr(jnn, cls)(c, **kw)
    tl = getattr(tnn, cls)(c, device="cpu", **kw)
    # non-trivial affine and running statistics, carried across
    state = {k: np.asarray(v) for k, v in jl.state_dict().items()}
    rng = np.random.default_rng(5)
    state["weight"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
    state["bias"] = rng.standard_normal(c).astype(np.float32)
    state["_mean"] = rng.standard_normal(c).astype(np.float32)
    state["_variance"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
    jl.set_state_dict(state)
    load_numpy_state_dict(tl, state)
    return jl, tl


BN_CASES = [
    ("BatchNorm2D", dict(), X4),
    ("BatchNorm2D", dict(data_format="NHWC"), _nhwc(X4)),
    ("BatchNorm", dict(momentum=0.8), X4),
    ("SyncBatchNorm", dict(epsilon=1e-3), X4),
    ("BatchNorm1D", dict(), _rand((6, 3), 3)),
    ("BatchNorm1D", dict(), X3[:, :3]),
    ("BatchNorm1D", dict(data_format="NLC"), np.moveaxis(X3[:, :3], 1, -1)),
    ("BatchNorm3D", dict(), X5),
    ("BatchNorm3D", dict(data_format="NDHWC"), np.moveaxis(X5, 1, -1)),
]


BN_IDS = [f"{c[0]}_{c[1].get('data_format', 'cf')}_{c[2].ndim}d"
          for c in BN_CASES]


@pytest.fixture(scope="module")
def bn_want():
    """Every BatchNorm case in training and eval mode in one jitted call,
    and BatchNorm2D declared NCHW on NHWC input traced inside the
    channels-last scope."""
    pairs = {}
    for cid, (cls, kw, x) in zip(BN_IDS, BN_CASES):
        for training in (True, False):
            jl, tl = _bn_pair(cls, 3, **kw)
            if not training:
                jl.eval()
                tl.eval()
            pairs[f"{cid}-{training}"] = (jl, tl, [np.ascontiguousarray(x)])
    want = layer_group(pairs)
    jl, tl = _bn_pair("BatchNorm2D", 3)
    pairs["scope"] = (jl, tl, [_nhwc(X4)])
    with jlayout.channels_last_scope():
        want.update(layer_group({"scope": pairs["scope"]}))
    return pairs, want


@pytest.mark.parametrize("cid", BN_IDS)
@pytest.mark.parametrize("training", [True, False])
def test_batch_norms_match_jax_and_move_their_buffers_as_eager_jax(
        cid, training, bn_want):
    """Outputs and every gradient (training: batch statistics; eval: the
    running ones) against the jitted JAX layer; then one forward of a
    fresh pair: in training the running statistics move and equal the
    eager JAX layer's; in eval they stay as they were."""
    pairs, want = bn_want
    _, tl, arrays = pairs[f"{cid}-{training}"]
    layer_check(tl, arrays, want[f"{cid}-{training}"])
    cls, kw, _ = BN_CASES[BN_IDS.index(cid)]
    jl, tl = _bn_pair(cls, 3, **kw)
    before = {k: getattr(tl, k).clone() for k in ("_mean", "_variance")}
    if training:
        jl(jnp.asarray(arrays[0]))
    else:
        # an eval forward writes no buffer in either package
        tl.eval()
    tl(torch.tensor(arrays[0]))
    for k in ("_mean", "_variance"):
        close(getattr(tl, k), jl.state_dict()[k], 1e-6)
        assert training != torch.equal(getattr(tl, k), before[k])


def test_batch_norm_resolves_in_the_channels_last_scope(bn_want):
    pairs, want = bn_want
    _, tl, arrays = pairs["scope"]
    with tlayout.channels_last_scope():
        layer_check(tl, arrays, want["scope"])
    jl, tl = _bn_pair("BatchNorm2D", 3)
    with jlayout.channels_last_scope(), tlayout.channels_last_scope():
        jl(jnp.asarray(arrays[0]))
        tl(torch.tensor(arrays[0]))
    close(tl._mean, jl.state_dict()["_mean"], 1e-6)


def test_batch_norm_bf16_buffers_follow_jax_layer_to():
    """``Layer.to(bfloat16)`` casts the float32 running statistics to
    bf16 in both packages. A training forward then differs in the
    buffers' dtype: the JAX update (``0.9 * buffer + 0.1 * batch``, the
    weak-typed 0.9 rounded to bf16 against the bf16 buffer, then
    promoted by the float32 batch statistic) leaves float32 buffers; the
    port computes the same update in float32 with 0.9 and rounds it once
    into its bf16 buffers."""
    jl, tl = _bn_pair("BatchNorm2D", 3)
    jl.to(pt.bfloat16)
    tl.to("bfloat16")
    before = {}
    for k in ("_mean", "_variance"):
        assert jl.state_dict()[k].dtype == jnp.bfloat16
        assert getattr(tl, k).dtype == torch.bfloat16
        close(getattr(tl, k), jl.state_dict()[k], 0)
        before[k] = getattr(tl, k).float()
    xb = torch.tensor(X4).to(torch.bfloat16)
    jy = jl(jnp.asarray(X4, jnp.bfloat16))
    ty = tl(xb)
    assert ty.dtype == torch.bfloat16 and jy.dtype == jnp.bfloat16
    close(ty, jy, 2e-2)
    xf = xb.float()
    batch = {"_mean": xf.mean(dim=(0, 2, 3)),
             "_variance": xf.var(dim=(0, 2, 3), unbiased=False)}
    m_bf16 = torch.tensor(0.9).to(torch.bfloat16)
    for k in ("_mean", "_variance"):
        port = (0.9 * before[k] + 0.1 * batch[k]).to(torch.bfloat16)
        assert torch.equal(getattr(tl, k), port)
        assert jl.state_dict()[k].dtype == jnp.float32
        jax_rule = (m_bf16 * before[k].to(torch.bfloat16)).float() \
            + 0.1 * batch[k]
        close(jl.state_dict()[k], jax_rule, 1e-6)


def test_convert_sync_batchnorm_swaps_the_class_in_place():
    model = tnn.Sequential(tnn.Conv2D(3, 4, 1, device="cpu"),
                           tnn.BatchNorm2D(4, device="cpu"),
                           tnn.Sequential(tnn.BatchNorm2D(4, device="cpu")))
    out = tnn.SyncBatchNorm.convert_sync_batchnorm(model)
    assert out is model
    assert type(model[1]) is tnn.SyncBatchNorm
    assert type(model[2][0]) is tnn.SyncBatchNorm
    x = torch.tensor(X4)
    close(model(x), model[2][0](model[1](model[0](x))), 0)


def test_conv2d_takes_the_jax_weight_and_bias_attrs():
    from paddle_tpu_torch.core import initializer as TI

    layer = tnn.Conv2D(3, 4, 3, weight_attr=TI.Constant(0.5),
                       bias_attr=False, device="cpu")
    assert layer.bias is None
    assert torch.equal(layer.weight, torch.full((4, 3, 3, 3), 0.5))
    layer = tnn.Conv2D(3, 4, 3, bias_attr=tnn.ParamAttr(
        initializer=TI.Constant(1.0)), device="cpu")
    assert torch.equal(layer.bias, torch.ones(4))
    assert as_np(layer.weight).std() > 0
