"""``paddle_tpu_torch.vision.ops`` against ``paddle_tpu.vision.ops`` on
the same float32 inputs (``tests/test_vision_ops.py``'s and
``test_vision_dist_tail.py``'s cases on both packages): ``nms`` (plain,
per category, ``top_k``) gives the same indices; ``roi_align`` (adaptive
and fixed ratios, aligned or not, RoIs over two images), ``roi_pool``,
``psroi_pool``, ``box_coder`` both ways, ``prior_box``,
``deform_conv2d`` (v1, v2 with a mask, groups and deformable groups,
taps outside the map) and ``matrix_nms`` agree at 1e-5; the gradients of
``roi_align`` and ``deform_conv2d`` against ``jax.grad`` at 1e-4."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.vision import ops as jo
from paddle_tpu_torch.vision import ops as to
from torch_parity import jit_o0

RNG = np.random.default_rng(0)


def near(got, want, tol=1e-5):
    g = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    w = np.asarray(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    scale = max(float(np.abs(w).max(initial=0.0)), 1.0)
    np.testing.assert_allclose(g, w, rtol=0, atol=tol * scale)


def _boxes(n, size=32.0):
    xy = RNG.random((n, 2)) * size
    wh = RNG.random((n, 2)) * size / 2 + 1
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def test_nms_matches_jax():
    boxes = _boxes(60)
    scores = RNG.random(60).astype(np.float32)
    cats = RNG.integers(0, 3, 60)
    for kw in (dict(iou_threshold=0.3, scores=scores),
               dict(iou_threshold=0.5),
               dict(iou_threshold=0.4, scores=scores, category_idxs=cats,
                    top_k=7)):
        tkw = {k: torch.tensor(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()}
        jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()}
        got = to.nms(torch.tensor(boxes), **tkw)
        assert got.dtype == torch.int64
        assert np.array_equal(got.numpy(),
                              np.asarray(jo.nms(jnp.asarray(boxes), **jkw)))


X = RNG.standard_normal((2, 3, 12, 14)).astype(np.float32)
ROIS = np.array([[1.0, 2.0, 9.5, 11.0], [0.0, 0.0, 13.0, 11.0],
                 [4.2, 3.1, 6.0, 5.5], [2.0, 1.0, 30.0, 20.0]], np.float32)
NUM = np.array([3, 1])


@pytest.mark.parametrize("kw", [dict(output_size=3),
                                dict(output_size=(2, 4), sampling_ratio=2,
                                     aligned=False, spatial_scale=0.5)],
                         ids=["adaptive", "ratio2-unaligned"])
def test_roi_align_matches_jax(kw):
    near(to.roi_align(torch.tensor(X), torch.tensor(ROIS), NUM, **kw),
         jo.roi_align(jnp.asarray(X), jnp.asarray(ROIS), NUM, **kw))


def test_roi_pools_boxes_and_priors_match_jax():
    near(to.roi_pool(torch.tensor(X), torch.tensor(ROIS), NUM, 3),
         jo.roi_pool(jnp.asarray(X), jnp.asarray(ROIS), NUM, 3))
    near(to.roi_pool(torch.tensor(X), torch.tensor(ROIS), NUM, (2, 3), 0.5),
         jo.roi_pool(jnp.asarray(X), jnp.asarray(ROIS), NUM, (2, 3), 0.5))
    ps = RNG.standard_normal((2, 2 * 2 * 3, 12, 14)).astype(np.float32)
    near(to.psroi_pool(torch.tensor(ps), torch.tensor(ROIS), NUM, (2, 3)),
         jo.psroi_pool(jnp.asarray(ps), jnp.asarray(ROIS), NUM, (2, 3)))
    prior = _boxes(5) / 32
    var = np.array([0.1, 0.1, 0.2, 0.2], np.float32)
    target = _boxes(5) / 32
    for norm in (True, False):
        enc = to.box_coder(prior, var, target, box_normalized=norm)
        near(enc, jo.box_coder(prior, var, target, box_normalized=norm))
        near(to.box_coder(prior, var, enc, "decode_center_size", norm),
             jo.box_coder(prior, var, np.asarray(enc),
                          "decode_center_size", norm))
    near(to.box_coder(prior, None, target),
         jo.box_coder(prior, None, target))
    feat, img = torch.zeros(1, 8, 4, 5), torch.zeros(1, 3, 32, 40)
    for kw in (dict(min_sizes=[8.0]),
               dict(min_sizes=[8.0, 16.0], max_sizes=[16.0, 24.0],
                    aspect_ratios=[2.0], flip=True, clip=True)):
        for got, want in zip(to.prior_box(feat, img, **kw),
                             jo.prior_box(jnp.zeros((1, 8, 4, 5)),
                                          jnp.zeros((1, 3, 32, 40)), **kw)):
            near(got, want)


def _deform_inputs(n=2, cin=4, cout=6, hw=(7, 8), k=3, dg=2, groups=2):
    x = RNG.standard_normal((n, cin) + hw).astype(np.float32)
    w = RNG.standard_normal((cout, cin // groups, k, k)).astype(np.float32)
    off = (RNG.standard_normal((n, 2 * dg * k * k) + hw) * 2).astype(
        np.float32)
    off[0, 0, 0, 0] = -40.0  # a tap far outside the map
    mask = RNG.random((n, dg * k * k) + hw).astype(np.float32)
    b = RNG.standard_normal(cout).astype(np.float32)
    return x, off, w, b, mask


def test_deform_conv2d_and_gradients_match_jax():
    """v1 and v2 (a mask) with groups and deformable groups, a strided
    dilated case, and the gradients of x, offset and weight (and of
    roi_align's input) against ``jax.grad``; the JAX convolutions in one
    jitted program (roi_align's adaptive ratio reads the boxes on the
    host, so it runs eagerly)."""
    x, off, w, b, mask = _deform_inputs()
    kw = dict(padding=1, deformable_groups=2, groups=2)
    x1, off1, w1, _, _ = _deform_inputs(n=1, cin=3, cout=4, hw=(9, 9), dg=1,
                                        groups=1)
    off1 = off1[:, :, :3, :3].copy()  # the 3 x 3 output of stride 2

    def jax_side(a, o, ww, m, a1, o1, w1_):
        def loss(a, o, ww):
            return jnp.sum(jo.deform_conv2d(a, o, ww, jnp.asarray(b),
                                            mask=m, **kw) ** 2)

        return (jo.deform_conv2d(a, o, ww, jnp.asarray(b), **kw),
                jo.deform_conv2d(a, o, ww, jnp.asarray(b), mask=m, **kw),
                jo.deform_conv2d(a1, o1, w1_, stride=2, dilation=2),
                jax.grad(loss, argnums=(0, 1, 2))(a, o, ww))

    v1, v2, strided, grads = jit_o0(
        jax_side, *(jnp.asarray(a) for a in (x, off, w, mask, x1, off1, w1)))
    jgx = jax.grad(lambda f: jnp.sum(jo.roi_align(
        f, jnp.asarray(ROIS), NUM, 3) ** 2))(jnp.asarray(X))
    for masked, want in ((False, v1), (True, v2)):
        near(to.deform_conv2d(torch.tensor(x), torch.tensor(off),
                              torch.tensor(w), torch.tensor(b),
                              mask=torch.tensor(mask) if masked else None,
                              **kw), want)
    near(to.deform_conv2d(torch.tensor(x1), torch.tensor(off1),
                          torch.tensor(w1), stride=2, dilation=2), strided)
    tx, toff, tw = (torch.tensor(a, requires_grad=True) for a in (x, off, w))
    to.deform_conv2d(tx, toff, tw, torch.tensor(b),
                     mask=torch.tensor(mask), **kw).square().sum().backward()
    for t, j in zip((tx, toff, tw), grads):
        near(t.grad, j, 1e-4)
    tx = torch.tensor(X, requires_grad=True)
    to.roi_align(tx, torch.tensor(ROIS), NUM, 3).square().sum().backward()
    near(tx.grad, jgx, 1e-4)


@pytest.mark.parametrize("kw", [dict(), dict(use_gaussian=True, nms_top_k=6,
                                              keep_top_k=4,
                                              post_threshold=0.2)],
                         ids=["linear", "gaussian-top_k"])
def test_matrix_nms_matches_jax(kw):
    boxes = _boxes(12)
    scores = RNG.random(12).astype(np.float32)
    s, keep = to.matrix_nms(torch.tensor(boxes), torch.tensor(scores), **kw)
    js, jkeep = jo.matrix_nms(jnp.asarray(boxes), jnp.asarray(scores), **kw)
    near(s, js)
    assert np.array_equal(keep.numpy(), np.asarray(jkeep))
