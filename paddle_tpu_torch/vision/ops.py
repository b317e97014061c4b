"""Detection ops (counterpart of ``paddle_tpu/vision/ops.py``; parity:
``paddle.vision.ops``): ``nms``, ``roi_align``, ``roi_pool``,
``psroi_pool``, ``box_coder``, ``prior_box``, ``deform_conv2d`` and
``matrix_nms``, as plain torch (the JAX package has no Pallas kernel
here). Each computes on its inputs' device.

- ``nms``: the IoU matrix on the device, the greedy pass over its
  suppression rows on the host (the JAX op also compacts on the host).
- ``roi_align``: every RoI's bins sample a ``R x R`` grid (``R`` the
  batch's largest adaptive ratio, masked per RoI, as in JAX), read with
  one batched bilinear gather from the RoI's own image, never a copy of
  the image per RoI.
- ``deform_conv2d``: the k x k taps at their offset positions, read with
  one gather per deformable group over a zero ring (taps outside read
  zero), then one einsum over taps and input channels.
"""

from __future__ import annotations

import numpy as np
import torch


def _t(x, like=None, dtype=None):
    if isinstance(x, torch.Tensor):
        return x if dtype is None else x.to(dtype)
    dev = like.device if isinstance(like, torch.Tensor) else None
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)


# ---------------------------------------------------------------------------
# IoU and NMS
# ---------------------------------------------------------------------------
def _box_iou_matrix(a, b):
    """IoU [A, B] of [x1, y1, x2, y2] boxes."""
    area_a = (a[:, 2] - a[:, 0]).clamp(min=0) * (a[:, 3] - a[:, 1]).clamp(
        min=0)
    area_b = (b[:, 2] - b[:, 0]).clamp(min=0) * (b[:, 3] - b[:, 1]).clamp(
        min=0)
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / union.clamp(min=1e-10)


def _greedy_keep(suppress: np.ndarray) -> np.ndarray:
    """The greedy pass over score-sorted boxes: box i, if kept, drops every
    later box its row marks."""
    n = suppress.shape[0]
    keep = np.ones(n, bool)
    for i in range(n):
        if keep[i]:
            keep[i + 1:] &= ~suppress[i, i + 1:]
    return keep


def nms(boxes, iou_threshold=0.3, scores=None, category_idxs=None,
        categories=None, top_k=None):
    """Indices into ``boxes`` of the kept boxes, by descending score
    (int64, on the boxes' device)."""
    boxes = _t(boxes)
    n = boxes.shape[0]
    if scores is None:
        scores = torch.arange(n, 0, -1, dtype=torch.float32,
                              device=boxes.device)
    scores = _t(scores, boxes)
    if category_idxs is not None:
        # per-category NMS: shift each category by the whole coordinate
        # span, so the categories never overlap (JAX's trick)
        span = boxes.max() - boxes.min() + 1.0
        offs = _t(category_idxs, boxes).to(boxes.dtype) * span
        boxes = boxes + offs[:, None]
    order = torch.argsort(-scores, stable=True)
    sup = (_box_iou_matrix(boxes[order], boxes[order]) > iou_threshold)
    keep = _greedy_keep(sup.cpu().numpy())
    kept = order.cpu().numpy()[keep]
    if top_k is not None:
        kept = kept[:top_k]
    return torch.as_tensor(kept, dtype=torch.int64, device=boxes.device)


# ---------------------------------------------------------------------------
# RoI align / pool
# ---------------------------------------------------------------------------
def _bilerp_nhwc(xt, n_idx, y, x):
    """xt [N, H, W, C]; n_idx, y, x broadcastable index grids (y, x float
    and already clamped to the map) -> [*grid, C], the four-tap bilinear
    read of ``nn.functional._bilerp``."""
    H, W = xt.shape[1], xt.shape[2]
    y0f, x0f = torch.floor(y), torch.floor(x)
    y0, x0 = y0f.long(), x0f.long()
    y1 = (y0 + 1).clamp(max=H - 1)
    x1 = (x0 + 1).clamp(max=W - 1)
    wy1 = (y - y0f)[..., None]
    wx1 = (x - x0f)[..., None]
    return (xt[n_idx, y0, x0] * ((1 - wy1) * (1 - wx1))
            + xt[n_idx, y0, x1] * ((1 - wy1) * wx1)
            + xt[n_idx, y1, x0] * (wy1 * (1 - wx1))
            + xt[n_idx, y1, x1] * (wy1 * wx1))


def _image_index(boxes_num, device):
    counts = _t(boxes_num).reshape(-1).cpu().long()
    return torch.repeat_interleave(torch.arange(len(counts)),
                                   counts).to(device)


def roi_align(x, boxes, boxes_num, output_size, spatial_scale=1.0,
              sampling_ratio=-1, aligned=True):
    """x [N, C, H, W]; boxes [K, 4] in image coordinates, image-major;
    boxes_num [N] RoIs per image -> [K, C, ph, pw]. ``sampling_ratio``
    -1 takes each RoI's own ``ceil(roi / output)`` (at most 16), the
    grid sized to the batch's largest and the rest masked, as in JAX."""
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    ph, pw = output_size
    x = _t(x)
    boxes = _t(boxes, x, torch.float32)
    H, W = x.shape[-2:]
    adaptive = sampling_ratio <= 0
    if not adaptive:
        R = int(sampling_ratio)
    else:
        bnp = boxes.detach().cpu().numpy()
        sizes = np.maximum(bnp[:, 2:] - bnp[:, :2], 1.0) * spatial_scale
        R = int(min(16, max(1, np.ceil(sizes[:, 1].max() / ph),
                            np.ceil(sizes[:, 0].max() / pw))))
    off = 0.5 if aligned else 0.0
    b = boxes * spatial_scale - off
    x1, y1, x2, y2 = b.unbind(-1)
    rw = (x2 - x1).clamp(min=1e-4 if aligned else 1.0)
    rh = (y2 - y1).clamp(min=1e-4 if aligned else 1.0)
    bin_h, bin_w = rh / ph, rw / pw
    if adaptive:
        ry = torch.ceil(rh / ph).clamp(1, R)
        rx = torch.ceil(rw / pw).clamp(1, R)
    else:
        ry = rx = torch.full_like(rh, float(R))
    j = torch.arange(R, dtype=torch.float32, device=x.device)
    py = torch.arange(ph, dtype=torch.float32, device=x.device)
    px = torch.arange(pw, dtype=torch.float32, device=x.device)
    # sample positions [K, ph, R] and [K, pw, R]
    iy = (py[None, :, None] * bin_h[:, None, None] + y1[:, None, None]
          + (j[None, None, :] + 0.5) * (bin_h / ry)[:, None, None])
    ix = (px[None, :, None] * bin_w[:, None, None] + x1[:, None, None]
          + (j[None, None, :] + 0.5) * (bin_w / rx)[:, None, None])
    yy = iy.clamp(0.0, H - 1.0)[:, :, :, None, None]   # [K, ph, R, 1, 1]
    xx = ix.clamp(0.0, W - 1.0)[:, None, None, :, :]   # [K, 1, 1, pw, R]
    n_idx = _image_index(boxes_num, x.device)[:, None, None, None, None]
    xt = x.permute(0, 2, 3, 1)
    vals = _bilerp_nhwc(xt, n_idx, yy, xx)             # [K,ph,R,pw,R,C]
    w = ((j[None, :, None] < ry[:, None, None])
         & (j[None, None, :] < rx[:, None, None])).to(vals.dtype)
    out = (vals * w[:, None, :, None, :, None]).sum(dim=(2, 4))
    out = out / (ry * rx)[:, None, None, None]          # [K, ph, pw, C]
    return out.permute(0, 3, 1, 2)


def _bins(lo, hi_size, n, scale_fn):
    """Quantized bin edges [n] of a RoI side (``roi_pool``'s rule)."""
    b = torch.arange(n, dtype=torch.float32, device=lo.device)
    return (torch.floor(lo + b * hi_size / n),
            torch.ceil(lo + (b + 1) * hi_size / n))


def _bin_masks(y1, x1, rh, rw, ph, pw, H, W, device):
    ys = torch.arange(H, dtype=torch.float32, device=device)
    xs = torch.arange(W, dtype=torch.float32, device=device)
    by0, by1 = _bins(y1, rh, ph, None)
    bx0, bx1 = _bins(x1, rw, pw, None)
    in_y = (ys[None, :] >= by0[:, None]) & (ys[None, :] < by1[:, None])
    in_x = (xs[None, :] >= bx0[:, None]) & (xs[None, :] < bx1[:, None])
    return in_y[:, None, :, None] & in_x[None, :, None, :]   # ph,pw,H,W


def roi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0):
    """Quantized max-pool bins per RoI -> [K, C, ph, pw] (an empty bin is
    0)."""
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    ph, pw = output_size
    x = _t(x)
    H, W = x.shape[-2:]
    boxes = _t(boxes, x, torch.float32)
    img = _image_index(boxes_num, x.device)
    outs = []
    for k in range(boxes.shape[0]):
        x1, y1, x2, y2 = torch.round(boxes[k] * spatial_scale).unbind()
        rh = (y2 - y1 + 1).clamp(min=1.0)
        rw = (x2 - x1 + 1).clamp(min=1.0)
        mask = _bin_masks(y1, x1, rh, rw, ph, pw, H, W, x.device)
        feat = x[img[k]]
        masked = torch.where(mask[None], feat[:, None, None],
                             torch.tensor(-3.4e38, dtype=x.dtype,
                                          device=x.device))
        out = masked.amax(dim=(-1, -2))
        empty = ~mask.any(dim=-1).any(dim=-1)
        outs.append(torch.where(empty[None], 0.0, out))
    return torch.stack(outs)


def psroi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0):
    """Position-sensitive average pooling (R-FCN): [N, C ph pw, H, W] ->
    [K, C, ph, pw]; bin (c, i, j) averages channel c ph pw + i pw + j."""
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    ph, pw = output_size
    x = _t(x)
    Cin, H, W = x.shape[1:]
    C = Cin // (ph * pw)
    boxes = _t(boxes, x, torch.float32)
    img = _image_index(boxes_num, x.device)
    outs = []
    for k in range(boxes.shape[0]):
        x1, y1, x2, y2 = (boxes[k] * spatial_scale).unbind()
        rh = (y2 - y1).clamp(min=0.1)
        rw = (x2 - x1).clamp(min=0.1)
        mask = _bin_masks(y1, x1, rh, rw, ph, pw, H, W, x.device)
        fs = x[img[k]].reshape(C, ph, pw, H, W)
        num = torch.where(mask[None], fs, 0.0).sum(dim=(-1, -2))
        den = mask.sum(dim=(-1, -2)).clamp(min=1)[None]
        outs.append(num / den)
    return torch.stack(outs)


# ---------------------------------------------------------------------------
# box utilities
# ---------------------------------------------------------------------------
def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True):
    """SSD-style delta encode / decode."""
    tb = _t(target_box, dtype=torch.float32)
    pb = _t(prior_box, tb, torch.float32)
    var = (_t(prior_box_var, tb, torch.float32)
           if prior_box_var is not None
           else torch.ones((4,), device=tb.device))
    norm = 0.0 if box_normalized else 1.0
    pw = pb[..., 2] - pb[..., 0] + norm
    ph = pb[..., 3] - pb[..., 1] + norm
    pcx = pb[..., 0] + 0.5 * pw
    pcy = pb[..., 1] + 0.5 * ph
    if code_type == "encode_center_size":
        tw = tb[..., 2] - tb[..., 0] + norm
        th = tb[..., 3] - tb[..., 1] + norm
        tcx = tb[..., 0] + 0.5 * tw
        tcy = tb[..., 1] + 0.5 * th
        return torch.stack([(tcx - pcx) / pw / var[..., 0],
                            (tcy - pcy) / ph / var[..., 1],
                            torch.log(tw / pw) / var[..., 2],
                            torch.log(th / ph) / var[..., 3]], dim=-1)
    dcx = var[..., 0] * tb[..., 0] * pw + pcx
    dcy = var[..., 1] * tb[..., 1] * ph + pcy
    dw = torch.exp(var[..., 2] * tb[..., 2]) * pw
    dh = torch.exp(var[..., 3] * tb[..., 3]) * ph
    return torch.stack([dcx - 0.5 * dw, dcy - 0.5 * dh,
                        dcx + 0.5 * dw - norm, dcy + 0.5 * dh - norm],
                       dim=-1)


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5):
    """SSD anchors for a feature map ``input`` [N, C, H, W] over ``image``
    [N, C, Him, Wim]: (boxes, variances) [H, W, A, 4], computed on the
    host as in JAX and placed on the feature map's device."""
    H, W = input.shape[-2:]
    img_h, img_w = image.shape[-2:]
    step_h = steps[1] or img_h / H
    step_w = steps[0] or img_w / W
    ars = [1.0]
    for ar in aspect_ratios:
        if ar != 1.0:
            ars.append(ar)
            if flip:
                ars.append(1.0 / ar)
    sizes = []
    for i, ms in enumerate(min_sizes):
        for ar in ars:
            sizes.append((ms * np.sqrt(ar), ms / np.sqrt(ar)))
        if max_sizes:
            bs = np.sqrt(ms * max_sizes[i])
            sizes.append((bs, bs))
    sizes = np.asarray(sizes, np.float32)
    cx = (np.arange(W) + offset) * step_w
    cy = (np.arange(H) + offset) * step_h
    cxg, cyg = np.meshgrid(cx, cy)
    boxes = np.stack([
        (cxg[..., None] - sizes[None, None, :, 0] / 2) / img_w,
        (cyg[..., None] - sizes[None, None, :, 1] / 2) / img_h,
        (cxg[..., None] + sizes[None, None, :, 0] / 2) / img_w,
        (cyg[..., None] + sizes[None, None, :, 1] / 2) / img_h,
    ], axis=-1).astype(np.float32)
    if clip:
        boxes = np.clip(boxes, 0.0, 1.0)
    var = np.broadcast_to(np.asarray(variance, np.float32),
                          boxes.shape).copy()
    dev = input.device if isinstance(input, torch.Tensor) else None
    return (torch.as_tensor(boxes, device=dev),
            torch.as_tensor(var, device=dev))


# ---------------------------------------------------------------------------
# deformable convolution
# ---------------------------------------------------------------------------
def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=0,
                  dilation=1, deformable_groups=1, groups=1, mask=None):
    """Deformable convolution (v1; v2 with ``mask``): x [N, Cin, H, W];
    offset [N, 2 dg kh kw, Hout, Wout] in Paddle's layout (per-tap (dy,
    dx) pairs); weight [Cout, Cin / groups, kh, kw]."""
    stride, padding, dilation = _pair(stride), _pair(padding), \
        _pair(dilation)
    x = _t(x)
    offset = _t(offset, x)
    N, Cin, H, W = x.shape
    Cout, cpg, kh, kw = weight.shape
    oh = (H + 2 * padding[0] - dilation[0] * (kh - 1) - 1) // stride[0] + 1
    ow = (W + 2 * padding[1] - dilation[1] * (kw - 1) - 1) // stride[1] + 1
    K, dg = kh * kw, deformable_groups
    cpdg = Cin // dg
    # the padded map inside a one-pixel zero ring: taps outside the map
    # read zero, as in the reference
    p0, p1 = padding[0] + 1, padding[1] + 1
    ring = torch.nn.functional.pad(x, (p1, p1, p0, p0))
    Hr, Wr = ring.shape[-2:]
    dev = x.device
    base_y = (torch.arange(kh, device=dev) * dilation[0])[:, None, None, None] \
        + (torch.arange(oh, device=dev) * stride[0])[None, None, :, None]
    base_x = (torch.arange(kw, device=dev) * dilation[1])[None, :, None, None] \
        + (torch.arange(ow, device=dev) * stride[1])[None, None, None, :]
    base_y = base_y.expand(kh, kw, oh, ow).reshape(K, oh, ow)
    base_x = base_x.expand(kh, kw, oh, ow).reshape(K, oh, ow)
    off = offset.reshape(N, dg, K, 2, oh, ow).to(x.dtype)
    yy = base_y + off[:, :, :, 0]                       # [N, dg, K, oh, ow]
    xx = base_x + off[:, :, :, 1]
    Hp, Wp = H + 2 * padding[0], W + 2 * padding[1]
    far = (yy < -1.0) | (yy > Hp + 0.0) | (xx < -1.0) | (xx > Wp + 0.0)
    y = (yy + 1.0).clamp(0.0, Hr - 1.0)
    xq = (xx + 1.0).clamp(0.0, Wr - 1.0)
    y0f, x0f = torch.floor(y), torch.floor(xq)
    y0, x0 = y0f.long(), x0f.long()
    y1 = (y0 + 1).clamp(max=Hr - 1)
    x1 = (x0 + 1).clamp(max=Wr - 1)
    wy1, wx1 = y - y0f, xq - x0f
    feat = ring.reshape(N, dg, cpdg, Hr * Wr)
    L = K * oh * ow

    def tap(yi, xi):
        idx = (yi * Wr + xi).reshape(N, dg, 1, L).expand(N, dg, cpdg, L)
        return torch.gather(feat, 3, idx).reshape(N, dg, cpdg, K, oh, ow)

    def w(t):
        return t[:, :, None]

    vals = (tap(y0, x0) * w((1 - wy1) * (1 - wx1))
            + tap(y0, x1) * w((1 - wy1) * wx1)
            + tap(y1, x0) * w(wy1 * (1 - wx1))
            + tap(y1, x1) * w(wy1 * wx1))
    vals = torch.where(w(far), 0.0, vals)
    if mask is not None:
        vals = vals * w(_t(mask, x).reshape(N, dg, K, oh, ow).to(x.dtype))
    s = vals.reshape(N, groups, cpg, K, oh, ow)
    wt = weight.reshape(groups, Cout // groups, cpg, K)
    out = torch.einsum("gock,ngckhw->ngohw", wt, s).reshape(N, Cout, oh, ow)
    if bias is not None:
        out = out + _t(bias, x).reshape(1, -1, 1, 1)
    return out


def matrix_nms(boxes, scores, score_threshold=0.05, post_threshold=0.0,
               nms_top_k=-1, keep_top_k=-1, use_gaussian=False,
               gaussian_sigma=2.0):
    """Matrix NMS (SOLOv2): each box's score times the least decay over
    the higher-scored boxes overlapping it, in one [n, n] pass. boxes
    [N, 4], scores [N] (one class) -> (decayed scores [N], kept indices
    by decayed score)."""
    boxes = _t(boxes)
    scores = _t(scores, boxes)
    valid_idx = np.nonzero((scores >= score_threshold).cpu().numpy())[0]
    if valid_idx.size == 0:
        return (torch.zeros_like(scores),
                torch.zeros(0, dtype=torch.int64, device=boxes.device))
    vi = torch.as_tensor(valid_idx, device=boxes.device)
    sub_scores, sub_boxes = scores[vi], boxes[vi]
    order = torch.argsort(-sub_scores, stable=True)
    if nms_top_k > 0:
        order = order[:nms_top_k]
    b, s = sub_boxes[order], sub_scores[order]
    n = b.shape[0]
    iou = _box_iou_matrix(b, b)
    upper = torch.triu(torch.ones((n, n), dtype=torch.bool,
                                  device=b.device), diagonal=1)
    iou_u = torch.where(upper, iou, 0.0)
    iou_ji = iou_u.T
    comp = iou_u.amax(dim=0)
    if use_gaussian:
        decay = torch.exp(gaussian_sigma * (comp[None, :] ** 2
                                            - iou_ji ** 2))
    else:
        decay = (1.0 - iou_ji) / (1.0 - comp[None, :]).clamp(min=1e-10)
    decay = torch.where(iou_ji > 0, decay, 1.0)
    new_scores = s * decay.amin(dim=1)
    keep = (new_scores >= post_threshold).cpu().numpy()
    kept_sorted = torch.argsort(-new_scores, stable=True).cpu().numpy()
    orig = valid_idx[order.cpu().numpy()]
    kept = orig[kept_sorted][keep[kept_sorted]]
    if keep_top_k > 0:
        kept = kept[:keep_top_k]
    out_scores = torch.zeros_like(scores)
    out_scores[torch.as_tensor(orig, device=boxes.device)] = new_scores
    return out_scores, torch.as_tensor(kept, dtype=torch.int64,
                                       device=boxes.device)
