"""Image transforms (counterpart of ``paddle_tpu/vision/transforms.py``;
parity: ``paddle.vision.transforms``): Compose, Resize, the crops and
flips, Normalize, ToTensor, the photometric and geometric transforms and
their functional forms.

They run on the host, on PIL images or numpy HWC arrays, as in JAX:
preprocessing belongs to the ``DataLoader``'s workers, beside the
device's work. PIL is imported when present (the numpy paths need none).
The random ones draw from Python's ``random`` (or their own numpy
generator where JAX's do), so both packages draw the same after
``random.seed``. ``rotate``, ``affine`` and ``perspective`` warp a CHW
(or NCHW) image through the port's ``nn.functional.grid_sample`` and
return a tensor, as the JAX ones return an array.
"""

from __future__ import annotations

import numbers
import random
from typing import Sequence

import numpy as np

try:  # PIL is the image decode path, as in the reference
    from PIL import Image

    _HAS_PIL = True
except Exception:  # pragma: no cover
    _HAS_PIL = False


def _is_pil(img):
    return _HAS_PIL and isinstance(img, Image.Image)


def _size_pair(size):
    if isinstance(size, numbers.Number):
        return int(size), int(size)
    return int(size[0]), int(size[1])


# ---------------------------------------------------------------- functional


def to_tensor(img, data_format="CHW"):
    """PIL/HWC-uint8 → float32 in [0,1], CHW (paddle default) or HWC."""
    if _is_pil(img):
        img = np.asarray(img)
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[:, :, None]
    arr = img.astype(np.float32)
    if img.dtype == np.uint8:
        arr = arr / 255.0
    if data_format == "CHW":
        arr = np.transpose(arr, (2, 0, 1))
    return arr


def normalize(img, mean, std, data_format="CHW"):
    arr = np.asarray(img, dtype=np.float32)
    mean = np.asarray(mean, dtype=np.float32)
    std = np.asarray(std, dtype=np.float32)
    shape = (-1, 1, 1) if data_format == "CHW" else (1, 1, -1)
    return (arr - mean.reshape(shape)) / std.reshape(shape)


def resize(img, size, interpolation="bilinear"):
    # int size = resize the SHORTER edge to `size`, preserving aspect
    # ratio (paddle semantics); (h, w) = exact target.
    if isinstance(size, numbers.Number):
        if _is_pil(img):
            iw, ih = img.size
        else:
            ih, iw = np.asarray(img).shape[:2]
        s = int(size)
        if ih <= iw:
            h, w = s, max(1, int(round(iw * s / ih)))
        else:
            h, w = max(1, int(round(ih * s / iw))), s
    else:
        h, w = _size_pair(size)
    if _is_pil(img):
        modes = {
            "nearest": Image.NEAREST,
            "bilinear": Image.BILINEAR,
            "bicubic": Image.BICUBIC,
        }
        return img.resize((w, h), modes.get(interpolation, Image.BILINEAR))
    # numpy path: nearest / bilinear via index interpolation
    arr = np.asarray(img)
    src_h, src_w = arr.shape[:2]
    if interpolation == "nearest":
        ys = np.clip(
            np.round(np.linspace(0, src_h - 1, h)).astype(int), 0, src_h - 1
        )
        xs = np.clip(
            np.round(np.linspace(0, src_w - 1, w)).astype(int), 0, src_w - 1
        )
        return arr[ys][:, xs]
    ys = np.linspace(0, src_h - 1, h)
    xs = np.linspace(0, src_w - 1, w)
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    y1 = np.minimum(y0 + 1, src_h - 1)
    x1 = np.minimum(x0 + 1, src_w - 1)
    wy = (ys - y0)[:, None]
    wx = (xs - x0)[None, :]
    if arr.ndim == 3:
        wy = wy[..., None]
        wx = wx[..., None]
    a = arr.astype(np.float32)
    top = a[y0][:, x0] * (1 - wx) + a[y0][:, x1] * wx
    bot = a[y1][:, x0] * (1 - wx) + a[y1][:, x1] * wx
    out = top * (1 - wy) + bot * wy
    return out.astype(arr.dtype) if arr.dtype == np.uint8 else out


def crop(img, top, left, height, width):
    if _is_pil(img):
        # PIL pads out-of-bounds crops with zeros; mirror that on the
        # numpy path below so both backends return the requested size
        return img.crop((left, top, left + width, top + height))
    arr = np.asarray(img)
    out = arr[max(top, 0): max(top + height, 0),
              max(left, 0): max(left + width, 0)]
    if out.shape[0] != height or out.shape[1] != width:
        padded = np.zeros((height, width) + arr.shape[2:], dtype=arr.dtype)
        oy = max(-top, 0)
        ox = max(-left, 0)
        padded[oy:oy + out.shape[0], ox:ox + out.shape[1]] = out
        return padded
    return out


def center_crop(img, size):
    h, w = _size_pair(size)
    if _is_pil(img):
        iw, ih = img.size
    else:
        ih, iw = np.asarray(img).shape[:2]
    return crop(img, max(0, (ih - h) // 2), max(0, (iw - w) // 2), h, w)


def hflip(img):
    if _is_pil(img):
        return img.transpose(Image.FLIP_LEFT_RIGHT)
    return np.asarray(img)[:, ::-1]


def vflip(img):
    if _is_pil(img):
        return img.transpose(Image.FLIP_TOP_BOTTOM)
    return np.asarray(img)[::-1]


# ------------------------------------------------------------------ classes


class BaseTransform:
    def __call__(self, img):
        raise NotImplementedError


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, img):
        for t in self.transforms:
            img = t(img)
        return img


class ToTensor(BaseTransform):
    def __init__(self, data_format="CHW"):
        self.data_format = data_format

    def __call__(self, img):
        return to_tensor(img, self.data_format)


class Normalize(BaseTransform):
    def __init__(self, mean=0.0, std=1.0, data_format="CHW"):
        # scalars broadcast over whatever channel count the image has
        # (a grayscale input must stay single-channel)
        if isinstance(mean, numbers.Number):
            mean = [mean]
        if isinstance(std, numbers.Number):
            std = [std]
        self.mean, self.std, self.data_format = mean, std, data_format

    def __call__(self, img):
        return normalize(img, self.mean, self.std, self.data_format)


class Resize(BaseTransform):
    def __init__(self, size, interpolation="bilinear"):
        self.size, self.interpolation = size, interpolation

    def __call__(self, img):
        return resize(img, self.size, self.interpolation)


class CenterCrop(BaseTransform):
    def __init__(self, size):
        self.size = size

    def __call__(self, img):
        return center_crop(img, self.size)


class RandomCrop(BaseTransform):
    def __init__(self, size, padding=0):
        self.size = _size_pair(size)
        self.padding = padding

    def __call__(self, img):
        arr = np.asarray(img)
        if self.padding:
            p = self.padding
            pad = [(p, p), (p, p)] + [(0, 0)] * (arr.ndim - 2)
            arr = np.pad(arr, pad, mode="constant")
        h, w = self.size
        ih, iw = arr.shape[:2]
        top = random.randint(0, max(0, ih - h))
        left = random.randint(0, max(0, iw - w))
        return crop(arr, top, left, h, w)


class RandomHorizontalFlip(BaseTransform):
    def __init__(self, prob=0.5):
        self.prob = prob

    def __call__(self, img):
        return hflip(img) if random.random() < self.prob else img


class RandomVerticalFlip(BaseTransform):
    def __init__(self, prob=0.5):
        self.prob = prob

    def __call__(self, img):
        return vflip(img) if random.random() < self.prob else img


class RandomResizedCrop(BaseTransform):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation="bilinear"):
        self.size = _size_pair(size)
        self.scale, self.ratio = scale, ratio
        self.interpolation = interpolation

    def __call__(self, img):
        arr = np.asarray(img) if not _is_pil(img) else img
        if _is_pil(arr):
            iw, ih = arr.size
        else:
            ih, iw = arr.shape[:2]
        area = ih * iw
        for _ in range(10):
            target = random.uniform(*self.scale) * area
            ar = random.uniform(*self.ratio)
            w = int(round((target * ar) ** 0.5))
            h = int(round((target / ar) ** 0.5))
            if 0 < w <= iw and 0 < h <= ih:
                top = random.randint(0, ih - h)
                left = random.randint(0, iw - w)
                patch = crop(img, top, left, h, w)
                return resize(patch, self.size, self.interpolation)
        return resize(center_crop(img, min(ih, iw)), self.size,
                      self.interpolation)


class Transpose(BaseTransform):
    """HWC → CHW (paddle parity for pipelines that skip ToTensor)."""

    def __init__(self, order=(2, 0, 1)):
        self.order = order

    def __call__(self, img):
        return np.transpose(np.asarray(img), self.order)


# ---------------------------------------------------------------------------
# geometric transforms over grid_sample (round 3: rotate/affine/perspective)
# ---------------------------------------------------------------------------
def _apply_inverse_matrix(img, inv3x3, interpolation="bilinear", fill=0.0):
    """Warp a CHW/NCHW image by the INVERSE 3x3 pixel-coordinate matrix
    with one ``grid_sample`` call (zeros padding, then ``fill``)."""
    import torch

    from ..nn.functional import grid_sample

    x = img if isinstance(img, torch.Tensor) else torch.as_tensor(
        np.asarray(img))
    single = x.dim() == 3
    x = x[None] if single else x
    n, c, h, w = x.shape
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=x.device),
        torch.arange(w, dtype=torch.float32, device=x.device),
        indexing="ij")
    tgt = torch.stack([xs, ys, torch.ones_like(xs)], 0).reshape(3, -1)
    src = torch.as_tensor(np.asarray(inv3x3), dtype=torch.float32,
                          device=x.device) @ tgt
    sx = src[0] / src[2].abs().clamp(min=1e-9) * torch.sign(src[2])
    sy = src[1] / src[2].abs().clamp(min=1e-9) * torch.sign(src[2])
    # pixel coords -> normalized [-1, 1] (align_corners=False)
    gx = (2.0 * sx + 1.0) / w - 1.0
    gy = (2.0 * sy + 1.0) / h - 1.0
    grid = torch.stack([gx, gy], -1).reshape(1, h, w, 2).expand(n, h, w, 2)
    out = grid_sample(x, grid, mode=interpolation, padding_mode="zeros",
                      align_corners=False)
    if fill:
        mask = grid_sample(torch.ones_like(x[:, :1]), grid,
                           mode=interpolation, padding_mode="zeros",
                           align_corners=False)
        out = out + (1.0 - mask) * fill
    return out[0] if single else out


def _affine_pixel_matrix(angle, translate, scale, shear, center):
    """Forward 2x3 affine in pixel coords (paddle/torchvision
    convention: rotate about center, then shear/scale/translate)."""
    import math

    cx, cy = center
    # positive angle = counter-clockwise in display coords (y down), the
    # paddle/torchvision convention
    rot = math.radians(-angle)
    sx, sy = [math.radians(s) for s in shear]
    # RSS = rotate ∘ shear ∘ scale (torchvision _get_inverse_affine_matrix)
    a = math.cos(rot - sy) / math.cos(sy)
    b = -math.cos(rot - sy) * math.tan(sx) / math.cos(sy) - math.sin(rot)
    c = math.sin(rot - sy) / math.cos(sy)
    d = -math.sin(rot - sy) * math.tan(sx) / math.cos(sy) + math.cos(rot)
    m = [[scale * a, scale * b, 0.0], [scale * c, scale * d, 0.0]]
    tx, ty = translate
    m[0][2] = cx + tx - m[0][0] * cx - m[0][1] * cy
    m[1][2] = cy + ty - m[1][0] * cx - m[1][1] * cy
    return m


def affine(img, angle=0.0, translate=(0, 0), scale=1.0, shear=(0.0, 0.0),
           interpolation="bilinear", fill=0.0, center=None):
    """Parity: ``paddle.vision.transforms.functional.affine`` (CHW)."""
    h, w = img.shape[-2:]
    if center is None:
        center = ((w - 1) * 0.5, (h - 1) * 0.5)
    if not isinstance(shear, (tuple, list)):
        shear = (shear, 0.0)
    m = np.vstack([_affine_pixel_matrix(angle, translate, scale, shear,
                                        center), [0.0, 0.0, 1.0]])
    return _apply_inverse_matrix(img, np.linalg.inv(m), interpolation,
                                 fill)


def rotate(img, angle, interpolation="bilinear", expand=False, fill=0.0,
           center=None):
    """Parity: paddle.vision.transforms.functional.rotate (expand=False)."""
    if expand:
        raise NotImplementedError("rotate(expand=True) not supported")
    return affine(img, angle=angle, interpolation=interpolation,
                  fill=fill, center=center)


def perspective(img, startpoints, endpoints, interpolation="bilinear",
                fill=0.0):
    """Parity: paddle.vision.transforms.functional.perspective — warp so
    ``startpoints`` (4 [x, y] corners) map onto ``endpoints``."""
    a = []
    bvec = []
    for (sx, sy), (ex, ey) in zip(startpoints, endpoints):
        a.append([sx, sy, 1, 0, 0, 0, -ex * sx, -ex * sy])
        a.append([0, 0, 0, sx, sy, 1, -ey * sx, -ey * sy])
        bvec += [ex, ey]
    coeffs = np.linalg.solve(np.asarray(a, np.float64),
                             np.asarray(bvec, np.float64))
    m = np.append(coeffs, 1.0).reshape(3, 3)
    return _apply_inverse_matrix(img, np.linalg.inv(m), interpolation,
                                 fill)


def _symmetric_range(value):
    """scalar d → (-d, d); sequence → tuple(value)."""
    return (-value, value) if np.isscalar(value) else tuple(value)


class RandomRotation(BaseTransform):
    def __init__(self, degrees, interpolation="bilinear", fill=0.0,
                 center=None, seed=None):
        self.degrees = _symmetric_range(degrees)
        self.interpolation = interpolation
        self.fill = fill
        self.center = center
        self._rng = np.random.default_rng(seed)

    def __call__(self, img):
        ang = float(self._rng.uniform(*self.degrees))
        return rotate(img, ang, self.interpolation, fill=self.fill,
                      center=self.center)


class RandomAffine(BaseTransform):
    def __init__(self, degrees, translate=None, scale=None, shear=None,
                 interpolation="bilinear", fill=0.0, seed=None):
        self.degrees = _symmetric_range(degrees)
        self.translate = translate
        self.scale = scale
        self.shear = None if shear is None else _symmetric_range(shear)
        self.interpolation = interpolation
        self.fill = fill
        self._rng = np.random.default_rng(seed)

    def __call__(self, img):
        h, w = img.shape[-2:]
        ang = float(self._rng.uniform(*self.degrees))
        tx = ty = 0.0
        if self.translate is not None:
            tx = float(self._rng.uniform(-self.translate[0],
                                         self.translate[0]) * w)
            ty = float(self._rng.uniform(-self.translate[1],
                                         self.translate[1]) * h)
        sc = 1.0 if self.scale is None else float(
            self._rng.uniform(*self.scale))
        sh = (0.0, 0.0) if self.shear is None else (
            float(self._rng.uniform(*self.shear)), 0.0)
        return affine(img, ang, (tx, ty), sc, sh, self.interpolation,
                      self.fill)


# ------------------------------------------------- color / photometric ops
def _to_hwc_float(img):
    """PIL/HWC array → (float32 HWC ndarray, was_pil, was_uint8)."""
    was_pil = _is_pil(img)
    arr = np.asarray(img)
    was_u8 = arr.dtype == np.uint8
    a = arr.astype(np.float32)
    return a, was_pil, was_u8


def _restore(a, was_pil, was_u8):
    if was_u8:
        a = np.clip(np.round(a), 0, 255).astype(np.uint8)
    if was_pil:
        return Image.fromarray(a)
    return a


def adjust_brightness(img, brightness_factor):
    """Parity: paddle adjust_brightness — img * factor (blend with
    black), torchvision math."""
    a, p, u = _to_hwc_float(img)
    return _restore(a * brightness_factor, p, u)


def _grayscale(a):
    if a.ndim == 2 or a.shape[-1] == 1:
        return a if a.ndim == 2 else a[..., 0]
    return (0.299 * a[..., 0] + 0.587 * a[..., 1] + 0.114 * a[..., 2])


def adjust_contrast(img, contrast_factor):
    a, p, u = _to_hwc_float(img)
    mean = _grayscale(a).mean()
    return _restore(mean + contrast_factor * (a - mean), p, u)


def adjust_saturation(img, saturation_factor):
    a, p, u = _to_hwc_float(img)
    gray = _grayscale(a)[..., None]
    return _restore(gray + saturation_factor * (a - gray), p, u)


def adjust_hue(img, hue_factor):
    """hue_factor in [-0.5, 0.5]: shift hue in HSV space."""
    if not -0.5 <= hue_factor <= 0.5:
        raise ValueError("hue_factor must be in [-0.5, 0.5]")
    a, p, u = _to_hwc_float(img)
    scale = 255.0 if u else 1.0
    rgb = a / scale
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = rgb.max(-1)
    minc = rgb.min(-1)
    v = maxc
    d = maxc - minc
    s = np.where(maxc > 0, d / np.maximum(maxc, 1e-12), 0.0)
    dd = np.maximum(d, 1e-12)
    rc, gc, bc = (maxc - r) / dd, (maxc - g) / dd, (maxc - b) / dd
    h = np.where(maxc == r, bc - gc,
                 np.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = (h / 6.0) % 1.0
    h = np.where(d == 0, 0.0, h)
    h = (h + hue_factor) % 1.0
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    pp = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.astype(np.int32) % 6
    r2 = np.choose(i, [v, q, pp, pp, t, v])
    g2 = np.choose(i, [t, v, v, q, pp, pp])
    b2 = np.choose(i, [pp, pp, t, v, v, q])
    out = np.stack([r2, g2, b2], axis=-1) * scale
    return _restore(out, p, u)


def to_grayscale(img, num_output_channels=1):
    a, p, u = _to_hwc_float(img)
    g = _grayscale(a)[..., None]
    out = np.repeat(g, num_output_channels, axis=-1)
    if p and num_output_channels == 1:
        out = out[..., 0]
    return _restore(out, p, u)


def pad(img, padding, fill=0, padding_mode="constant"):
    """Parity: paddle transforms.pad — padding int | (lr, tb) |
    (l, t, r, b); HWC arrays or PIL."""
    if isinstance(padding, numbers.Number):
        l = t = r = b = int(padding)
    elif len(padding) == 2:
        l = r = int(padding[0])
        t = b = int(padding[1])
    else:
        l, t, r, b = (int(v) for v in padding)
    was_pil = _is_pil(img)
    arr = np.asarray(img)
    width = [(t, b), (l, r)] + [(0, 0)] * (arr.ndim - 2)
    if padding_mode == "constant":
        out = np.pad(arr, width, constant_values=fill)
    else:
        out = np.pad(arr, width, mode=padding_mode)
    return Image.fromarray(out) if was_pil else out


def erase(img, i, j, h, w, v, inplace=False):
    """Fill ``[i:i+h, j:j+w]`` with ``v``: CHW arrays or tensors (or HWC
    with a trailing channel)."""
    chw = img.ndim == 3 and img.shape[0] in (1, 3)
    if isinstance(img, np.ndarray):
        out = img if inplace else img.copy()
    else:
        out = img if inplace else img.clone()
        if isinstance(v, np.ndarray):
            import torch

            v = torch.as_tensor(v, device=img.device)
    if chw:
        out[:, i:i + h, j:j + w] = v
    else:
        out[i:i + h, j:j + w] = v
    return out


class Pad(BaseTransform):
    def __init__(self, padding, fill=0, padding_mode="constant"):
        self.args = (padding, fill, padding_mode)

    def __call__(self, img):
        return pad(img, *self.args)


class Grayscale(BaseTransform):
    def __init__(self, num_output_channels=1):
        self.n = num_output_channels

    def __call__(self, img):
        return to_grayscale(img, self.n)


class BrightnessTransform(BaseTransform):
    """value v: factor drawn U[max(0, 1-v), 1+v] (paddle semantics)."""

    def __init__(self, value, seed=None):
        self.value = value
        self._rng = np.random.default_rng(seed)

    def _factor(self):
        v = self.value
        return float(self._rng.uniform(max(0.0, 1 - v), 1 + v))

    def __call__(self, img):
        return adjust_brightness(img, self._factor())


class ContrastTransform(BrightnessTransform):
    def __call__(self, img):
        return adjust_contrast(img, self._factor())


class SaturationTransform(BrightnessTransform):
    def __call__(self, img):
        return adjust_saturation(img, self._factor())


class HueTransform(BaseTransform):
    """value v <= 0.5: shift drawn U[-v, v]."""

    def __init__(self, value, seed=None):
        self.value = value
        self._rng = np.random.default_rng(seed)

    def __call__(self, img):
        return adjust_hue(img, float(self._rng.uniform(-self.value,
                                                       self.value)))


class ColorJitter(BaseTransform):
    """Parity: paddle ColorJitter — brightness/contrast/saturation/hue
    jitter applied in random order."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0,
                 seed=None):
        self._rng = np.random.default_rng(seed)
        self.ops = []
        if brightness:
            self.ops.append(BrightnessTransform(brightness,
                                                seed=self._rng.integers(2**31)))
        if contrast:
            self.ops.append(ContrastTransform(contrast,
                                              seed=self._rng.integers(2**31)))
        if saturation:
            self.ops.append(SaturationTransform(saturation,
                                                seed=self._rng.integers(2**31)))
        if hue:
            self.ops.append(HueTransform(hue,
                                         seed=self._rng.integers(2**31)))

    def __call__(self, img):
        for k in self._rng.permutation(len(self.ops)):
            img = self.ops[int(k)](img)
        return img


class RandomPerspective(BaseTransform):
    """Parity: paddle RandomPerspective — random corner displacement
    warp with probability ``prob``."""

    def __init__(self, prob=0.5, distortion_scale=0.5,
                 interpolation="bilinear", fill=0.0, seed=None):
        self.prob = prob
        self.scale = distortion_scale
        self.interpolation = interpolation
        self.fill = fill
        self._rng = np.random.default_rng(seed)

    def __call__(self, img):
        if self._rng.random() >= self.prob:
            return img
        h, w = np.asarray(img).shape[-2:] if not _is_pil(img) \
            else (img.size[1], img.size[0])
        if not _is_pil(img) and np.asarray(img).ndim == 3 \
                and np.asarray(img).shape[0] not in (1, 3):
            h, w = np.asarray(img).shape[:2]
        dx = self.scale * w / 2
        dy = self.scale * h / 2
        start = [[0, 0], [w - 1, 0], [w - 1, h - 1], [0, h - 1]]
        end = [[float(self._rng.uniform(0, dx)),
                float(self._rng.uniform(0, dy))],
               [float(w - 1 - self._rng.uniform(0, dx)),
                float(self._rng.uniform(0, dy))],
               [float(w - 1 - self._rng.uniform(0, dx)),
                float(h - 1 - self._rng.uniform(0, dy))],
               [float(self._rng.uniform(0, dx)),
                float(h - 1 - self._rng.uniform(0, dy))]]
        return perspective(img, start, end, self.interpolation, self.fill)


class RandomErasing(BaseTransform):
    """Parity: paddle RandomErasing — erase a random rectangle with
    probability ``prob``; value None => random noise."""

    def __init__(self, prob=0.5, scale=(0.02, 0.33), ratio=(0.3, 3.3),
                 value=0, inplace=False, seed=None):
        self.prob = prob
        self.scale = scale
        self.ratio = ratio
        self.value = value
        self.inplace = inplace
        self._rng = np.random.default_rng(seed)

    def __call__(self, img):
        if self._rng.random() >= self.prob:
            return img
        arr = np.asarray(img) if not _is_pil(img) else np.asarray(img)
        chw = arr.ndim == 3 and arr.shape[0] in (1, 3)
        h, w = (arr.shape[1:3] if chw else arr.shape[:2])
        area = h * w
        for _ in range(10):
            target = float(self._rng.uniform(*self.scale)) * area
            ar = float(np.exp(self._rng.uniform(np.log(self.ratio[0]),
                                                np.log(self.ratio[1]))))
            eh = int(round(np.sqrt(target * ar)))
            ew = int(round(np.sqrt(target / ar)))
            if eh < h and ew < w and eh > 0 and ew > 0:
                i = int(self._rng.integers(0, h - eh + 1))
                j = int(self._rng.integers(0, w - ew + 1))
                if self.value is None:
                    shape = ((arr.shape[0], eh, ew) if chw
                             else (eh, ew) + arr.shape[2:])
                    v = self._rng.standard_normal(shape).astype(
                        np.float32)
                else:
                    v = self.value
                return erase(img, i, j, eh, ew, v, self.inplace)
        return img
