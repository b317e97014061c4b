"""``paddle_tpu_torch.vision.transforms`` and ``vision.datasets`` against
the JAX package's (``tests/test_vision.py``'s and
``test_vision_dist_tail.py``'s cases on both packages):

- every transform and functional form gives JAX's output on the same
  numpy HWC images and on PIL images, the random ones after the same
  ``random.seed`` (or the same ``seed=``); ``rotate``, ``affine`` and
  ``perspective`` (through each package's ``grid_sample``) agree at
  1e-5;
- FakeData, MNIST / FashionMNIST (idx and idx.gz), Cifar10 / Cifar100
  (tarballs), DatasetFolder, ImageFolder, Flowers (jpg tarball and .mat
  files) and VOC2012 (a devkit tarball) read files the test writes under
  ``tmp_path`` and give JAX's samples; ``download=True`` without files
  raises in both.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import gzip
import io
import os
import pickle
import random
import struct
import tarfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from paddle_tpu.vision import datasets as jds
from paddle_tpu.vision import transforms as jT
from paddle_tpu_torch.vision import datasets as tds
from paddle_tpu_torch.vision import transforms as tT
from torch_parity import jit_o0

RNG = np.random.default_rng(0)
IMG = RNG.integers(0, 256, (20, 24, 3), dtype=np.uint8)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    if isinstance(x, Image.Image):
        return np.asarray(x)
    return np.asarray(x)


def same(got, want, tol=0.0):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape and g.dtype == w.dtype, \
        (g.shape, w.shape, g.dtype, w.dtype)
    if tol:
        np.testing.assert_allclose(g, w, rtol=0, atol=tol)
    else:
        assert np.array_equal(g, w)


def _both(name, *args, **kw):
    return getattr(tT, name)(*args, **kw), getattr(jT, name)(*args, **kw)


@pytest.mark.parametrize("make", [lambda: IMG, lambda: Image.fromarray(IMG)],
                         ids=["numpy", "pil"])
def test_deterministic_transforms_match_jax(make):
    for name, args in (("to_tensor", ()), ("resize", ((10, 12),)),
                       ("resize", (9,)), ("resize", ((7, 5), "nearest")),
                       ("crop", (2, 3, 8, 9)), ("crop", (-2, 20, 6, 8)),
                       ("center_crop", (11,)), ("hflip", ()), ("vflip", ()),
                       ("adjust_brightness", (1.3,)),
                       ("adjust_contrast", (0.6,)),
                       ("adjust_saturation", (1.7,)), ("adjust_hue", (0.2,)),
                       ("to_grayscale", (3,)), ("pad", ((1, 2),)),
                       ("pad", ((1, 2, 3, 4), 7)),
                       ("pad", (2, 0, "reflect"))):
        t, j = _both(name, make(), *args)
        same(t, j)
    arr = tT.to_tensor(IMG)
    same(tT.normalize(arr, [0.5] * 3, [0.2] * 3),
         jT.normalize(arr, [0.5] * 3, [0.2] * 3))


def _pipeline(mod, seed):
    return mod.Compose([
        mod.RandomResizedCrop(16), mod.RandomHorizontalFlip(),
        mod.RandomVerticalFlip(0.3), mod.RandomCrop(12, padding=2),
        mod.ColorJitter(0.3, 0.3, 0.3, 0.1, seed=seed),
        mod.Normalize([120.0] * 3, [60.0] * 3, data_format="HWC"),
        mod.Transpose()])


@pytest.mark.parametrize("make", [lambda: IMG, lambda: Image.fromarray(IMG)],
                         ids=["numpy", "pil"])
def test_random_transforms_draw_as_jax_after_random_seed(make):
    tp, jp = _pipeline(tT, 5), _pipeline(jT, 5)
    for i in range(4):
        random.seed(i)
        t = tp(make())
        random.seed(i)
        same(t, jp(make()), 1e-4)
    for cls, kw in ((tT.Grayscale, {}), (tT.ToTensor, {}),
                    (tT.CenterCrop, dict(size=8)), (tT.Resize, dict(size=6)),
                    (tT.Pad, dict(padding=1))):
        same(cls(**kw)(make()), getattr(jT, cls.__name__)(**kw)(make()))


def test_geometric_transforms_match_jax():
    chw = RNG.standard_normal((3, 10, 12)).astype(np.float32)
    t, j = torch.tensor(chw), jnp.asarray(chw)
    start = [[0, 0], [11, 0], [11, 9], [0, 9]]
    end = [[1, 2], [10, 0], [11, 8], [2, 9]]
    rand = (("RandomRotation", dict(degrees=20)),
            ("RandomAffine", dict(degrees=10, translate=(0.1, 0.1),
                                  scale=(0.9, 1.1), shear=5)))
    # the JAX warps in one jitted program (their draws happen at trace)
    want = jit_o0(lambda a: (
        jT.rotate(a, 30.0),
        jT.affine(a, 15.0, (2, -1), 1.2, (5.0, 3.0), fill=0.5),
        jT.perspective(a, start, end, "nearest"),
        *(getattr(jT, name)(seed=3, **kw)(a) for name, kw in rand)), j)
    got = (tT.rotate(t, 30.0),
           tT.affine(t, 15.0, (2, -1), 1.2, (5.0, 3.0), fill=0.5),
           tT.perspective(t, start, end, "nearest"),
           *(getattr(tT, name)(seed=3, **kw)(t) for name, kw in rand))
    for g, w in zip(got, want):
        same(g, np.asarray(w), 1e-5)
    same(tT.RandomPerspective(prob=1.0, seed=3)(t),
         np.asarray(jT.RandomPerspective(prob=1.0, seed=3)(j)), 1e-5)
    er = tT.RandomErasing(prob=1.0, seed=2, value=None)(chw)
    same(er, jT.RandomErasing(prob=1.0, seed=2, value=None)(chw))
    same(tT.erase(t, 1, 2, 3, 4, 0.0), np.asarray(jT.erase(j, 1, 2, 3, 4,
                                                           0.0)))


def _idx(path, arr, magic, gz):
    header = struct.pack(">I", magic) + b"".join(
        struct.pack(">I", d) for d in arr.shape)
    data = header + arr.astype(np.uint8).tobytes()
    with (gzip.open(path, "wb") if gz else open(path, "wb")) as f:
        f.write(data)


def _tar(path, members):
    with tarfile.open(path, "w:gz") as tf:
        for name, data in members.items():
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))


def _png(arr, fmt="PNG"):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, fmt)
    return buf.getvalue()


def _same_items(tset, jset):
    assert len(tset) == len(jset) > 0
    for i in range(len(tset)):
        for a, b in zip(tset[i], jset[i]):
            same(a, b)


def test_datasets_read_local_files_as_jax(tmp_path):
    _same_items(tds.FakeData(5, (8, 8, 3), transform=tT.ToTensor()),
                jds.FakeData(5, (8, 8, 3), transform=jT.ToTensor()))
    imgs = RNG.integers(0, 256, (6, 5, 4))
    labels = RNG.integers(0, 10, 6)
    for gz in (False, True):
        ip, lp = str(tmp_path / f"i{gz}"), str(tmp_path / f"l{gz}")
        ip, lp = (ip + ".gz", lp + ".gz") if gz else (ip, lp)
        _idx(ip, imgs, 2051, gz)
        _idx(lp, labels, 2049, gz)
        for name in ("MNIST", "FashionMNIST"):
            _same_items(getattr(tds, name)(ip, lp),
                        getattr(jds, name)(ip, lp))
    batch = {b"data": RNG.integers(0, 256, (4, 3 * 32 * 32)).astype(np.uint8),
             b"labels": [1, 2, 3, 4], b"fine_labels": [5, 6, 7, 8]}
    blob = pickle.dumps(batch)
    _tar(str(tmp_path / "c10.tgz"), {"cifar/data_batch_1": blob,
                                     "cifar/test_batch": blob})
    _tar(str(tmp_path / "c100.tgz"), {"cifar/train": blob,
                                      "cifar/test": blob})
    for name, f in (("Cifar10", "c10.tgz"), ("Cifar100", "c100.tgz")):
        for mode in ("train", "test"):
            _same_items(getattr(tds, name)(str(tmp_path / f), mode),
                        getattr(jds, name)(str(tmp_path / f), mode))
    root = tmp_path / "folder"
    for c in ("cat", "dog"):
        os.makedirs(root / c / "sub")
        for k in range(2):
            Image.fromarray(RNG.integers(0, 256, (6, 7, 3), dtype=np.uint8)) \
                .save(root / c / ("sub" if k else "") / f"{k}.png")
    (root / "cat" / "notes.txt").write_text("skip")
    tf_ = tds.DatasetFolder(str(root), transform=np.asarray)
    assert tf_.classes == ["cat", "dog"]
    _same_items(tf_, jds.DatasetFolder(str(root), transform=np.asarray))
    _same_items(tds.ImageFolder(str(root), transform=np.asarray),
                jds.ImageFolder(str(root), transform=np.asarray))
    from scipy.io import savemat

    jpgs = {f"jpg/image_{i:05d}.jpg": _png(
        RNG.integers(0, 256, (6, 6, 3), dtype=np.uint8), "JPEG")
        for i in range(1, 6)}
    _tar(str(tmp_path / "flowers.tgz"), jpgs)
    savemat(str(tmp_path / "labels.mat"),
            {"labels": np.array([[3, 1, 2, 5, 4]])})
    savemat(str(tmp_path / "setid.mat"),
            {"trnid": np.array([[1, 3, 5]]), "valid": np.array([[2]]),
             "tstid": np.array([[4]])})
    args = [str(tmp_path / n) for n in ("flowers.tgz", "labels.mat",
                                        "setid.mat")]
    for mode in ("train", "valid", "test"):
        _same_items(tds.Flowers(*args, mode=mode),
                    jds.Flowers(*args, mode=mode))
    voc = {"VOC/ImageSets/Segmentation/train.txt": b"a b\n",
           "VOC/JPEGImages/a.jpg": _png(IMG, "JPEG"),
           "VOC/JPEGImages/b.jpg": _png(IMG[:8], "JPEG"),
           "VOC/SegmentationClass/a.png": _png(IMG[..., 0]),
           "VOC/SegmentationClass/b.png": _png(IMG[:8, :, 1])}
    _tar(str(tmp_path / "voc.tgz"), voc)
    _same_items(tds.VOC2012(str(tmp_path / "voc.tgz")),
                jds.VOC2012(str(tmp_path / "voc.tgz")))
    for name in ("MNIST", "Cifar10", "Flowers", "VOC2012"):
        with pytest.raises(RuntimeError, match="download"):
            getattr(tds, name)(download=True)
