"""Vision datasets (counterpart of ``paddle_tpu/vision/datasets.py``;
parity: ``paddle.vision.datasets``): FakeData, MNIST, FashionMNIST,
Cifar10, Cifar100, DatasetFolder, ImageFolder, Flowers and VOC.

They read local files only, as in JAX: ``download=True`` (or no path)
raises. Samples are numpy arrays (HWC uint8 images, int64 labels), made
on the host for the ``DataLoader``'s workers; ``FakeData`` is a
deterministic synthetic stand-in, each sample drawn from its index.
"""

from __future__ import annotations

import gzip
import os
import pickle
import struct
import tarfile
from typing import Callable, Optional

import numpy as np

from ..io import Dataset

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".ppm", ".webp")


class FakeData(Dataset):
    """Deterministic synthetic image-classification dataset."""

    def __init__(self, num_samples=64, image_shape=(32, 32, 3),
                 num_classes=10, transform: Optional[Callable] = None):
        # default is HWC uint8 — the layout every transform expects
        self.num_samples = num_samples
        self.image_shape = tuple(image_shape)
        self.num_classes = num_classes
        self.transform = transform

    def __len__(self):
        return self.num_samples

    def __getitem__(self, idx):
        rng = np.random.default_rng(idx)
        img = rng.integers(
            0, 256, size=self.image_shape, dtype=np.uint8
        ).astype(np.uint8)
        label = int(rng.integers(0, self.num_classes))
        if self.transform is not None:
            img = self.transform(img)
        return img, np.int64(label)


def _no_download(name):
    raise RuntimeError(
        f"{name}: download is not available (the datasets read local "
        "files only); pass the path to the data files"
    )


class MNIST(Dataset):
    """MNIST from local idx/idx-gz files (parity: paddle.vision.datasets.MNIST).

    ``image_path``/``label_path`` point at the standard
    ``*-images-idx3-ubyte(.gz)`` / ``*-labels-idx1-ubyte(.gz)`` files.
    """

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=False, backend="cv2"):
        if image_path is None or label_path is None:
            _no_download("MNIST")
        self.transform = transform
        self.images = self._read_images(image_path)
        self.labels = self._read_labels(label_path)
        assert len(self.images) == len(self.labels)

    @staticmethod
    def _open(path):
        return gzip.open(path, "rb") if path.endswith(".gz") else open(path, "rb")

    def _read_images(self, path):
        with self._open(path) as f:
            magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
            assert magic == 2051, f"bad MNIST image magic {magic}"
            data = np.frombuffer(f.read(n * rows * cols), dtype=np.uint8)
        return data.reshape(n, rows, cols)

    def _read_labels(self, path):
        with self._open(path) as f:
            magic, n = struct.unpack(">II", f.read(8))
            assert magic == 2049, f"bad MNIST label magic {magic}"
            return np.frombuffer(f.read(n), dtype=np.uint8)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, np.int64(self.labels[idx])


class Cifar10(Dataset):
    """CIFAR-10 from the local ``cifar-10-python.tar.gz`` (parity:
    paddle.vision.datasets.Cifar10)."""

    _batches_train = [f"data_batch_{i}" for i in range(1, 6)]
    _batches_test = ["test_batch"]

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=False):
        if data_file is None:
            _no_download("Cifar10")
        names = self._batches_train if mode == "train" else self._batches_test
        images, labels = [], []
        with tarfile.open(data_file, "r:*") as tf:
            for member in tf.getmembers():
                base = os.path.basename(member.name)
                if base in names:
                    d = pickle.load(tf.extractfile(member), encoding="bytes")
                    images.append(
                        np.asarray(d[b"data"], dtype=np.uint8).reshape(
                            -1, 3, 32, 32
                        )
                    )
                    labels.extend(d.get(b"labels", d.get(b"fine_labels")))
        self.images = np.concatenate(images, axis=0)
        self.labels = np.asarray(labels, dtype=np.int64)
        self.transform = transform

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx):
        img = np.transpose(self.images[idx], (1, 2, 0))  # HWC for transforms
        if self.transform is not None:
            img = self.transform(img)
        return img, self.labels[idx]


class DatasetFolder(Dataset):
    """class-per-subdirectory layout (parity: paddle DatasetFolder)."""

    def __init__(self, root, loader=None, extensions=IMAGE_EXTS,
                 transform=None):
        classes = sorted(
            d for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d))
        )
        if not classes:
            raise ValueError(f"no class directories under {root}")
        self.classes = classes
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = []
        for c in classes:
            cdir = os.path.join(root, c)
            for dirpath, _, files in sorted(os.walk(cdir)):
                for fname in sorted(files):
                    if fname.lower().endswith(tuple(extensions)):
                        self.samples.append(
                            (os.path.join(dirpath, fname), self.class_to_idx[c])
                        )
        self.loader = loader or self._pil_loader
        self.transform = transform

    @staticmethod
    def _pil_loader(path):
        from PIL import Image

        with open(path, "rb") as f:
            return Image.open(f).convert("RGB")

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        path, label = self.samples[idx]
        img = self.loader(path)
        if self.transform is not None:
            img = self.transform(img)
        return img, np.int64(label)


class ImageFolder(DatasetFolder):
    """Unlabeled flat folder of images (parity: paddle ImageFolder)."""

    def __init__(self, root, loader=None, extensions=IMAGE_EXTS,
                 transform=None):
        self.samples = []
        for dirpath, _, files in sorted(os.walk(root)):
            for fname in sorted(files):
                if fname.lower().endswith(tuple(extensions)):
                    self.samples.append((os.path.join(dirpath, fname), -1))
        self.loader = loader or DatasetFolder._pil_loader
        self.transform = transform

    def __getitem__(self, idx):
        path, _ = self.samples[idx]
        img = self.loader(path)
        if self.transform is not None:
            img = self.transform(img)
        return (img,)


class FashionMNIST(MNIST):
    """Parity: paddle.vision.datasets.FashionMNIST — identical idx file
    format, different corpus."""


class Cifar100(Cifar10):
    """Parity: paddle.vision.datasets.Cifar100 — the
    ``cifar-100-python.tar.gz`` layout ('train'/'test' members,
    fine_labels)."""

    _batches_train = ["train"]
    _batches_test = ["test"]


class Flowers(Dataset):
    """Oxford-102 Flowers from local files (parity:
    paddle.vision.datasets.Flowers): ``data_file`` is the image tarball
    (jpg files), ``label_file`` the imagelabels .mat, ``setid_file``
    the split ids .mat."""

    _split_key = {"train": "trnid", "valid": "valid", "test": "tstid"}

    def __init__(self, data_file=None, label_file=None, setid_file=None,
                 mode="train", transform=None, download=False,
                 backend="cv2"):
        if data_file is None or label_file is None or setid_file is None:
            _no_download("Flowers")
        from scipy.io import loadmat

        labels = loadmat(label_file)["labels"][0]
        ids = loadmat(setid_file)[self._split_key[mode]][0]
        self.transform = transform
        self._records = []
        with tarfile.open(data_file, "r:*") as tf:
            by_name = {os.path.basename(m.name): m
                       for m in tf.getmembers() if m.isfile()}
            for i in ids:
                name = f"image_{int(i):05d}.jpg"
                if name in by_name:
                    data = tf.extractfile(by_name[name]).read()
                    self._records.append((data, int(labels[i - 1]) - 1))

    def __len__(self):
        return len(self._records)

    def __getitem__(self, idx):
        import io as _io

        from PIL import Image

        data, label = self._records[idx]
        img = np.asarray(Image.open(_io.BytesIO(data)).convert("RGB"))
        if self.transform is not None:
            img = self.transform(img)
        return img, np.int64(label)


class VOC2012(Dataset):
    """Pascal VOC2012 segmentation pairs from the local devkit tarball
    (parity: paddle.vision.datasets.VOC2012): yields (image, label
    mask) uint8 arrays per the split list."""

    _lists = {"train": "train.txt", "valid": "val.txt",
              "trainval": "trainval.txt", "test": "val.txt"}

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=False, backend="cv2"):
        if data_file is None:
            _no_download("VOC2012")
        self.transform = transform
        with tarfile.open(data_file, "r:*") as tf:
            members = {m.name: m for m in tf.getmembers() if m.isfile()}
            list_suffix = ("ImageSets/Segmentation/"
                           + self._lists[mode])
            list_name = next(
                (n for n in members if n.endswith(list_suffix)), None)
            if list_name is None:
                raise FileNotFoundError(list_suffix)
            # devkit root derived once -> O(1) member lookups per name
            root = list_name[: -len(list_suffix)]
            names = tf.extractfile(members[list_name]).read() \
                .decode().split()
            # store COMPRESSED bytes; decode per __getitem__ (the
            # trainval split is ~2.9k full-res pairs — eager decode
            # would cost multi-GB of resident uint8)
            self._records = []
            for n in names:
                img_m = members.get(f"{root}JPEGImages/{n}.jpg")
                seg_m = members.get(f"{root}SegmentationClass/{n}.png")
                if img_m is None or seg_m is None:
                    continue
                self._records.append(
                    (tf.extractfile(img_m).read(),
                     tf.extractfile(seg_m).read()))

    def __len__(self):
        return len(self._records)

    def __getitem__(self, idx):
        import io as _io

        from PIL import Image

        img_b, seg_b = self._records[idx]
        img = np.asarray(Image.open(_io.BytesIO(img_b)).convert("RGB"))
        seg = np.asarray(Image.open(_io.BytesIO(seg_b)))
        if self.transform is not None:
            img = self.transform(img)
        return img, seg
