"""Vision datasets, PyTorch port.

Counterpart of `paddle_tpu/vision/datasets/__init__.py`, whose code this
module copies: nothing is downloaded. `MNIST` reads local idx files when it
is given them; otherwise every dataset synthesizes its arrays from the
reference's `np.random.default_rng` seeds, so both packages hold the same
images and labels. `DatasetFolder` loads ``.npy`` files by default. Samples
are numpy arrays on the host; the data loader moves batches.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from ...io.dataset import Dataset

__all__ = ["MNIST", "FashionMNIST", "Cifar10", "Cifar100", "DatasetFolder",
           "ImageFolder"]


class MNIST(Dataset):
    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=False, backend=None):
        self.mode = mode
        self.transform = transform
        if image_path and os.path.exists(image_path):
            with gzip.open(image_path, "rb") as f:
                magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
                self.images = np.frombuffer(f.read(), np.uint8) \
                    .reshape(n, rows, cols)
            with gzip.open(label_path, "rb") as f:
                f.read(8)
                self.labels = np.frombuffer(f.read(), np.uint8)
        else:
            # deterministic synthetic fallback (no network egress)
            rng = np.random.default_rng(0 if mode == "train" else 1)
            n = 1024 if mode == "train" else 256
            self.labels = rng.integers(0, 10, n).astype(np.int64)
            self.images = (rng.random((n, 28, 28)) * 255).astype(np.uint8)
            for i, l in enumerate(self.labels):
                self.images[i, :3, :3] = l * 25  # label-correlated patch

    def __getitem__(self, idx):
        img = self.images[idx].astype(np.float32)[None] / 255.0
        if self.transform is not None:
            img = self.transform(img)
        return img, np.asarray(self.labels[idx], np.int64)

    def __len__(self):
        return len(self.labels)


class FashionMNIST(MNIST):
    pass


class _Cifar(Dataset):
    NUM_CLASSES = 10

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=False, backend=None):
        self.transform = transform
        rng = np.random.default_rng(0 if mode == "train" else 1)
        n = 1024 if mode == "train" else 256
        self.labels = rng.integers(0, self.NUM_CLASSES, n).astype(np.int64)
        self.images = (rng.random((n, 3, 32, 32)) * 255).astype(np.uint8)

    def __getitem__(self, idx):
        img = self.images[idx].astype(np.float32) / 255.0
        if self.transform is not None:
            img = self.transform(img)
        return img, np.asarray(self.labels[idx], np.int64)

    def __len__(self):
        return len(self.labels)


class Cifar10(_Cifar):
    NUM_CLASSES = 10


class Cifar100(_Cifar):
    NUM_CLASSES = 100


class DatasetFolder(Dataset):
    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.transform = transform
        self.loader = loader or self._default_loader
        extensions = extensions or (".npy",)
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = []
        for c in classes:
            cdir = os.path.join(root, c)
            for fname in sorted(os.listdir(cdir)):
                if fname.lower().endswith(extensions):
                    self.samples.append((os.path.join(cdir, fname),
                                         self.class_to_idx[c]))

    @staticmethod
    def _default_loader(path):
        return np.load(path)

    def __getitem__(self, idx):
        path, target = self.samples[idx]
        sample = self.loader(path)
        if self.transform is not None:
            sample = self.transform(sample)
        return sample, target

    def __len__(self):
        return len(self.samples)


class ImageFolder(DatasetFolder):
    def __getitem__(self, idx):
        path, _ = self.samples[idx]
        sample = self.loader(path)
        if self.transform is not None:
            sample = self.transform(sample)
        return (sample,)


class Flowers(Dataset):
    """Flowers102 (reference: vision/datasets/flowers.py:40). Synthetic
    deterministic fallback (no egress): 102 classes, 64x64 RGB with a
    class-correlated hue patch; real .mat/.tgz loading requires the local
    cache the reference downloads."""

    NUM_CLASSES = 102

    def __init__(self, data_file=None, label_file=None, setid_file=None,
                 mode="train", transform=None, download=False, backend=None):
        self.mode = mode
        self.transform = transform
        rng = np.random.default_rng({"train": 0, "valid": 1,
                                     "test": 2}.get(mode, 0))
        n = {"train": 1020, "valid": 102, "test": 512}.get(mode, 256)
        n = min(n, 512)                 # synthetic: keep memory small
        self.labels = rng.integers(0, self.NUM_CLASSES, n).astype(np.int64)
        self.images = (rng.random((n, 3, 64, 64)) * 255).astype(np.uint8)
        for i, lab in enumerate(self.labels):
            self.images[i, 0, :4, :4] = int(lab * 2.5) % 256

    def __getitem__(self, idx):
        img = self.images[idx].astype(np.float32) / 255.0
        if self.transform is not None:
            img = self.transform(img)
        return img, np.asarray(self.labels[idx], np.int64)

    def __len__(self):
        return len(self.labels)


class VOC2012(Dataset):
    """VOC2012 segmentation (reference: vision/datasets/voc2012.py:38):
    yields (image, mask) with 21 classes (20 + background). Synthetic
    deterministic fallback: rectangle-instance masks."""

    NUM_CLASSES = 21

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=False, backend=None):
        self.mode = mode
        self.transform = transform
        rng = np.random.default_rng(0 if mode == "train" else 1)
        n = 256 if mode == "train" else 64
        self.images = (rng.random((n, 3, 64, 64)) * 255).astype(np.uint8)
        self.masks = np.zeros((n, 64, 64), np.int64)
        for i in range(n):
            cls = int(rng.integers(1, self.NUM_CLASSES))
            x0, y0 = rng.integers(0, 32, 2)
            w, h = rng.integers(8, 32, 2)
            self.masks[i, y0:y0 + h, x0:x0 + w] = cls

    def __getitem__(self, idx):
        img = self.images[idx].astype(np.float32) / 255.0
        if self.transform is not None:
            img = self.transform(img)
        return img, self.masks[idx]

    def __len__(self):
        return len(self.images)


__all__ += ["Flowers", "VOC2012"]
