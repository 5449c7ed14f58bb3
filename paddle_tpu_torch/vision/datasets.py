"""``paddle.vision.datasets`` of the port (counterpart of
``paddle_tpu/vision/datasets.py``): ``MNIST``, ``FashionMNIST``,
``Cifar10``/``Cifar100``, ``DatasetFolder``, ``ImageFolder``,
``Flowers`` and ``VOC2012``.

They read local files only, in the formats the reference downloads (IDX,
the cifar pickles, the Flowers and VOC archives), and raise
``FileNotFoundError`` naming the file when it is absent; nothing is
downloaded. Samples are numpy arrays (or PIL images where the files are
images; Pillow is imported only there), as in the JAX module.
"""
from __future__ import annotations

import gzip
import os
import pickle
import struct
import tarfile

import numpy as np

from ..io import Dataset

__all__ = ["MNIST", "FashionMNIST", "Cifar10", "Cifar100", "DatasetFolder",
           "ImageFolder", "Flowers", "VOC2012"]


class MNIST(Dataset):
    """IDX-format MNIST (reference mnist.py MNIST).

    mode: train|test; image_path/label_path point at the (optionally
    .gz-compressed) ubyte files.
    """

    NAME = "mnist"

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=True, backend=None):
        self.mode = mode
        self.transform = transform
        if image_path is None or label_path is None:
            base = os.environ.get(
                "PADDLE_TPU_DATA_HOME",
                os.path.expanduser("~/.cache/paddle_tpu/datasets"))
            tag = "train" if mode == "train" else "t10k"
            image_path = image_path or os.path.join(
                base, self.NAME, f"{tag}-images-idx3-ubyte.gz")
            label_path = label_path or os.path.join(
                base, self.NAME, f"{tag}-labels-idx1-ubyte.gz")
        for p in (image_path, label_path):
            if not os.path.exists(p):
                raise FileNotFoundError(
                    f"{self.NAME}: {p} not found. Nothing is downloaded: "
                    f"place the IDX files there (same files the reference "
                    f"downloads) or pass image_path/label_path.")
        self.images = self._read_images(image_path)
        self.labels = self._read_labels(label_path)

    @staticmethod
    def _open(path):
        return gzip.open(path, "rb") if path.endswith(".gz") else open(
            path, "rb")

    def _read_images(self, path):
        with self._open(path) as f:
            magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
            if magic != 2051:
                raise ValueError(f"bad IDX image magic {magic}")
            data = np.frombuffer(f.read(n * rows * cols), dtype=np.uint8)
        return data.reshape(n, rows, cols)

    def _read_labels(self, path):
        with self._open(path) as f:
            magic, n = struct.unpack(">II", f.read(8))
            if magic != 2049:
                raise ValueError(f"bad IDX label magic {magic}")
            return np.frombuffer(f.read(n), dtype=np.uint8)

    def __getitem__(self, idx):
        img = self.images[idx]
        lbl = int(self.labels[idx])
        if self.transform is not None:
            img = self.transform(img)
        return img, np.asarray(lbl, dtype=np.int64)

    def __len__(self):
        return self.images.shape[0]


class FashionMNIST(MNIST):
    """Same IDX layout, different archive (reference mnist.py FashionMNIST)."""

    NAME = "fashion-mnist"


class Cifar10(Dataset):
    """CIFAR-10 python-pickle archive (reference cifar.py Cifar10)."""

    _batches_train = [f"data_batch_{i}" for i in range(1, 6)]
    _batches_test = ["test_batch"]
    _prefix = "cifar-10-batches-py"

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend=None):
        self.transform = transform
        if data_file is None:
            base = os.environ.get(
                "PADDLE_TPU_DATA_HOME",
                os.path.expanduser("~/.cache/paddle_tpu/datasets"))
            data_file = os.path.join(base, "cifar-10-python.tar.gz")
        if not os.path.exists(data_file):
            raise FileNotFoundError(
                f"cifar: {data_file} not found (nothing is downloaded; "
                f"provide the same tar.gz the reference downloads)")
        names = (self._batches_train if mode == "train"
                 else self._batches_test)
        images, labels = [], []
        with tarfile.open(data_file, "r:*") as tf:
            for name in names:
                member = tf.getmember(f"{self._prefix}/{name}")
                with tf.extractfile(member) as f:
                    batch = pickle.load(f, encoding="bytes")
                images.append(np.asarray(batch[b"data"], dtype=np.uint8))
                key = b"labels" if b"labels" in batch else b"fine_labels"
                labels.extend(batch[key])
        self.images = np.concatenate(images).reshape(-1, 3, 32, 32)
        self.labels = np.asarray(labels, dtype=np.int64)

    def __getitem__(self, idx):
        img = self.images[idx].transpose(1, 2, 0)  # HWC for transforms
        if self.transform is not None:
            img = self.transform(img)
        return img, self.labels[idx]

    def __len__(self):
        return self.images.shape[0]


class Cifar100(Cifar10):
    _batches_train = ["train"]
    _batches_test = ["test"]
    _prefix = "cifar-100-python"

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend=None):
        if data_file is None:
            base = os.environ.get(
                "PADDLE_TPU_DATA_HOME",
                os.path.expanduser("~/.cache/paddle_tpu/datasets"))
            data_file = os.path.join(base, "cifar-100-python.tar.gz")
        super().__init__(data_file, mode, transform, download, backend)


_IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".gif", ".webp")


class DatasetFolder(Dataset):
    """class-per-subdirectory image tree (reference folder.py DatasetFolder)."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.transform = transform
        self.loader = loader or self._pil_loader
        extensions = extensions or _IMG_EXTS
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        if not classes:
            raise ValueError(f"no class folders under {root}")
        self.classes = classes
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = []
        for c in classes:
            cdir = os.path.join(root, c)
            for dirpath, _, files in sorted(os.walk(cdir)):
                for fname in sorted(files):
                    path = os.path.join(dirpath, fname)
                    ok = (is_valid_file(path) if is_valid_file
                          else fname.lower().endswith(tuple(extensions)))
                    if ok:
                        self.samples.append((path, self.class_to_idx[c]))
        if not self.samples:
            raise ValueError(f"no images found under {root}")

    @staticmethod
    def _pil_loader(path):
        from PIL import Image
        with open(path, "rb") as f:
            return Image.open(f).convert("RGB")

    def __getitem__(self, idx):
        path, target = self.samples[idx]
        img = self.loader(path)
        if self.transform is not None:
            img = self.transform(img)
        return img, np.asarray(target, dtype=np.int64)

    def __len__(self):
        return len(self.samples)


class ImageFolder(Dataset):
    """Flat/recursive image list without labels (reference folder.py
    ImageFolder)."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.transform = transform
        self.loader = loader or DatasetFolder._pil_loader
        extensions = extensions or _IMG_EXTS
        self.samples = []
        for dirpath, _, files in sorted(os.walk(root)):
            for fname in sorted(files):
                path = os.path.join(dirpath, fname)
                ok = (is_valid_file(path) if is_valid_file
                      else fname.lower().endswith(tuple(extensions)))
                if ok:
                    self.samples.append(path)
        if not self.samples:
            raise ValueError(f"no images found under {root}")

    def __getitem__(self, idx):
        img = self.loader(self.samples[idx])
        if self.transform is not None:
            img = self.transform(img)
        return [img]

    def __len__(self):
        return len(self.samples)


class Flowers(Dataset):
    """Flowers102 (reference flowers.py Flowers): 102flowers.tgz image
    archive + imagelabels.mat + setid.mat subset indices. Like the
    reference, the tgz is extracted to a sibling directory once — gzip
    tars have no cheap random access, and per-file reads are
    fork-worker-safe."""

    _SPLIT_KEY = {"train": "trnid", "valid": "valid", "test": "tstid"}

    def __init__(self, data_file=None, label_file=None, setid_file=None,
                 mode="train", transform=None, download=True, backend=None):
        if mode not in self._SPLIT_KEY:
            raise ValueError(f"mode must be train|valid|test, got {mode!r}")
        for p, what in ((data_file, "Flowers images (102flowers.tgz)"),
                        (label_file, "Flowers labels (imagelabels.mat)"),
                        (setid_file, "Flowers splits (setid.mat)")):
            if p is None or not os.path.exists(p):
                raise FileNotFoundError(
                    f"{what}: {p!r} not found (nothing is downloaded; "
                    f"provide the reference archives)")
        from scipy.io import loadmat
        self.transform = transform
        self.labels = loadmat(label_file)["labels"].ravel()
        self.indexes = loadmat(setid_file)[
            self._SPLIT_KEY[mode]].ravel()
        # reference behavior: one-time extractall next to the archive
        self.data_path = data_file + ".extracted"
        marker = os.path.join(self.data_path, ".complete")
        if not os.path.exists(marker):
            os.makedirs(self.data_path, exist_ok=True)
            with tarfile.open(data_file) as tar:
                tar.extractall(self.data_path)
            open(marker, "w").close()

    def __getitem__(self, idx):
        from PIL import Image
        index = int(self.indexes[idx])
        label = np.array([int(self.labels[index - 1])], np.int64)
        path = os.path.join(self.data_path, "jpg",
                            "image_%05d.jpg" % index)
        image = Image.open(path).convert("RGB")
        if self.transform is not None:
            image = self.transform(image)
        return image, label

    def __len__(self):
        return len(self.indexes)


class VOC2012(Dataset):
    """VOC2012 segmentation (reference voc2012.py VOC2012): reads
    JPEGImages + SegmentationClass pairs for the split listed under
    ImageSets/Segmentation/{mode}.txt, straight from the tar."""

    SET_FILE = "VOCdevkit/VOC2012/ImageSets/Segmentation/{}.txt"
    DATA_FILE = "VOCdevkit/VOC2012/JPEGImages/{}.jpg"
    LABEL_FILE = "VOCdevkit/VOC2012/SegmentationClass/{}.png"
    # reference MODE_FLAG_MAP (voc2012.py): the VOCtrainval archive has no
    # held-out test listing, so 'train' reads trainval and 'test' train
    MODE_FLAG_MAP = {"train": "trainval", "test": "train", "valid": "val"}

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend=None):
        if mode not in self.MODE_FLAG_MAP:
            raise ValueError(
                f"mode must be train|valid|test, got {mode!r}")
        if data_file is None or not os.path.exists(data_file):
            raise FileNotFoundError(
                f"VOC2012: {data_file!r} not found (nothing is downloaded; "
                f"provide the reference VOCtrainval archive)")
        self.transform = transform
        self._data_file = data_file
        self._pid = os.getpid()
        self._tar = tarfile.open(data_file)
        self.name2mem = {m.name: m for m in self._tar.getmembers()}
        listing = self._tar.extractfile(self.name2mem[
            self.SET_FILE.format(self.MODE_FLAG_MAP[mode])]).read().decode()
        self.ids = [l.strip() for l in listing.splitlines() if l.strip()]

    def _tarfile(self):
        # forked DataLoader workers share the parent's fd offset; each
        # process must own its handle
        if os.getpid() != self._pid:
            self._tar = tarfile.open(self._data_file)
            self.name2mem = {m.name: m for m in self._tar.getmembers()}
            self._pid = os.getpid()
        return self._tar

    def __getitem__(self, idx):
        import io as _io

        from PIL import Image
        name = self.ids[idx]
        tar = self._tarfile()
        data = tar.extractfile(
            self.name2mem[self.DATA_FILE.format(name)]).read()
        label = tar.extractfile(
            self.name2mem[self.LABEL_FILE.format(name)]).read()
        image = Image.open(_io.BytesIO(data)).convert("RGB")
        seg = Image.open(_io.BytesIO(label))
        if self.transform is not None:
            image = self.transform(image)
        return image, np.asarray(seg, dtype=np.int64)

    def __len__(self):
        return len(self.ids)
