"""The port's ``vision.datasets`` against the JAX package's, over files
each test writes (numpy-seeded, in the formats the reference downloads):
MNIST and FashionMNIST (gzipped IDX), Cifar10 and Cifar100 (the pickled
tar.gz), DatasetFolder and ImageFolder (PNG trees and ``.npy`` files
with ``np.load``), Flowers (a tgz, ``imagelabels.mat``, ``setid.mat``)
and VOC2012 (the tar). Every sample of every split must be equal on both
sides (bitwise: no arithmetic happens), and the lengths, classes and
missing-file errors the same. A ``DataLoader`` with forked workers
batches a ``DatasetFolder`` through transforms as the JAX one does.
"""
import gzip
import os
import pickle
import random
import struct
import tarfile

import numpy as np
import pytest
from PIL import Image

import paddle_tpu as jp
import paddle_tpu.vision.datasets as JD
import paddle_tpu.vision.transforms as JT
import paddle_tpu_torch as tp
import paddle_tpu_torch.vision.datasets as TD
import paddle_tpu_torch.vision.transforms as TT


@pytest.fixture(autouse=True)
def _cpu():
    with tp.device_guard("cpu"):
        yield


def _np(x):
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


def _assert_same(jds, tds):
    assert len(tds) == len(jds)
    for i in range(len(jds)):
        js, ts = jds[i], tds[i]
        assert len(js) == len(ts)
        for a, b in zip(js, ts):
            a, b = _np(a), _np(b)
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(b, a)


def _write_idx(tmp, images, labels, tag):
    ip = os.path.join(tmp, f"{tag}-images-idx3-ubyte.gz")
    lp = os.path.join(tmp, f"{tag}-labels-idx1-ubyte.gz")
    n, r, c = images.shape
    with gzip.open(ip, "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, r, c))
        f.write(images.tobytes())
    with gzip.open(lp, "wb") as f:
        f.write(struct.pack(">II", 2049, n))
        f.write(labels.tobytes())
    return ip, lp


@pytest.mark.parametrize("cls", ["MNIST", "FashionMNIST"])
@pytest.mark.parametrize("mode", ["train", "test"])
def test_mnist(tmp_path, cls, mode):
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (9, 28, 28), dtype=np.uint8)
    labels = rng.randint(0, 10, 9).astype(np.uint8)
    ip, lp = _write_idx(str(tmp_path), images, labels, mode)
    j = getattr(JD, cls)(image_path=ip, label_path=lp, mode=mode)
    t = getattr(TD, cls)(image_path=ip, label_path=lp, mode=mode)
    _assert_same(j, t)
    # with a transform: the port's ToTensor gives a port Tensor
    t2 = getattr(TD, cls)(image_path=ip, label_path=lp, mode=mode,
                          transform=TT.ToTensor())
    j2 = getattr(JD, cls)(image_path=ip, label_path=lp, mode=mode,
                          transform=JT.ToTensor())
    np.testing.assert_allclose(_np(t2[4][0]), _np(j2[4][0]), rtol=1e-6)
    assert isinstance(t2[4][0], tp.Tensor)


def _cifar_tar(tmp_path, prefix, names, key):
    rng = np.random.RandomState(0)
    os.makedirs(tmp_path / prefix)
    for name in names:
        batch = {b"data": rng.randint(0, 256, (5, 3072), dtype=np.uint8),
                 key: rng.randint(0, 10, 5).tolist()}
        with open(tmp_path / prefix / name, "wb") as f:
            pickle.dump(batch, f)
    tar = tmp_path / f"{prefix}.tar.gz"
    with tarfile.open(tar, "w:gz") as tf:
        tf.add(tmp_path / prefix, arcname=prefix)
    return str(tar)


@pytest.mark.parametrize("mode", ["train", "test"])
def test_cifar10(tmp_path, mode):
    tar = _cifar_tar(tmp_path, "cifar-10-batches-py",
                     [f"data_batch_{i}" for i in range(1, 6)]
                     + ["test_batch"], b"labels")
    _assert_same(JD.Cifar10(tar, mode=mode), TD.Cifar10(tar, mode=mode))


@pytest.mark.parametrize("mode", ["train", "test"])
def test_cifar100(tmp_path, mode):
    tar = _cifar_tar(tmp_path, "cifar-100-python", ["train", "test"],
                     b"fine_labels")
    _assert_same(JD.Cifar100(tar, mode=mode), TD.Cifar100(tar, mode=mode))


def _png_tree(root):
    rng = np.random.RandomState(2)
    for cls in ("cat", "dog", "eel"):
        os.makedirs(root / cls / "sub")
        for i in range(3):
            arr = rng.randint(0, 256, (6, 7, 3), dtype=np.uint8)
            where = root / cls / ("sub" if i == 2 else "")
            Image.fromarray(arr).save(where / f"{i}.png")
        (root / cls / "notes.txt").write_text("skipped")


def test_dataset_folder_and_image_folder(tmp_path):
    _png_tree(tmp_path)
    j, t = JD.DatasetFolder(str(tmp_path)), TD.DatasetFolder(str(tmp_path))
    assert t.classes == j.classes and t.class_to_idx == j.class_to_idx
    assert [s[1] for s in t.samples] == [s[1] for s in j.samples]
    _assert_same(j, t)
    _assert_same(JD.ImageFolder(str(tmp_path)),
                 TD.ImageFolder(str(tmp_path)))
    only_sub = lambda p: os.sep + "sub" + os.sep in p   # noqa: E731
    _assert_same(JD.DatasetFolder(str(tmp_path), is_valid_file=only_sub),
                 TD.DatasetFolder(str(tmp_path), is_valid_file=only_sub))


def _npy_tree(root, n=24, size=20):
    rng = np.random.RandomState(4)
    for i in range(n):
        d = root / f"c{i % 3}"
        os.makedirs(d, exist_ok=True)
        np.save(d / f"{i}.npy", rng.randint(0, 256, (size, size, 3),
                                            dtype=np.uint8))


def test_dataset_folder_npy_with_transforms(tmp_path):
    """The chip phase's pipeline at a small size: .npy images through
    RandomCrop, RandomHorizontalFlip, Normalize (HWC) and Transpose."""
    _npy_tree(tmp_path)
    outs = []
    for D, M in ((JD, JT), (TD, TT)):
        tr = M.Compose([M.RandomCrop(16), M.RandomHorizontalFlip(),
                        M.Normalize(mean=[123.675, 116.28, 103.53],
                                    std=[58.395, 57.12, 57.375],
                                    data_format="HWC"), M.Transpose()])
        ds = D.DatasetFolder(str(tmp_path), loader=np.load,
                             extensions=(".npy",), transform=tr)
        random.seed(11)
        outs.append([ds[i] for i in range(len(ds))])
    for (xj, yj), (xt, yt) in zip(*outs):
        np.testing.assert_array_equal(xt, xj)
        assert xt.shape == (3, 16, 16) and int(yt) == int(yj)


def test_dataset_folder_through_forked_loader(tmp_path):
    """Two forked workers, batches of 4, against the JAX DataLoader over
    the same dataset (deterministic transforms: neither package reseeds
    ``random`` in a worker)."""
    _npy_tree(tmp_path)
    batches = []
    for pkg, D, M in ((jp, JD, JT), (tp, TD, TT)):
        tr = M.Compose([M.CenterCrop(16), M.Transpose()])
        ds = D.DatasetFolder(str(tmp_path), loader=np.load,
                             extensions=(".npy",), transform=tr)
        loader = pkg.io.DataLoader(ds, batch_size=4, num_workers=2)
        batches.append([(_np(x), _np(y)) for x, y in loader])
    assert len(batches[0]) == len(batches[1]) == 6
    for (xj, yj), (xt, yt) in zip(*batches):
        np.testing.assert_array_equal(xt, xj)
        np.testing.assert_array_equal(yt.astype(np.int64),
                                      yj.astype(np.int64))


def test_flowers(tmp_path):
    from scipy.io import savemat
    rng = np.random.RandomState(5)
    jpg_dir = tmp_path / "jpg"
    os.makedirs(jpg_dir)
    for i in range(1, 6):
        Image.fromarray(rng.randint(0, 256, (6, 8, 3), dtype=np.uint8)).save(
            jpg_dir / ("image_%05d.jpg" % i))
    data = tmp_path / "102flowers.tgz"
    with tarfile.open(data, "w:gz") as tf:
        tf.add(jpg_dir, arcname="jpg")
    savemat(tmp_path / "imagelabels.mat",
            {"labels": np.array([[3, 1, 4, 1, 5]])})
    savemat(tmp_path / "setid.mat",
            {"trnid": np.array([[1, 3, 5]]), "valid": np.array([[2]]),
             "tstid": np.array([[4]])})
    args = (str(data), str(tmp_path / "imagelabels.mat"),
            str(tmp_path / "setid.mat"))
    for mode in ("train", "valid", "test"):
        _assert_same(JD.Flowers(*args, mode=mode),
                     TD.Flowers(*args, mode=mode))
    with pytest.raises(ValueError):
        TD.Flowers(*args, mode="all")


def test_voc2012(tmp_path):
    rng = np.random.RandomState(6)
    root = tmp_path / "VOCdevkit" / "VOC2012"
    for d in ("JPEGImages", "SegmentationClass",
              os.path.join("ImageSets", "Segmentation")):
        os.makedirs(root / d)
    names = ["2007_000032", "2007_000033", "2007_000039"]
    for n in names:
        Image.fromarray(rng.randint(0, 256, (5, 7, 3), dtype=np.uint8)).save(
            root / "JPEGImages" / f"{n}.jpg")
        Image.fromarray(rng.randint(0, 21, (5, 7), dtype=np.uint8)).save(
            root / "SegmentationClass" / f"{n}.png")
    seg = root / "ImageSets" / "Segmentation"
    (seg / "trainval.txt").write_text("\n".join(names))
    (seg / "train.txt").write_text("\n".join(names[:2]))
    (seg / "val.txt").write_text(names[2])
    tar = tmp_path / "voc.tar"
    with tarfile.open(tar, "w") as tf:
        tf.add(tmp_path / "VOCdevkit", arcname="VOCdevkit")
    for mode in ("train", "test", "valid"):
        _assert_same(JD.VOC2012(str(tar), mode=mode),
                     TD.VOC2012(str(tar), mode=mode))


def test_missing_files_raise(tmp_path):
    missing = str(tmp_path / "nope")
    for D in (JD, TD):
        with pytest.raises(FileNotFoundError):
            D.MNIST(image_path=missing + ".gz", label_path=missing + "2.gz")
        with pytest.raises(FileNotFoundError):
            D.Cifar10(missing + ".tar.gz")
        with pytest.raises(FileNotFoundError):
            D.Flowers(missing, missing, missing)
        with pytest.raises(FileNotFoundError):
            D.VOC2012(missing + ".tar")
    os.makedirs(tmp_path / "empty")
    for D in (JD, TD):
        with pytest.raises(ValueError):
            D.DatasetFolder(str(tmp_path / "empty"))
