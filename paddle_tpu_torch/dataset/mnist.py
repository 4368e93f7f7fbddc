"""MNIST idx-ubyte readers (reference python/paddle/dataset/mnist.py:42
reader_creator — same byte format: 16-byte image header / 8-byte label
header, 28x28 ubyte images scaled to [-1, 1], int labels)."""
import gzip
import struct
import warnings

import numpy as np

from . import common

__all__ = ["train", "test", "reader_creator"]

URL_PREFIX = "http://yann.lecun.com/exdb/mnist/"
TEST_IMAGE = "t10k-images-idx3-ubyte.gz"
TEST_LABEL = "t10k-labels-idx1-ubyte.gz"
TRAIN_IMAGE = "train-images-idx3-ubyte.gz"
TRAIN_LABEL = "train-labels-idx1-ubyte.gz"


def _open(path):
    return gzip.open(path, "rb") if path.endswith(".gz") else \
        open(path, "rb")


def reader_creator(image_filename, label_filename, buffer_size=100):
    """Parses the idx-ubyte pair byte-for-byte like the reference:
    image file = magic(4) count(4) rows(4) cols(4) then count*rows*cols
    ubytes; label file = magic(4) count(4) then count ubytes. Yields
    (pixels float32 [rows*cols] in [-1, 1], int label)."""

    def reader():
        with _open(image_filename) as img_f, _open(label_filename) as lab_f:
            img_magic, img_n, rows, cols = struct.unpack(
                ">IIII", img_f.read(16))
            lab_magic, lab_n = struct.unpack(">II", lab_f.read(8))
            if img_magic != 2051 or lab_magic != 2049:
                raise ValueError(
                    f"not an MNIST idx pair (magics {img_magic}, "
                    f"{lab_magic})")
            if img_n != lab_n:
                raise ValueError(
                    f"image/label counts differ: {img_n} vs {lab_n}")
            per = rows * cols
            remaining = img_n
            while remaining > 0:
                n = min(buffer_size, remaining)
                images = np.frombuffer(img_f.read(n * per),
                                       dtype=np.uint8)
                labels = np.frombuffer(lab_f.read(n), dtype=np.uint8)
                if images.size != n * per or labels.size != n:
                    break
                images = images.reshape(n, per).astype(np.float32)
                images = images / 255.0 * 2.0 - 1.0
                for i in range(n):
                    yield images[i, :], int(labels[i])
                remaining -= n

    return reader


def _fallback(split, reason):
    warnings.warn(f"mnist.{split}: {reason}; using the synthetic "
                  "shape-compatible dataset")
    from .synthetic import mnist as syn
    return syn.train() if split == "train" else syn.test()


def train():
    try:
        return reader_creator(
            common.download(URL_PREFIX + TRAIN_IMAGE, "mnist"),
            common.download(URL_PREFIX + TRAIN_LABEL, "mnist"), 100)
    except common.DatasetNotDownloaded as e:
        return _fallback("train", str(e).splitlines()[0])


def test():
    try:
        return reader_creator(
            common.download(URL_PREFIX + TEST_IMAGE, "mnist"),
            common.download(URL_PREFIX + TEST_LABEL, "mnist"), 100)
    except common.DatasetNotDownloaded as e:
        return _fallback("test", str(e).splitlines()[0])
