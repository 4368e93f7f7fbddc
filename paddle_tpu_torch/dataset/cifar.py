"""CIFAR-10/100 readers (reference python/paddle/dataset/cifar.py:49
reader_creator — the same cifar-python tar.gz of pickled batches with
b'data' + b'labels'/b'fine_labels', samples scaled to [0, 1])."""
import pickle
import tarfile
import warnings

import numpy as np

from . import common

__all__ = ["train10", "test10", "train100", "test100", "reader_creator"]

URL_PREFIX = "https://www.cs.toronto.edu/~kriz/"
CIFAR10_URL = URL_PREFIX + "cifar-10-python.tar.gz"
CIFAR100_URL = URL_PREFIX + "cifar-100-python.tar.gz"


def reader_creator(filename, sub_name):
    """Yields (pixels float32 [3072] in [0, 1], int label) from every
    member of the tar whose name contains ``sub_name`` — the reference
    byte format (pickled dict, bytes keys)."""

    def read_batch(batch):
        data = batch[b"data"]
        labels = batch.get(b"labels", batch.get(b"fine_labels"))
        assert labels is not None
        for sample, label in zip(data, labels):
            yield (np.asarray(sample, np.float32) / 255.0,
                   int(label))

    def reader():
        with tarfile.open(filename, mode="r") as f:
            names = [m.name for m in f if sub_name in m.name]
            for name in names:
                batch = pickle.load(f.extractfile(name),
                                    encoding="bytes")
                yield from read_batch(batch)

    return reader


def _fallback(split, reason):
    warnings.warn(f"cifar.{split}: {reason}; using the synthetic "
                  "shape-compatible dataset")
    from .synthetic import cifar10 as syn
    return syn.train10() if "train" in split else syn.test10()


def _make(url, sub_name, split):
    try:
        return reader_creator(
            common.download(url, "cifar"), sub_name)
    except common.DatasetNotDownloaded as e:
        return _fallback(split, str(e).splitlines()[0])


def train10():
    return _make(CIFAR10_URL, "data_batch", "train10")


def test10():
    return _make(CIFAR10_URL, "test_batch", "test10")


def train100():
    return _make(CIFAR100_URL, "train", "train100")


def test100():
    return _make(CIFAR100_URL, "test", "test100")
