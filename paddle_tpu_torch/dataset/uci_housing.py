"""UCI housing readers (reference python/paddle/dataset/uci_housing.py:69
load_data — same whitespace-separated 14-column numeric file, features
normalized by (x - avg) / (max - min), 80/20 train/test split)."""
import warnings

import numpy as np

from . import common

__all__ = ["train", "test", "load_data", "feature_names"]

URL = ("https://archive.ics.uci.edu/ml/machine-learning-databases/"
       "housing/housing.data")

feature_names = ["CRIM", "ZN", "INDUS", "CHAS", "NOX", "RM", "AGE",
                 "DIS", "RAD", "TAX", "PTRATIO", "B", "LSTAT"]


def load_data(filename, feature_num=14, ratio=0.8):
    """Parses the raw file exactly like the reference: flat
    whitespace-separated floats reshaped to rows of ``feature_num``,
    first 13 columns normalized, last column the target."""
    data = np.fromfile(filename, sep=" ")
    data = data.reshape(data.shape[0] // feature_num, feature_num)
    maximums = data.max(axis=0)
    minimums = data.min(axis=0)
    avgs = data.sum(axis=0) / data.shape[0]
    for i in range(feature_num - 1):
        data[:, i] = (data[:, i] - avgs[i]) / (maximums[i] - minimums[i])
    offset = int(data.shape[0] * ratio)
    return data[:offset].copy(), data[offset:].copy()


def _reader(rows):
    def reader():
        for row in rows:
            yield (row[:-1].astype(np.float32),
                   row[-1:].astype(np.float32))
    return reader


def train():
    try:
        tr, _ = load_data(common.download(URL, "uci_housing"))
        return _reader(tr)
    except common.DatasetNotDownloaded as e:
        warnings.warn(f"uci_housing.train: {e}; synthetic fallback")
        from .synthetic import uci_housing as syn
        return syn.train()


def test():
    try:
        _, te = load_data(common.download(URL, "uci_housing"))
        return _reader(te)
    except common.DatasetNotDownloaded as e:
        warnings.warn(f"uci_housing.test: {e}; synthetic fallback")
        from .synthetic import uci_housing as syn
        return syn.test()
