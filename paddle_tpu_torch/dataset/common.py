"""Dataset file management (reference python/paddle/dataset/common.py).

The reference downloads archives into ~/.cache/paddle/dataset/<module>.
This package never downloads, so ``download`` RESOLVES rather than
fetches: it returns the cached path when the file is already present
(placed by the user or a mirror job) and otherwise raises with the
exact path + URL so the caller can fall back to the synthetic dataset.
"""
import hashlib
import os

__all__ = ["DATA_HOME", "download", "md5file"]

DATA_HOME = os.environ.get(
    "PADDLE_TPU_DATA_HOME",
    os.path.join(os.path.expanduser("~"), ".cache", "paddle_tpu",
                 "dataset"))


class DatasetNotDownloaded(IOError):
    pass


def md5file(fname):
    h = hashlib.md5()
    with open(fname, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def download(url, module_name, md5sum=None, save_name=None):
    """Returns the local path for ``url``'s file under
    DATA_HOME/module_name, verifying md5 when given. Raises
    DatasetNotDownloaded when absent (this package never fetches —
    the reference would)."""
    dirname = os.path.join(DATA_HOME, module_name)
    filename = os.path.join(
        dirname, save_name if save_name else url.split("/")[-1])
    if os.path.exists(filename):
        if md5sum and md5file(filename) != md5sum:
            raise DatasetNotDownloaded(
                f"{filename} exists but its md5 does not match {md5sum}; "
                "delete it and re-place the correct file")
        return filename
    raise DatasetNotDownloaded(
        f"dataset file not found: {filename}\n"
        f"this package never downloads {url}; place the file there "
        "manually, or use the synthetic fallback "
        "(paddle_tpu_torch.dataset.synthetic)")
