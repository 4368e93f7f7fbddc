"""Oxford 102 Flowers readers — reference
python/paddle/dataset/flowers.py: 102flowers.tgz of jpegs,
imagelabels.mat (1-based labels per image index), setid.mat with
trnid/valid/tstid splits; each sample is the jpeg decoded and run
through image.simple_transform to a 3x224x224 float32 CHW array.

NOTE the reference quirk kept for parity: ``train()`` reads the 'tstid'
split and ``test()`` reads 'trnid' (flowers.py:143,172 — the tstid set
is the large one, so it serves as training data).
"""
import tarfile
import warnings

from . import common
from . import image as img_mod

__all__ = ["train", "test", "valid"]

DATA_URL = "http://paddlemodels.cdn.bcebos.com/flowers/102flowers.tgz"
LABEL_URL = "http://paddlemodels.cdn.bcebos.com/flowers/imagelabels.mat"
SETID_URL = "http://paddlemodels.cdn.bcebos.com/flowers/setid.mat"


def default_mapper(is_train, sample):
    im, label = sample
    im = img_mod.simple_transform(img_mod.load_image_bytes(im), 256, 224,
                                  is_train)
    return im.astype("float32"), label


def reader_creator(data_file, label_file, setid_file, dataset_name,
                   mapper=None, buffered_size=1024, cycle=False):
    import scipy.io as scio
    labels = scio.loadmat(label_file)["labels"][0]
    indexes = scio.loadmat(setid_file)[dataset_name][0]
    img2label = {}
    for i in indexes:
        img = f"jpg/image_{i:05d}.jpg"
        img2label[img] = labels[i - 1]

    def reader():
        while True:
            with tarfile.open(data_file) as tf:
                for member in tf.getmembers():
                    if member.name not in img2label:
                        continue
                    data = tf.extractfile(member).read()
                    sample = (data, int(img2label[member.name]) - 1)
                    yield mapper(sample) if mapper else sample
            if not cycle:
                break

    return reader


def _make(dataset_name, is_train, mapper, buffered_size, cycle):
    if mapper is None:
        def mapper(sample, _t=is_train):
            return default_mapper(_t, sample)
    return reader_creator(
        common.download(DATA_URL, "flowers"),
        common.download(LABEL_URL, "flowers"),
        common.download(SETID_URL, "flowers"),
        dataset_name, mapper, buffered_size, cycle)


def train(mapper=None, buffered_size=1024, use_xmap=True, cycle=False):
    try:
        return _make("tstid", True, mapper, buffered_size, cycle)
    except common.DatasetNotDownloaded as e:
        warnings.warn(f"flowers.train: {e}; synthetic fallback")
        from .synthetic import images_labeled as syn
        return syn.train()


def test(mapper=None, buffered_size=1024, use_xmap=True, cycle=False):
    try:
        return _make("trnid", False, mapper, buffered_size, cycle)
    except common.DatasetNotDownloaded as e:
        warnings.warn(f"flowers.test: {e}; synthetic fallback")
        from .synthetic import images_labeled as syn
        return syn.test()


def valid(mapper=None, buffered_size=1024, use_xmap=True):
    try:
        return _make("valid", False, mapper, buffered_size, False)
    except common.DatasetNotDownloaded as e:
        warnings.warn(f"flowers.valid: {e}; synthetic fallback")
        from .synthetic import images_labeled as syn
        return syn.valid()
