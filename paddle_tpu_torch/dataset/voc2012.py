"""Pascal VOC2012 segmentation readers — reference
python/paddle/dataset/voc2012.py: the VOCtrainval tar's
ImageSets/Segmentation/{train,val,trainval}.txt index files, JPEGImages
jpegs and SegmentationClass palette pngs, yielding (image ndarray,
label-mask ndarray) per sample.
"""
import io
import tarfile
import warnings

import numpy as np

from . import common

__all__ = ["train", "test", "val"]

VOC_URL = ("http://host.robots.ox.ac.uk/pascal/VOC/voc2012/"
           "VOCtrainval_11-May-2012.tar")
SET_FILE = "VOCdevkit/VOC2012/ImageSets/Segmentation/{}.txt"
DATA_FILE = "VOCdevkit/VOC2012/JPEGImages/{}.jpg"
LABEL_FILE = "VOCdevkit/VOC2012/SegmentationClass/{}.png"


def reader_creator(filename, sub_name):
    from PIL import Image

    def reader():
        with tarfile.open(filename) as tar:
            name2mem = {m.name: m for m in tar.getmembers()}
            sets = tar.extractfile(name2mem[SET_FILE.format(sub_name)])
            for line in sets:
                line = line.strip().decode()
                data = tar.extractfile(
                    name2mem[DATA_FILE.format(line)]).read()
                label = tar.extractfile(
                    name2mem[LABEL_FILE.format(line)]).read()
                # PIL keeps the palette png as class indices — exactly
                # the segmentation labels (cv2 would expand to RGB)
                yield (np.array(Image.open(io.BytesIO(data))),
                       np.array(Image.open(io.BytesIO(label))))

    return reader


def _make(sub_name):
    return reader_creator(common.download(VOC_URL, "voc2012"), sub_name)


def train():
    try:
        return _make("trainval")
    except common.DatasetNotDownloaded as e:
        warnings.warn(f"voc2012.train: {e}; synthetic fallback")
        from .synthetic import segmentation as syn
        return syn.train()


def test():
    try:
        return _make("train")
    except common.DatasetNotDownloaded as e:
        warnings.warn(f"voc2012.test: {e}; synthetic fallback")
        from .synthetic import segmentation as syn
        return syn.test()


def val():
    try:
        return _make("val")
    except common.DatasetNotDownloaded as e:
        warnings.warn(f"voc2012.val: {e}; synthetic fallback")
        from .synthetic import segmentation as syn
        return syn.val()
