"""WMT14 fr→en readers (reference python/paddle/dataset/wmt14.py:88
reader_creator — the same tarball of tab-separated parallel lines, the
same src/trg .30k dict files, <s>/<e>/<unk> specials, and the >80-token
filter)."""
import tarfile
import warnings

from . import common

__all__ = ["train", "test", "get_dict", "reader_creator"]

URL_TRAIN = ("http://paddlemodels.bj.bcebos.com/wmt/wmt14.tgz")

START = "<s>"
END = "<e>"
UNK = "<unk>"
UNK_IDX = 2


def _read_to_dict(tar_file, dict_size):
    def _load_dict(tarf, dict_name, size):
        out_dict = {}
        name = f"wmt14/{dict_name}"
        for member in tarf:
            if member.name.endswith(dict_name):
                name = member.name
                break
        for i, line in enumerate(tarf.extractfile(name)):
            if i >= size:
                break
            out_dict[line.strip().decode()] = i
        return out_dict

    with tarfile.open(tar_file, mode="r") as f:
        src_dict = _load_dict(f, "src.dict", dict_size)
    with tarfile.open(tar_file, mode="r") as f:
        trg_dict = _load_dict(f, "trg.dict", dict_size)
    return src_dict, trg_dict


def reader_creator(tar_file, file_name, dict_size):
    """Yields (src_ids, trg_ids, trg_next_ids) with <s>/<e> wrapping
    and the reference's >80-token filter."""

    def reader():
        src_dict, trg_dict = _read_to_dict(tar_file, dict_size)
        with tarfile.open(tar_file, mode="r") as f:
            names = [m.name for m in f if m.name.endswith(file_name)]
            for name in names:
                for line in f.extractfile(name):
                    line_split = line.strip().split(b"\t")
                    if len(line_split) != 2:
                        continue
                    src_words = line_split[0].decode().split()
                    src_ids = [src_dict.get(w, UNK_IDX)
                               for w in [START] + src_words + [END]]
                    trg_words = line_split[1].decode().split()
                    trg_ids = [trg_dict.get(w, UNK_IDX)
                               for w in trg_words]
                    if len(src_ids) > 80 or len(trg_ids) > 80:
                        continue
                    trg_ids_next = trg_ids + [trg_dict[END]]
                    trg_ids = [trg_dict[START]] + trg_ids
                    yield src_ids, trg_ids, trg_ids_next

    return reader


def train(dict_size):
    try:
        return reader_creator(common.download(URL_TRAIN, "wmt14"),
                              "train/train", dict_size)
    except common.DatasetNotDownloaded as e:
        warnings.warn(f"wmt14.train: {e}; synthetic fallback")
        from .synthetic import wmt_translation as syn
        return syn.train(dict_size)


def test(dict_size):
    try:
        return reader_creator(common.download(URL_TRAIN, "wmt14"),
                              "test/test", dict_size)
    except common.DatasetNotDownloaded as e:
        warnings.warn(f"wmt14.test: {e}; synthetic fallback")
        from .synthetic import wmt_translation as syn
        return syn.test(dict_size)


def get_dict(dict_size, reverse=False):
    tar_file = common.download(URL_TRAIN, "wmt14")
    src_dict, trg_dict = _read_to_dict(tar_file, dict_size)
    if reverse:
        src_dict = {v: k for k, v in src_dict.items()}
        trg_dict = {v: k for k, v in trg_dict.items()}
    return src_dict, trg_dict
