"""WMT16 en↔de readers — reference python/paddle/dataset/wmt16.py:
the same wmt16.tar.gz layout (``wmt16/{train,val,test}`` of
tab-separated "en<TAB>de" lines), dictionaries built on the fly from
the train split (frequency-sorted, <s>/<e>/<unk> heading the file,
cached as DATA_HOME/wmt16/{lang}_{size}.dict), samples as
(src_ids, trg_ids, trg_next_ids) with <s>/<e> wrapping.
"""
import os
import tarfile
import warnings
from collections import defaultdict

from . import common

__all__ = ["train", "test", "validation", "get_dict"]

DATA_URL = "http://paddlemodels.bj.bcebos.com/wmt/wmt16.tar.gz"
TOTAL_EN_WORDS = 11250
TOTAL_DE_WORDS = 19220
START_MARK = "<s>"
END_MARK = "<e>"
UNK_MARK = "<unk>"


def _build_dict(tar_file, dict_size, save_path, lang):
    word_dict = defaultdict(int)
    col = 0 if lang == "en" else 1
    with tarfile.open(tar_file, mode="r") as f:
        for line in f.extractfile("wmt16/train"):
            line_split = line.strip().split(b"\t")
            if len(line_split) != 2:
                continue
            for w in line_split[col].split():
                word_dict[w.decode()] += 1
    with open(save_path, "w") as fout:
        fout.write(f"{START_MARK}\n{END_MARK}\n{UNK_MARK}\n")
        for idx, word in enumerate(
                sorted(word_dict.items(), key=lambda x: x[1],
                       reverse=True)):
            if idx + 3 == dict_size:
                break
            fout.write(word[0] + "\n")


def _load_dict(tar_file, dict_size, lang, reverse=False):
    dict_path = os.path.join(common.DATA_HOME, "wmt16",
                             f"{lang}_{dict_size}.dict")
    if not os.path.exists(dict_path) or (
            len(open(dict_path, "rb").readlines()) != dict_size):
        _build_dict(tar_file, dict_size, dict_path, lang)
    word_dict = {}
    with open(dict_path, "rb") as fdict:
        for idx, line in enumerate(fdict):
            if reverse:
                word_dict[idx] = line.strip().decode()
            else:
                word_dict[line.strip().decode()] = idx
    return word_dict


def _get_dict_size(src_dict_size, trg_dict_size, src_lang):
    src_dict_size = min(src_dict_size, TOTAL_EN_WORDS
                        if src_lang == "en" else TOTAL_DE_WORDS)
    trg_dict_size = min(trg_dict_size, TOTAL_DE_WORDS
                        if src_lang == "en" else TOTAL_EN_WORDS)
    return src_dict_size, trg_dict_size


def reader_creator(tar_file, file_name, src_dict_size, trg_dict_size,
                   src_lang):
    def reader():
        src_dict = _load_dict(tar_file, src_dict_size, src_lang)
        trg_dict = _load_dict(tar_file, trg_dict_size,
                              "de" if src_lang == "en" else "en")
        start_id = src_dict[START_MARK]
        end_id = src_dict[END_MARK]
        unk_id = src_dict[UNK_MARK]
        src_col = 0 if src_lang == "en" else 1
        trg_col = 1 - src_col
        with tarfile.open(tar_file, mode="r") as f:
            for line in f.extractfile(file_name):
                line_split = line.strip().split(b"\t")
                if len(line_split) != 2:
                    continue
                src_words = line_split[src_col].decode().split()
                src_ids = [start_id] + [src_dict.get(w, unk_id)
                                        for w in src_words] + [end_id]
                trg_words = line_split[trg_col].decode().split()
                trg_ids = [trg_dict.get(w, unk_id) for w in trg_words]
                trg_ids_next = trg_ids + [end_id]
                trg_ids = [start_id] + trg_ids
                yield src_ids, trg_ids, trg_ids_next

    return reader


def _check_lang(src_lang):
    if src_lang not in ("en", "de"):
        raise ValueError("An error language type. "
                         "Only support: en (English), de (Germany)")


def _make(file_name, src_dict_size, trg_dict_size, src_lang, split):
    _check_lang(src_lang)
    try:
        tar_file = common.download(DATA_URL, "wmt16")
    except common.DatasetNotDownloaded as e:
        warnings.warn(f"wmt16.{split}: {e}; synthetic fallback")
        from .synthetic import wmt_translation as syn
        return getattr(syn, "train" if split == "train" else "test")(
            min(src_dict_size, trg_dict_size))
    src_dict_size, trg_dict_size = _get_dict_size(
        src_dict_size, trg_dict_size, src_lang)
    return reader_creator(tar_file, file_name, src_dict_size,
                          trg_dict_size, src_lang)


def train(src_dict_size, trg_dict_size, src_lang="en"):
    return _make("wmt16/train", src_dict_size, trg_dict_size, src_lang,
                 "train")


def test(src_dict_size, trg_dict_size, src_lang="en"):
    return _make("wmt16/test", src_dict_size, trg_dict_size, src_lang,
                 "test")


def validation(src_dict_size, trg_dict_size, src_lang="en"):
    return _make("wmt16/val", src_dict_size, trg_dict_size, src_lang,
                 "validation")


def get_dict(lang, dict_size, reverse=False):
    """Word (or id when ``reverse``) dictionary for ``lang``, building
    it from the train split if not cached."""
    dict_size = min(dict_size, TOTAL_EN_WORDS if lang == "en"
                    else TOTAL_DE_WORDS)
    tar_file = common.download(DATA_URL, "wmt16")
    return _load_dict(tar_file, dict_size, lang, reverse)
