"""imikolov (Penn Treebank LM) readers — reference
python/paddle/dataset/imikolov.py:83 reader_creator: the same
simple-examples.tgz layout (./simple-examples/data/ptb.{train,valid}.txt),
min-frequency dict with <s>/<e>/<unk>, and the NGRAM / SEQ modes.
"""
import collections
import tarfile
import warnings

from . import common

__all__ = ["train", "test", "build_dict", "DataType"]

URL = "http://www.fit.vutbr.cz/~imikolov/rnnlm/simple-examples.tgz"
TRAIN_FILE = "./simple-examples/data/ptb.train.txt"
TEST_FILE = "./simple-examples/data/ptb.valid.txt"


class DataType:
    NGRAM = 1
    SEQ = 2


def _word_count(f, word_freq=None):
    if word_freq is None:
        word_freq = collections.defaultdict(int)
    for line in f:
        words = line.strip().split()
        for w in words:
            word_freq[w.decode() if isinstance(w, bytes) else w] += 1
        word_freq["<s>"] += 1
        word_freq["<e>"] += 1
    return word_freq


def build_dict(min_word_freq=50):
    """Word → id over the train set, frequency-sorted, words rarer than
    ``min_word_freq`` dropped; '<unk>' appended last (reference
    imikolov.py:53)."""
    tar_f = common.download(URL, "imikolov")
    with tarfile.open(tar_f) as tf:
        word_freq = _word_count(tf.extractfile(TRAIN_FILE))
    word_freq.pop("<unk>", None)
    word_freq = [x for x in word_freq.items() if x[1] > min_word_freq]
    word_freq_sorted = sorted(word_freq, key=lambda x: (-x[1], x[0]))
    words, _ = list(zip(*word_freq_sorted))
    word_idx = dict(list(zip(words, range(len(words)))))
    word_idx["<unk>"] = len(words)
    return word_idx


def reader_creator(filename, word_idx, n, data_type):
    def reader():
        with tarfile.open(common.download(URL, "imikolov")) as tf:
            f = tf.extractfile(filename)
            unk = word_idx["<unk>"]
            for line in f:
                line = line.decode() if isinstance(line, bytes) else line
                if DataType.NGRAM == data_type:
                    assert n > -1, "Invalid gram length"
                    toks = ["<s>"] + line.strip().split() + ["<e>"]
                    if len(toks) >= n:
                        ids = [word_idx.get(w, unk) for w in toks]
                        for i in range(n, len(ids) + 1):
                            yield tuple(ids[i - n:i])
                elif DataType.SEQ == data_type:
                    ids = [word_idx.get(w, unk)
                           for w in line.strip().split()]
                    src_seq = [word_idx["<s>"]] + ids
                    trg_seq = ids + [word_idx["<e>"]]
                    if n > 0 and len(src_seq) > n:
                        continue
                    yield src_seq, trg_seq
                else:
                    raise AssertionError("Unknown data type")

    return reader


def _synthetic(word_idx, n, data_type):
    from .synthetic import lm_ngrams as syn
    return syn(word_idx, n, data_type)


def train(word_idx, n, data_type=DataType.NGRAM):
    try:
        common.download(URL, "imikolov")
        return reader_creator(TRAIN_FILE, word_idx, n, data_type)
    except common.DatasetNotDownloaded as e:
        warnings.warn(f"imikolov.train: {e}; synthetic fallback")
        return _synthetic(word_idx, n, data_type)


def test(word_idx, n, data_type=DataType.NGRAM):
    try:
        common.download(URL, "imikolov")
        return reader_creator(TEST_FILE, word_idx, n, data_type)
    except common.DatasetNotDownloaded as e:
        warnings.warn(f"imikolov.test: {e}; synthetic fallback")
        return _synthetic(word_idx, n, data_type)
