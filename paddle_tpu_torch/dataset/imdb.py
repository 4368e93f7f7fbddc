"""IMDB sentiment readers (reference python/paddle/dataset/imdb.py:39
tokenize / build_dict / reader_creator — same aclImdb tar.gz layout,
same ad-hoc tokenization: strip newlines, drop punctuation, lowercase,
split; positive label 0, negative 1)."""
import re
import string
import tarfile
import warnings
from collections import defaultdict

from . import common

__all__ = ["build_dict", "word_dict", "train", "test", "tokenize"]

URL = "http://ai.stanford.edu/%7Eamaas/data/sentiment/aclImdb_v1.tar.gz"

_PUNCT_TABLE = bytes.maketrans(b"", b"")


def tokenize(pattern, tar_path=None):
    """Yields the token list of every tar member matching ``pattern``
    (sequential tar walk like the reference)."""
    tar_path = tar_path or common.download(URL, "imdb")
    with tarfile.open(tar_path) as tarf:
        tf = tarf.next()
        while tf is not None:
            if bool(pattern.match(tf.name)):
                yield (tarf.extractfile(tf).read()
                       .rstrip(b"\n\r")
                       .translate(None, string.punctuation.encode())
                       .lower().split())
            tf = tarf.next()


def build_dict(pattern, cutoff, tar_path=None):
    """Word → zero-based id, ordered by (-frequency, word), with
    '<unk>' appended — byte-for-byte the reference's dict."""
    word_freq = defaultdict(int)
    for doc in tokenize(pattern, tar_path):
        for word in doc:
            word_freq[word] += 1
    items = [x for x in word_freq.items() if x[1] > cutoff]
    dictionary = sorted(items, key=lambda x: (-x[1], x[0]))
    word_idx = {w: i for i, (w, _) in enumerate(dictionary)}
    word_idx[b"<unk>"] = len(word_idx)
    return word_idx


def reader_creator(pos_pattern, neg_pattern, word_idx, tar_path=None):
    unk = word_idx[b"<unk>"]
    ins = []
    for pattern, label in [(pos_pattern, 0), (neg_pattern, 1)]:
        for doc in tokenize(pattern, tar_path):
            ins.append(([word_idx.get(w, unk) for w in doc], label))

    def reader():
        yield from ins

    return reader


def word_dict(cutoff=150):
    try:
        return build_dict(
            re.compile(r"aclImdb/((train)|(test))/((pos)|(neg))/.*\.txt$"),
            cutoff)
    except common.DatasetNotDownloaded as e:
        warnings.warn(f"imdb.word_dict: {e}; synthetic vocabulary")
        from .synthetic import imdb as syn
        return syn.word_dict()


def train(word_idx):
    try:
        return reader_creator(
            re.compile(r"aclImdb/train/pos/.*\.txt$"),
            re.compile(r"aclImdb/train/neg/.*\.txt$"), word_idx)
    except common.DatasetNotDownloaded as e:
        warnings.warn(f"imdb.train: {e}; synthetic fallback")
        from .synthetic import imdb as syn
        return syn.train(word_idx)


def test(word_idx):
    try:
        return reader_creator(
            re.compile(r"aclImdb/test/pos/.*\.txt$"),
            re.compile(r"aclImdb/test/neg/.*\.txt$"), word_idx)
    except common.DatasetNotDownloaded as e:
        warnings.warn(f"imdb.test: {e}; synthetic fallback")
        from .synthetic import imdb as syn
        return syn.test(word_idx)
