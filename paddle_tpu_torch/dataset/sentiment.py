"""Movie-review sentiment readers — reference
python/paddle/dataset/sentiment.py (NLTK movie_reviews corpus):
frequency-sorted word dict over the whole corpus, neg/pos samples
interleaved for cross reading, ids from the dict.

The corpus is read as the standard movie_reviews layout —
``movie_reviews/{neg,pos}/*.txt`` — either from an extracted directory
or from the NLTK ``movie_reviews.zip`` under
DATA_HOME/sentiment/ (never downloaded: place it there; otherwise the
synthetic fallback serves shape-compatible samples).
"""
import collections
import os
import re
import warnings
import zipfile

from . import common

__all__ = ["train", "test", "get_word_dict"]

NUM_TRAINING_INSTANCES = 1600
_WORD_RE = re.compile(r"[A-Za-z']+|[.!?,;:]")


def _corpus_files():
    """Returns {relative_name: text} for every review file, sorted
    neg/pos interleaved like the reference's sort_files()."""
    root = os.path.join(common.DATA_HOME, "sentiment")
    texts = {}
    extracted = os.path.join(root, "movie_reviews")
    if os.path.isdir(extracted):
        for cat in ("neg", "pos"):
            d = os.path.join(extracted, cat)
            for fn in sorted(os.listdir(d)):
                with open(os.path.join(d, fn), "r",
                          errors="replace") as f:
                    texts[f"{cat}/{fn}"] = f.read()
    else:
        zpath = os.path.join(root, "movie_reviews.zip")
        if not os.path.exists(zpath):
            raise common.DatasetNotDownloaded(
                f"place the NLTK movie_reviews corpus at {extracted}/ "
                f"or {zpath}")
        with zipfile.ZipFile(zpath) as z:
            for name in sorted(z.namelist()):
                m = re.match(r".*movie_reviews/(neg|pos)/(.+\.txt)$", name)
                if m:
                    texts[f"{m.group(1)}/{m.group(2)}"] = \
                        z.read(name).decode("utf-8", "replace")
    neg = [k for k in sorted(texts) if k.startswith("neg/")]
    pos = [k for k in sorted(texts) if k.startswith("pos/")]
    inter = [f for pair in zip(neg, pos) for f in pair]
    return inter, texts


def _words(text):
    return [w.lower() for w in _WORD_RE.findall(text)]


_CACHE = {}          # DATA_HOME -> (word_dict_list, data)


def _load_corpus():
    """Parse the corpus ONCE per DATA_HOME (the reference holds it in
    module state too): tokenizes every file a single time, derives both
    the frequency-sorted dict and the id-encoded samples from it."""
    key = common.DATA_HOME
    if key in _CACHE:
        return _CACHE[key]
    files, texts = _corpus_files()
    tokenized = {name: _words(texts[name]) for name in files}
    freq = collections.defaultdict(int)
    for toks in tokenized.values():
        for w in toks:
            freq[w] += 1
    ordered = sorted(freq.items(), key=lambda kv: (-kv[1], kv[0]))
    word_dict = [(w, i) for i, (w, _) in enumerate(ordered)]
    ids = dict(word_dict)
    data = [([ids[w] for w in tokenized[name]],
             0 if name.startswith("neg/") else 1) for name in files]
    _CACHE[key] = (word_dict, data)
    return _CACHE[key]


def get_word_dict():
    """[(word, id)] sorted by corpus frequency (reference
    sentiment.py:56)."""
    return _load_corpus()[0]


def _load_data():
    return _load_corpus()[1]


def train():
    try:
        data = _load_data()[:NUM_TRAINING_INSTANCES]
    except common.DatasetNotDownloaded as e:
        warnings.warn(f"sentiment.train: {e}; synthetic fallback")
        from .synthetic import sentiment as syn
        return syn.train()
    def reader():
        for words, label in data:
            yield words, label
    return reader


def test():
    try:
        data = _load_data()[NUM_TRAINING_INSTANCES:]
    except common.DatasetNotDownloaded as e:
        warnings.warn(f"sentiment.test: {e}; synthetic fallback")
        from .synthetic import sentiment as syn
        return syn.test()
    def reader():
        for words, label in data:
            yield words, label
    return reader
