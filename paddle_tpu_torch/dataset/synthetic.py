"""Synthetic dataset generators with reference-matching shapes.

Parity targets: python/paddle/dataset/{mnist, cifar, imdb, uci_housing,
movielens, wmt14, conll05}.py. Nothing downloads, so the
readers generate deterministic synthetic data with the exact shapes,
dtypes, and vocab/class ranges of the reference datasets — every model
and example trains against the same interface.
"""
import numpy as np

__all__ = ["mnist", "cifar10", "imdb", "uci_housing", "wmt_translation",
           "ctr", "lm_ngrams", "sentiment", "ranking", "images_labeled",
           "segmentation"]


def _rng(seed):
    return np.random.RandomState(seed)


class mnist:
    """28x28 grayscale digits, labels 0..9 (reference
    python/paddle/dataset/mnist.py). Images cluster by class so models
    can actually learn."""

    @staticmethod
    def _reader(n, seed):
        def reader():
            rng = _rng(seed)
            protos = rng.rand(10, 784).astype(np.float32)
            for _ in range(n):
                lab = int(rng.randint(0, 10))
                img = protos[lab] + rng.normal(0, 0.3, 784).astype(np.float32)
                yield img.astype(np.float32), lab
        return reader

    @staticmethod
    def train(n=1024):
        return mnist._reader(n, seed=7)

    @staticmethod
    def test(n=256):
        return mnist._reader(n, seed=11)


class cifar10:
    """3x32x32 color images, 10 classes (reference cifar.py)."""

    @staticmethod
    def _reader(n, seed):
        def reader():
            rng = _rng(seed)
            protos = rng.rand(10, 3 * 32 * 32).astype(np.float32)
            for _ in range(n):
                lab = int(rng.randint(0, 10))
                img = protos[lab] + rng.normal(0, 0.3, 3 * 32 * 32)
                yield img.astype(np.float32), lab
        return reader

    @staticmethod
    def train10(n=1024):
        return cifar10._reader(n, seed=13)

    @staticmethod
    def test10(n=256):
        return cifar10._reader(n, seed=17)


class imdb:
    """Variable-length word-id sequences, binary sentiment labels
    (reference imdb.py). Word ids cluster by label."""

    WORD_DICT_SIZE = 5148

    @staticmethod
    def word_dict():
        return {f"w{i}": i for i in range(imdb.WORD_DICT_SIZE)}

    @staticmethod
    def _reader(n, seed):
        def reader():
            rng = _rng(seed)
            half = imdb.WORD_DICT_SIZE // 2
            for _ in range(n):
                lab = int(rng.randint(0, 2))
                length = int(rng.randint(8, 64))
                lo = lab * half
                words = rng.randint(lo, lo + half, length).tolist()
                yield words, lab
        return reader

    @staticmethod
    def train(word_dict=None, n=512):
        return imdb._reader(n, seed=19)

    @staticmethod
    def test(word_dict=None, n=128):
        return imdb._reader(n, seed=23)


class uci_housing:
    """13 features → house price (reference uci_housing.py)."""

    @staticmethod
    def _reader(n, seed):
        def reader():
            rng = _rng(seed)
            w = rng.rand(13).astype(np.float32)
            for _ in range(n):
                x = rng.normal(0, 1, 13).astype(np.float32)
                y = float(x @ w + rng.normal(0, 0.1))
                yield x, np.asarray([y], np.float32)
        return reader

    @staticmethod
    def train(n=404):
        return uci_housing._reader(n, seed=29)

    @staticmethod
    def test(n=102):
        return uci_housing._reader(n, seed=31)


class wmt_translation:
    """(src_ids, trg_ids, trg_next_ids) triples, copy-ish task (reference
    wmt14.py/wmt16.py interface)."""

    @staticmethod
    def _reader(n, seed, dict_size):
        def reader():
            rng = _rng(seed)
            for _ in range(n):
                length = int(rng.randint(4, 16))
                src = rng.randint(2, dict_size, length).tolist()
                trg = [1] + src[:-1]           # <s> + shifted copy
                trg_next = src
                yield src, trg, trg_next
        return reader

    @staticmethod
    def train(dict_size=1000, n=512):
        return wmt_translation._reader(n, 37, dict_size)

    @staticmethod
    def test(dict_size=1000, n=128):
        return wmt_translation._reader(n, 41, dict_size)


def lm_ngrams(word_idx, n, data_type, n_samples=512, seed=67):
    """Synthetic PTB-style LM reader (imikolov interface): NGRAM mode
    yields n-tuples of word ids, SEQ mode yields (src_seq, trg_seq)."""
    vocab = max(len(word_idx), 4)

    def reader():
        rng = _rng(seed)
        for _ in range(n_samples):
            if data_type == 1:                             # NGRAM
                yield tuple(rng.randint(0, vocab, n).tolist())
            else:                                          # SEQ
                ln = int(rng.randint(3, 12))
                ids = rng.randint(0, vocab, ln).tolist()
                yield [0] + ids, ids + [1]
    return reader


class sentiment:
    """(word_ids, 0|1) movie-review samples (reference sentiment.py
    interface over the NLTK movie_reviews corpus)."""

    VOCAB = 2000

    @staticmethod
    def _reader(n, seed):
        def reader():
            rng = _rng(seed)
            half = sentiment.VOCAB // 2
            for _ in range(n):
                lab = int(rng.randint(0, 2))
                ln = int(rng.randint(8, 40))
                lo = lab * half
                yield rng.randint(lo, lo + half, ln).tolist(), lab
        return reader

    @staticmethod
    def train(n=400):
        return sentiment._reader(n, seed=71)

    @staticmethod
    def test(n=100):
        return sentiment._reader(n, seed=73)


class ranking:
    """LETOR-style (label, qid, 46-dim features) rows grouped by query
    (mq2007 interface)."""

    N_FEATURES = 46

    @staticmethod
    def _queries(n_queries, seed):
        rng = _rng(seed)
        for qid in range(n_queries):
            docs = int(rng.randint(4, 12))
            w = rng.rand(ranking.N_FEATURES)
            mu = ranking.N_FEATURES / 4.0       # mean of f @ w
            for _ in range(docs):
                f = rng.rand(ranking.N_FEATURES).astype(np.float32)
                # center and scale so relevance 0/1/2 each occur often
                # and stay feature-correlated (learnable ordering)
                rel = int(np.clip(round((float(f @ w) - mu) / 1.6 + 1),
                                  0, 2))
                yield rel, qid, f

    @staticmethod
    def train(n_queries=64):
        return lambda: ranking._queries(n_queries, seed=79)

    @staticmethod
    def test(n_queries=16):
        return lambda: ranking._queries(n_queries, seed=83)


class images_labeled:
    """(chw float32 image, label) pairs — flowers.py interface shape
    (3x224x224, 102 classes)."""

    @staticmethod
    def _reader(n, seed, classes=102, size=224):
        def reader():
            rng = _rng(seed)
            for _ in range(n):
                lab = int(rng.randint(0, classes))
                img = rng.rand(3, size, size).astype(np.float32)
                yield img, lab
        return reader

    @staticmethod
    def train(n=256):
        return images_labeled._reader(n, seed=89)

    @staticmethod
    def test(n=64):
        return images_labeled._reader(n, seed=97)

    valid = test


class segmentation:
    """(hwc uint8 image, hw uint8 mask) pairs — voc2012.py interface."""

    @staticmethod
    def _reader(n, seed, size=64, classes=21):
        def reader():
            rng = _rng(seed)
            for _ in range(n):
                img = rng.randint(0, 256, (size, size, 3), dtype=np.uint8)
                mask = rng.randint(0, classes, (size, size),
                                   dtype=np.uint8)
                yield img, mask
        return reader

    @staticmethod
    def train(n=64):
        return segmentation._reader(n, seed=101)

    @staticmethod
    def test(n=16):
        return segmentation._reader(n, seed=103)

    val = test


class ctr:
    """Sparse-id CTR samples: (dense_features, sparse_slots, click)
    for DeepFM / wide&deep (reference the Criteo pipeline shape:
    13 dense + 26 categorical slots)."""

    NUM_DENSE = 13
    NUM_SPARSE = 26
    SPARSE_DIM = 1000

    @staticmethod
    def _reader(n, seed):
        def reader():
            rng = _rng(seed)
            w_dense = rng.rand(ctr.NUM_DENSE) - 0.5
            w_sparse = rng.rand(ctr.NUM_SPARSE, ctr.SPARSE_DIM) - 0.5
            for _ in range(n):
                dense = rng.normal(0, 1, ctr.NUM_DENSE).astype(np.float32)
                sparse = rng.randint(0, ctr.SPARSE_DIM, ctr.NUM_SPARSE)
                logit = dense @ w_dense + sum(
                    w_sparse[i, sparse[i]] for i in range(ctr.NUM_SPARSE))
                click = int(logit + rng.normal(0, 0.3) > 0)
                yield (dense, sparse.astype(np.int64), click)
        return reader

    @staticmethod
    def train(n=1024):
        return ctr._reader(n, seed=43)

    @staticmethod
    def test(n=256):
        return ctr._reader(n, seed=47)


class conll05:
    """SRL tuples matching the reference conll05 reader layout:
    (words, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2, predicate, mark,
    labels) — 9 parallel sequences per sample."""

    WORD_DICT_LEN = 4000
    LABEL_DICT_LEN = 59
    PRED_DICT_LEN = 300

    @staticmethod
    def get_dict():
        wd = {f"w{i}": i for i in range(conll05.WORD_DICT_LEN)}
        vd = {f"v{i}": i for i in range(conll05.PRED_DICT_LEN)}
        ld = {f"l{i}": i for i in range(conll05.LABEL_DICT_LEN)}
        return wd, vd, ld

    @staticmethod
    def _reader(n, seed):
        def reader():
            rng = _rng(seed)
            for _ in range(n):
                ln = int(rng.randint(4, 20))
                words = rng.randint(0, conll05.WORD_DICT_LEN, ln)
                ctx = [rng.randint(0, conll05.WORD_DICT_LEN, ln)
                       for _ in range(5)]
                pred = [int(rng.randint(0, conll05.PRED_DICT_LEN))] * ln
                mark = rng.randint(0, 2, ln)
                labels = rng.randint(0, conll05.LABEL_DICT_LEN, ln)
                yield tuple([words.tolist()] + [c.tolist() for c in ctx]
                            + [pred, mark.tolist(), labels.tolist()])
        return reader

    @staticmethod
    def test(n=128):
        return conll05._reader(n, seed=53)

    train = test


class movielens:
    """(user_id, gender, age, job, movie_id, categories, title_words,
    [rating]) rows matching the reference movielens value() layout."""

    MAX_USER = 6040
    MAX_MOVIE = 3952
    N_CATEGORIES = 18
    TITLE_WORDS = 5000
    MAX_JOB = 20

    @staticmethod
    def _reader(n, seed):
        def reader():
            rng = _rng(seed)
            for _ in range(n):
                uid = int(rng.randint(1, movielens.MAX_USER + 1))
                mid = int(rng.randint(1, movielens.MAX_MOVIE + 1))
                cats = rng.randint(0, movielens.N_CATEGORIES,
                                   rng.randint(1, 4)).tolist()
                title = rng.randint(0, movielens.TITLE_WORDS,
                                    rng.randint(1, 6)).tolist()
                rating = float(rng.randint(1, 6)) * 2 - 5.0
                yield [uid, int(rng.randint(0, 2)),
                       int(rng.randint(0, 7)),
                       int(rng.randint(0, movielens.MAX_JOB + 1)),
                       mid, cats, title, [rating]]
        return reader

    @staticmethod
    def train(n=1024):
        return movielens._reader(n, seed=59)

    @staticmethod
    def test(n=256):
        return movielens._reader(n, seed=61)
