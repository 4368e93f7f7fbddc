"""The port's ``dataset/`` (a copy of the reference's) against the JAX
package's: the cases of tests/test_datasets.py, tests/test_datasets2.py
and tests/test_io_reader.py's dataset case.

Each case writes a small fixture in the reference's exact file format
(idx-ubyte, the cifar pickle tar, aclImdb, the housing table, the
conll05 words/props pair, ml-1m, the wmt14/wmt16 tarballs, the PTB
text, the NLTK movie reviews, LETOR, flowers' jpegs and .mat files,
VOC's palette PNGs) under ``tmp_path``, asserts on the port what the
reference test asserts, and holds the port's samples equal to the
reference's read from the same files: the same structure, values and
dtypes (``_same``). Every reader with its files missing warns and falls
back to its synthetic generator, whose samples equal the reference's.
Nothing is downloaded: ``common.download`` only resolves local files.
"""
import gzip
import io
import itertools
import os
import pickle
import re
import struct
import tarfile
import warnings
import zipfile

import numpy as np
import pytest
import torch

import paddle_tpu.dataset as jds
import paddle_tpu_torch.dataset as tds

torch.set_num_threads(1)

PACKAGES = (jds, tds)


def _same(a, b, path="sample"):
    """Structural equality: containers element by element, arrays by
    shape, dtype and value, everything else by ``==``."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, \
            (path, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]")
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


def _both(fn):
    """``fn(dataset_package)`` in the reference, then in the port; the
    two results held equal; the port's returned."""
    want, got = fn(jds), fn(tds)
    _same(want, got)
    return got


@pytest.fixture
def data_home(tmp_path, monkeypatch):
    # every dataset module reads this one shared common module
    for ds in PACKAGES:
        monkeypatch.setattr(ds.common, "DATA_HOME", str(tmp_path))
        monkeypatch.setattr(ds.movielens, "MOVIE_INFO", None)
    return tmp_path


def _add_bytes(tar, name, data):
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tar.addfile(info, io.BytesIO(data))


def _jpeg_bytes(arr):
    import cv2
    ok, buf = cv2.imencode(".jpg", arr)
    assert ok
    return buf.tobytes()


# ------------------------------------------------------------ test_datasets
def _mnist_files(tmp_path, n=7, magic=2051):
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (n, 28, 28), dtype=np.uint8)
    labels = rng.randint(0, 10, (n,), dtype=np.uint8)
    img_path = str(tmp_path / "images-idx3-ubyte.gz")
    lab_path = str(tmp_path / "labels-idx1-ubyte.gz")
    with gzip.open(img_path, "wb") as f:
        f.write(struct.pack(">IIII", magic, n, 28, 28))
        f.write(images.tobytes())
    with gzip.open(lab_path, "wb") as f:
        f.write(struct.pack(">II", 2049, n))
        f.write(labels.tobytes())
    return img_path, lab_path, images, labels


def test_mnist_idx_ubyte(tmp_path):
    img_path, lab_path, images, labels = _mnist_files(tmp_path)
    got = _both(lambda ds: list(ds.mnist.reader_creator(
        img_path, lab_path, 3)()))
    assert len(got) == 7
    for i, (pix, lab) in enumerate(got):
        assert lab == int(labels[i])
        want = images[i].reshape(784).astype(np.float32) / 255 * 2 - 1
        np.testing.assert_allclose(pix, want, rtol=1e-6)


def test_mnist_rejects_bad_magic(tmp_path):
    img_path, lab_path, _, _ = _mnist_files(tmp_path, n=1, magic=9999)
    for ds in PACKAGES:
        with pytest.raises(ValueError, match="magic"):
            list(ds.mnist.reader_creator(img_path, lab_path)())


def test_cifar_pickle_tar(tmp_path):
    rng = np.random.RandomState(1)
    data = rng.randint(0, 256, (5, 3072), dtype=np.uint8)
    labels = rng.randint(0, 10, (5,)).tolist()
    path = str(tmp_path / "cifar-10-python.tar.gz")
    with tarfile.open(path, "w:gz") as tf:
        _add_bytes(tf, "cifar-10-batches-py/data_batch_1", pickle.dumps(
            {b"data": data, b"labels": labels}, protocol=2))
    got = _both(lambda ds: list(ds.cifar.reader_creator(
        path, "data_batch")()))
    assert len(got) == 5
    for i, (pix, lab) in enumerate(got):
        assert lab == labels[i]
        np.testing.assert_allclose(pix, data[i].astype(np.float32) / 255,
                                   rtol=1e-6)


def test_imdb_tar_tokenize_dict_and_reader(tmp_path):
    path = str(tmp_path / "aclImdb_v1.tar.gz")
    with tarfile.open(path, "w:gz") as tf:
        _add_bytes(tf, "aclImdb/train/pos/0_9.txt",
                   b"A GREAT great movie, truly great!")
        _add_bytes(tf, "aclImdb/train/neg/0_2.txt",
                   b"terrible movie; truly terrible.")
    pat = re.compile(r"aclImdb/train/((pos)|(neg))/.*\.txt$")
    toks = _both(lambda ds: list(ds.imdb.tokenize(pat, tar_path=path)))
    assert [b"a", b"great", b"great", b"movie", b"truly",
            b"great"] in toks
    d = _both(lambda ds: ds.imdb.build_dict(pat, cutoff=1, tar_path=path))
    assert (d[b"great"], d[b"movie"], d[b"terrible"], d[b"truly"],
            d[b"<unk>"]) == (0, 1, 2, 3, 4)
    samples = _both(lambda ds: list(ds.imdb.reader_creator(
        re.compile(r"aclImdb/train/pos/.*\.txt$"),
        re.compile(r"aclImdb/train/neg/.*\.txt$"), d, tar_path=path)()))
    assert len(samples) == 2
    assert samples[0][1] == 0 and samples[1][1] == 1   # pos=0, neg=1
    assert samples[0][0].count(d[b"great"]) == 3


def test_uci_housing_table(tmp_path):
    rows = np.random.RandomState(2).rand(10, 14) * 10
    path = str(tmp_path / "housing.data")
    with open(path, "w") as f:
        for r in rows:
            f.write(" ".join(f"{v:.6f}" for v in r) + "\n")
    tr, te = _both(lambda ds: ds.uci_housing.load_data(path, ratio=0.8))
    assert tr.shape == (8, 14) and te.shape == (2, 14)
    want0 = (rows[0, 0] - rows.mean(0)[0]) / (rows.max(0)[0]
                                              - rows.min(0)[0])
    assert abs(tr[0, 0] - want0) < 1e-5
    assert abs(tr[0, -1] - rows[0, -1]) < 1e-5     # target untouched


def test_conll05_props_to_iob(tmp_path):
    words = b"The cat sat on the mat\n".replace(b" ", b"\n") + b"\n"
    props = [b"-\t(A0*", b"-\t*)", b"sat\t(V*)", b"-\t(A1*", b"-\t*",
             b"-\t*)", b""]
    path = str(tmp_path / "conll05st-tests.tar.gz")
    bufs = []
    for payload in (words, b"\n".join(props) + b"\n"):
        buf = io.BytesIO()
        with gzip.GzipFile(fileobj=buf, mode="wb") as gz:
            gz.write(payload)
        bufs.append(buf.getvalue())
    with tarfile.open(path, "w:gz") as tf:
        _add_bytes(tf, "test.wsj/words/test.wsj.words.gz", bufs[0])
        _add_bytes(tf, "test.wsj/props/test.wsj.props.gz", bufs[1])
    got = _both(lambda ds: list(ds.conll05.corpus_reader(
        path, "test.wsj/words/test.wsj.words.gz",
        "test.wsj/props/test.wsj.props.gz")()))
    assert got == [(["The", "cat", "sat", "on", "the", "mat"], "sat",
                    ["B-A0", "I-A0", "B-V", "B-A1", "I-A1", "I-A1"])]


def test_conll05_reader_features():
    word_dict = {w: i for i, w in enumerate(
        ["The", "cat", "sat", "on", "the", "mat"])}
    label_dict = {"B-A0": 0, "I-A0": 1, "B-V": 2, "B-A1": 3, "I-A1": 4,
                  "O": 5}

    def corpus():
        yield (["The", "cat", "sat", "on", "the", "mat"], "sat",
               ["B-A0", "I-A0", "B-V", "B-A1", "I-A1", "I-A1"])

    got = _both(lambda ds: next(ds.conll05.reader_creator(
        corpus, word_dict, {"sat": 0}, label_dict)()))
    w, c_n2, c_n1, c_0, c_p1, c_p2, pred, mark, lab = got
    assert w == [0, 1, 2, 3, 4, 5] and c_0 == [2] * 6
    assert c_n1 == [1] * 6 and c_p1 == [3] * 6
    assert mark == [1, 1, 1, 1, 1, 0] and lab == [0, 1, 2, 3, 4, 4]


def test_movielens_zip(tmp_path):
    path = str(tmp_path / "ml-1m.zip")
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("ml-1m/movies.dat",
                   "1::Toy Story (1995)::Animation|Comedy\n"
                   "2::Heat (1995)::Action\n")
        z.writestr("ml-1m/users.dat",
                   "1::M::25::6::zip\n2::F::35::3::zip\n")
        z.writestr("ml-1m/ratings.dat", "1::1::5::97\n2::2::1::98\n")

    def read(ds):
        ds.movielens.MOVIE_INFO = None     # reset the module cache
        try:
            return list(ds.movielens._reader(test_ratio=0.0, is_test=False,
                                             fn=path))
        finally:
            ds.movielens.MOVIE_INFO = None

    got = _both(read)
    assert len(got) == 2
    uid, gender, age, job, mid, cats, title, rating = got[0]
    assert uid == 1 and gender == 0 and job == 6
    assert age == tds.movielens.age_table.index(25)
    assert mid == 1 and len(cats) == 2 and len(title) == 2
    assert rating == [5.0 * 2 - 5.0]


def test_wmt14_tarball(tmp_path):
    path = str(tmp_path / "wmt14.tgz")
    with tarfile.open(path, "w:gz") as tf:
        _add_bytes(tf, "wmt14/src.dict",
                   b"<s>\n<e>\n<unk>\nle\nchat\ndort\n")
        _add_bytes(tf, "wmt14/trg.dict",
                   b"<s>\n<e>\n<unk>\nthe\ncat\nsleeps\n")
        _add_bytes(tf, "wmt14/train/train", b"le chat dort\tthe cat sleeps\n"
                   + b"w " * 100 + b"\tlong line skipped\n")
    got = _both(lambda ds: list(ds.wmt14.reader_creator(
        path, "train/train", dict_size=6)()))
    assert got == [([0, 3, 4, 5, 1], [0, 3, 4, 5], [3, 4, 5, 1])]


def test_common_download_resolves_and_checks_md5(data_home):
    os.makedirs(data_home / "mod")
    p = data_home / "mod" / "file.bin"
    p.write_bytes(b"hello")
    common = tds.common
    assert common.download("http://x/file.bin", "mod") == str(p)
    assert common.md5file(str(p)) == "5d41402abc4b2a76b9719d911017c592"
    with pytest.raises(common.DatasetNotDownloaded):
        common.download("http://x/file.bin", "mod", md5sum="0" * 32)
    with pytest.raises(common.DatasetNotDownloaded, match="never downloads"):
        common.download("http://x/absent.bin", "mod")
    assert common.DATA_HOME == jds.common.DATA_HOME


# ----------------------------------------------------------- test_datasets2
def test_imikolov_ngram_and_seq(data_home):
    d = data_home / "imikolov"
    d.mkdir()
    with tarfile.open(d / "simple-examples.tgz", "w:gz") as tar:
        _add_bytes(tar, "./simple-examples/data/ptb.train.txt",
                   b"the cat sat on the mat\nthe dog sat\n")
        _add_bytes(tar, "./simple-examples/data/ptb.valid.txt",
                   b"a cat sat\n")
    word_idx = _both(lambda ds: ds.imikolov.build_dict(min_word_freq=1))
    assert {"<unk>", "the", "sat"} <= set(word_idx)
    grams = _both(lambda ds: list(ds.imikolov.train(word_idx, 3)()))
    assert all(len(g) == 3 for g in grams) and len(grams) == 6 + 3
    seqs = _both(lambda ds: list(ds.imikolov.test(
        word_idx, 0, ds.imikolov.DataType.SEQ)()))
    (src, trg), = seqs
    assert src[0] == word_idx["<s>"] and trg[-1] == word_idx["<e>"]
    assert src[1:] == trg[:-1]


def test_sentiment_zip_corpus(data_home):
    d = data_home / "sentiment"
    d.mkdir()
    with zipfile.ZipFile(d / "movie_reviews.zip", "w") as z:
        z.writestr("corpora/movie_reviews/neg/cv000_1.txt",
                   "terrible awful film")
        z.writestr("corpora/movie_reviews/neg/cv001_2.txt", "bad bad plot")
        z.writestr("corpora/movie_reviews/pos/cv000_3.txt",
                   "wonderful great film")
        z.writestr("corpora/movie_reviews/pos/cv001_4.txt", "great acting")
    wd = dict(_both(lambda ds: ds.sentiment.get_word_dict()))
    assert sorted([wd["bad"], wd["film"], wd["great"]]) == [0, 1, 2]
    samples = _both(lambda ds: list(ds.sentiment.train()()))
    assert [lab for _, lab in samples] == [0, 1, 0, 1]
    assert samples[0][0] == [wd["terrible"], wd["awful"], wd["film"]]


def test_mq2007_formats(data_home):
    d = data_home / "MQ2007" / "Fold1"
    d.mkdir(parents=True)
    rng = np.random.RandomState(0)
    lines = []
    for qid, rels in [(10, [2, 0, 1]), (11, [0, 0, 1])]:
        for j, rel in enumerate(rels):
            pairs = " ".join(f"{i + 1}:{v}"
                             for i, v in enumerate(rng.rand(46).round(6)))
            lines.append(f"{rel} qid:{qid} {pairs} #docid = D{qid}_{j}\n")
    (d / "train.txt").write_text("".join(lines))
    (d / "test.txt").write_text("".join(lines[:3]))
    points = _both(lambda ds: list(ds.mq2007.train(format="pointwise")()))
    assert len(points) == 6 and points[0][0] == 2
    assert points[0][1].shape == (46,)
    pairs = _both(lambda ds: list(ds.mq2007.train(format="pairwise")()))
    assert len(pairs) == 5
    assert [a.shape for a in pairs[0]] == [(1,), (46,), (46,)]
    (rels, feats), = _both(lambda ds: list(ds.mq2007.test(
        format="listwise")()))
    assert rels == sorted(rels, reverse=True) and feats.shape == (3, 46)


def test_wmt16_roundtrip(data_home):
    d = data_home / "wmt16"
    d.mkdir()
    test_l = b"the cat\tdie katze\n"
    with tarfile.open(d / "wmt16.tar.gz", "w:gz") as tar:
        _add_bytes(tar, "wmt16/train", b"a cat\teine katze\na dog\tein hund\n")
        _add_bytes(tar, "wmt16/val", test_l)
        _add_bytes(tar, "wmt16/test", test_l)
    samples = _both(lambda ds: list(ds.wmt16.train(50, 50)()))
    en = _both(lambda ds: ds.wmt16.get_dict("en", 50))
    de = _both(lambda ds: ds.wmt16.get_dict("de", 50))
    src, trg, trg_next = samples[0]
    assert len(samples) == 2 and src[1:-1] == [en["a"], en["cat"]]
    assert src[0] == en["<s>"] and src[-1] == en["<e>"]
    assert trg == [de["<s>"], de["eine"], de["katze"]]
    assert trg_next == [de["eine"], de["katze"], de["<e>"]]
    t = _both(lambda ds: list(ds.wmt16.test(50, 50)()))
    assert t[0][0][1] == en["<unk>"]                 # "the" unseen
    _both(lambda ds: list(ds.wmt16.validation(50, 50)()))


def test_image_transforms():
    im = np.random.RandomState(0).randint(0, 256, (80, 60, 3),
                                          dtype=np.uint8)
    r = _both(lambda ds: ds.image.resize_short(im, 30))
    assert min(r.shape[:2]) == 30 and r.shape[0] == 40
    c = _both(lambda ds: ds.image.center_crop(r, 24))
    assert c.shape == (24, 24, 3)
    f = _both(lambda ds: ds.image.left_right_flip(c))
    np.testing.assert_array_equal(f, c[:, ::-1, :])
    chw = _both(lambda ds: ds.image.simple_transform(
        im, 32, 24, is_train=False, mean=[1.0, 2.0, 3.0]))
    assert chw.shape == (3, 24, 24) and chw.dtype == np.float32
    decoded = _both(lambda ds: ds.image.load_image_bytes(_jpeg_bytes(im)))
    assert decoded.shape == im.shape


def test_flowers_reader(data_home):
    import scipy.io as scio
    d = data_home / "flowers"
    d.mkdir()
    rng = np.random.RandomState(0)
    with tarfile.open(d / "102flowers.tgz", "w:gz") as tar:
        for i in range(1, 5):
            img = rng.randint(0, 256, (40, 40, 3), dtype=np.uint8)
            _add_bytes(tar, f"jpg/image_{i:05d}.jpg", _jpeg_bytes(img))
    scio.savemat(str(d / "imagelabels.mat"),
                 {"labels": np.array([[5, 3, 5, 1]], dtype=np.uint8)})
    scio.savemat(str(d / "setid.mat"), {"tstid": np.array([[1, 3]]),
                                        "trnid": np.array([[2]]),
                                        "valid": np.array([[4]])})
    raw = _both(lambda ds: list(ds.flowers.train(mapper=lambda s: s)()))
    assert [lab for _, lab in raw] == [4, 4]          # 5 - 1 (0-based)
    # the default transform crops at random in train mode: its shapes,
    # and test mode's center crop value for value
    for ds in PACKAGES:
        im, lab = next(ds.flowers.train()())
        assert im.shape == (3, 224, 224) and im.dtype == np.float32
    _both(lambda ds: list(ds.flowers.test()()))
    va = _both(lambda ds: list(ds.flowers.valid(mapper=lambda s: s)()))
    assert [lab for _, lab in va] == [0]


def test_voc2012_reader(data_home):
    from PIL import Image
    d = data_home / "voc2012"
    d.mkdir()
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (30, 20, 3), dtype=np.uint8)
    mask = rng.randint(0, 21, (30, 20), dtype=np.uint8)
    pal = Image.fromarray(mask, mode="P")
    pal.putpalette([c for i in range(256) for c in (i, 0, 0)][:768])
    png = io.BytesIO()
    pal.save(png, format="PNG")
    seg = "VOCdevkit/VOC2012/ImageSets/Segmentation/"
    with tarfile.open(d / "VOCtrainval_11-May-2012.tar", "w") as tar:
        for split in ("train", "val", "trainval"):
            _add_bytes(tar, f"{seg}{split}.txt", b"2007_000001\n")
        _add_bytes(tar, "VOCdevkit/VOC2012/JPEGImages/2007_000001.jpg",
                   _jpeg_bytes(img))
        _add_bytes(tar, "VOCdevkit/VOC2012/SegmentationClass/"
                   "2007_000001.png", png.getvalue())
    (data, label), = _both(lambda ds: list(ds.voc2012.val()()))
    assert data.shape == (30, 20, 3)
    np.testing.assert_array_equal(label, mask)   # palette png = indices
    _both(lambda ds: list(ds.voc2012.train()()))
    _both(lambda ds: list(ds.voc2012.test()()))


# ------------------------------------------------------ synthetic fallbacks
def _imdb_dict(ds):
    vocab = ds.imdb.word_dict()
    return {**vocab, b"<unk>": len(vocab)}


FALLBACKS = {
    "mnist.train": lambda ds: ds.mnist.train(),
    "mnist.test": lambda ds: ds.mnist.test(),
    "cifar.train10": lambda ds: ds.cifar.train10(),
    "cifar.test10": lambda ds: ds.cifar.test10(),
    "cifar.train100": lambda ds: ds.cifar.train100(),
    # the reader looks <unk> up before it looks for its file, so its
    # vocabulary needs one (the synthetic vocabulary has none)
    "imdb.train": lambda ds: ds.imdb.train(_imdb_dict(ds)),
    "imdb.test": lambda ds: ds.imdb.test(_imdb_dict(ds)),
    "uci_housing.train": lambda ds: ds.uci_housing.train(),
    "uci_housing.test": lambda ds: ds.uci_housing.test(),
    "conll05.test": lambda ds: ds.conll05.test(),
    "movielens.train": lambda ds: ds.movielens.train(),
    "movielens.test": lambda ds: ds.movielens.test(),
    "wmt14.train": lambda ds: ds.wmt14.train(100),
    "wmt14.test": lambda ds: ds.wmt14.test(100),
    "wmt16.train": lambda ds: ds.wmt16.train(100, 100),
    "imikolov.train": lambda ds: ds.imikolov.train(
        {"<s>": 0, "<e>": 1, "<unk>": 2}, 4),
    "sentiment.train": lambda ds: ds.sentiment.train(),
    "sentiment.test": lambda ds: ds.sentiment.test(),
    "mq2007.pointwise": lambda ds: ds.mq2007.train(format="pointwise"),
    "mq2007.pairwise": lambda ds: ds.mq2007.train(format="pairwise"),
    "mq2007.listwise": lambda ds: ds.mq2007.test(format="listwise"),
    "flowers.train": lambda ds: ds.flowers.train(),
    "flowers.valid": lambda ds: ds.flowers.valid(),
    "voc2012.train": lambda ds: ds.voc2012.train(),
}


@pytest.mark.parametrize("name", sorted(FALLBACKS))
def test_missing_files_warn_and_fall_back_to_the_references_samples(
        name, data_home):
    """With no file under DATA_HOME each reader warns and yields the
    synthetic set; the port's first samples equal the reference's."""
    def first(ds):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            samples = list(itertools.islice(FALLBACKS[name](ds)(), 3))
        assert any("synthetic" in str(x.message) for x in w), name
        return samples

    assert len(_both(first)) == 3


def test_synthetic_generators_and_shapes():
    """tests/test_io_reader.py's dataset case, held to the reference's
    samples; and the flowers fallback chip_smoke.py trains on: 256
    samples a pass of 3 x 224² float32 with labels in [0, 102)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        img, lab = _both(lambda ds: next(ds.mnist.train()()))
        assert img.shape == (784,) and 0 <= lab < 10
        x, y = _both(lambda ds: next(ds.uci_housing.train()()))
        assert x.shape == (13,) and y.shape == (1,)
    words, lab = _both(lambda ds: next(ds.synthetic.imdb.train(n=4)()))
    assert len(words) >= 8 and lab in (0, 1)
    d, s, c = _both(lambda ds: next(ds.ctr.train(4)()))
    assert d.shape == (13,) and s.shape == (26,) and c in (0, 1)
    _both(lambda ds: list(ds.cifar10.train10(n=4)()))
    _both(lambda ds: list(ds.wmt_translation.train(n=4)()))
    flowers = list(tds.synthetic.images_labeled.train()())
    assert len(flowers) == 256
    assert all(im.shape == (3, 224, 224) and im.dtype == np.float32
               and 0 <= lab < 102 for im, lab in flowers)
