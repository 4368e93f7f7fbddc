"""Model-zoo program builders (port of ``paddle_tpu/models/zoo.py``):
the entries whose ops the port has, each building a complete (main,
startup) Program pair at a tiny configuration with an example feed —
the conv nets ``mnist``, ``vgg``, ``resnet`` and ``se_resnext``, then
``mnist_mlp``, ``fit_a_line``, ``word2vec``, ``recommender``, ``ctr``,
``stacked_dynamic_lstm``, ``machine_translation``, ``ocr_recognition``,
``label_semantic_roles``, ``transformer`` and ``llama``. The reference's
``faster_rcnn`` raises NotImplementedError naming the ROADMAP.md item
that ports what it needs. Example feeds give lod_level inputs as
SequenceBatch values.
"""
from .. import layers, optimizer
from ..core import framework, unique_name
from ..param_attr import ParamAttr

__all__ = ["ZOO", "zoo_model_names", "build_zoo_program", "ZooProgram",
           "example_feed", "WAITING"]

ZOO = {}
FEEDS = {}

_SEQ = "Remaining op families and the zoo"
#: the reference's other zoo name -> the ROADMAP.md item it waits for
#: (detection)
WAITING = {"faster_rcnn": _SEQ}


class ZooProgram:
    """The program pair plus the train-loop contract (what gets fed,
    what gets fetched)."""

    def __init__(self, main, startup, fetch_list, feed_names):
        self.main = main
        self.startup = startup
        self.fetch_list = fetch_list
        self.feed_names = feed_names


def _zoo(name):
    def deco(fn):
        assert name not in ZOO, name
        ZOO[name] = fn
        return fn
    return deco


def _feed(name):
    def deco(fn):
        assert name not in FEEDS, name
        FEEDS[name] = fn
        return fn
    return deco


def example_feed(name, batch=2, seed=0):
    """Deterministic synthetic feed for the named zoo model — shapes,
    dtypes, and vocab ranges matching the builder's data declarations
    — for any consumer that needs to actually RUN a zoo program."""
    import numpy as np
    _refuse_waiting(name)
    try:
        builder = FEEDS[name]
    except KeyError:
        raise KeyError(f"no example feed for zoo model {name!r}; one "
                       f"of {sorted(FEEDS)}") from None
    return builder(batch, np.random.RandomState(seed))


def _refuse_waiting(name):
    if name in WAITING:
        raise NotImplementedError(
            f"zoo model {name!r} is ported with ROADMAP.md item "
            f"'{WAITING[name]}'")


def zoo_model_names():
    return sorted(ZOO)


def build_zoo_program(name):
    """Builds the named model into fresh programs (isolated from the
    caller's default programs and name generator)."""
    _refuse_waiting(name)
    try:
        builder = ZOO[name]
    except KeyError:
        raise KeyError(f"unknown zoo model {name!r}; one of "
                       f"{zoo_model_names()}") from None
    main, startup = framework.Program(), framework.Program()
    with framework.program_guard(main, startup), unique_name.guard():
        fetch_list, feed_names = builder()
    return ZooProgram(main, startup, fetch_list, feed_names)


@_zoo("mnist")
def _build_mnist():
    from .mnist import cnn_model
    img = layers.data(name="img", shape=[1, 28, 28], dtype="float32")
    label = layers.data(name="label", shape=[1], dtype="int64")
    loss, acc, _ = cnn_model(img, label)
    optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return [loss, acc], ["img", "label"]


@_zoo("vgg")
def _build_vgg():
    from .vgg import vgg16
    img = layers.data(name="img", shape=[3, 32, 32], dtype="float32")
    label = layers.data(name="label", shape=[1], dtype="int64")
    loss, acc, _ = vgg16(img, label, class_num=10, fc_size=64)
    optimizer.SGD(learning_rate=1e-2).minimize(loss)
    return [loss, acc], ["img", "label"]


@_zoo("resnet")
def _build_resnet():
    from .resnet import resnet_cifar10
    img = layers.data(name="img", shape=[3, 32, 32], dtype="float32")
    label = layers.data(name="label", shape=[1], dtype="int64")
    pred = resnet_cifar10(img, class_num=4, depth=8)
    loss = layers.mean(layers.cross_entropy(input=pred, label=label))
    optimizer.SGD(learning_rate=1e-2).minimize(loss)
    return [loss], ["img", "label"]


@_zoo("se_resnext")
def _build_se_resnext():
    from .se_resnext import build_se_resnext
    img = layers.data(name="img", shape=[3, 32, 32], dtype="float32")
    probs = build_se_resnext(img, class_dim=10, depth=50, cardinality=8,
                             reduction_ratio=4)
    return [probs], ["img"]


@_zoo("mnist_mlp")
def _build_mnist_mlp():
    from .mnist import mlp_model
    img = layers.data(name="img", shape=[784], dtype="float32")
    label = layers.data(name="label", shape=[1], dtype="int64")
    loss, acc, _ = mlp_model(img, label)
    optimizer.SGD(learning_rate=0.1).minimize(loss)
    return [loss, acc], ["img", "label"]


@_zoo("fit_a_line")
def _build_fit_a_line():
    from .fit_a_line import build_fit_a_line
    x = layers.data(name="x", shape=[13], dtype="float32")
    y = layers.data(name="y", shape=[1], dtype="float32")
    _, loss = build_fit_a_line(x, y)
    optimizer.SGD(learning_rate=0.05).minimize(loss)
    return [loss], ["x", "y"]


@_zoo("word2vec")
def _build_word2vec():
    from .word2vec import build_word2vec
    words = [layers.data(name=f"w{i}", shape=[1], dtype="int64")
             for i in range(4)]
    nxt = layers.data(name="next", shape=[1], dtype="int64")
    _, loss = build_word2vec(words, nxt, dict_size=30, embed_size=16,
                             hidden_size=32)
    optimizer.Adam(learning_rate=1e-2).minimize(loss)
    return [loss], [f"w{i}" for i in range(4)] + ["next"]


@_zoo("recommender")
def _build_recommender():
    from .recommender import build_recommender
    uid = layers.data(name="uid", shape=[1], dtype="int64")
    gender = layers.data(name="gender", shape=[1], dtype="int64")
    age = layers.data(name="age", shape=[1], dtype="int64")
    job = layers.data(name="job", shape=[1], dtype="int64")
    mid = layers.data(name="mid", shape=[1], dtype="int64")
    cats = layers.data(name="cats", shape=[1], dtype="int64",
                       lod_level=1)
    title = layers.data(name="title", shape=[1], dtype="int64",
                        lod_level=1)
    rating = layers.data(name="rating", shape=[1], dtype="float32")
    _, loss = build_recommender(
        uid, gender, age, job, mid, cats, title, rating,
        sizes=dict(uid=8, gender=2, age=4, job=4, mid=8, category=6,
                   title=20))
    optimizer.Adam(learning_rate=5e-3).minimize(loss)
    return [loss], ["uid", "gender", "age", "job", "mid", "cats",
                    "title", "rating"]


@_zoo("ctr")
def _build_ctr():
    from .ctr import build_deepfm
    feat = layers.data(name="feat", shape=[-1, 6], dtype="int64",
                       append_batch_size=False)
    label = layers.data(name="label", shape=[-1, 1], dtype="float32",
                        append_batch_size=False)
    _, loss = build_deepfm(feat, label, num_features=64, num_fields=6,
                           embed_size=4, hidden_sizes=(16,))
    optimizer.Adam(learning_rate=5e-3).minimize(loss)
    return [loss], ["feat", "label"]


@_zoo("stacked_dynamic_lstm")
def _build_stacked_lstm():
    from .stacked_dynamic_lstm import stacked_lstm_net
    data = layers.data(name="words", shape=[1], dtype="int64",
                       lod_level=1)
    label = layers.data(name="label", shape=[1], dtype="int64")
    loss, acc, _ = stacked_lstm_net(data, label, dict_dim=100,
                                    emb_dim=16, hid_dim=16,
                                    stacked_num=2)
    optimizer.Adam(learning_rate=1e-2).minimize(loss)
    return [loss, acc], ["words", "label"]


@_zoo("machine_translation")
def _build_machine_translation():
    from .machine_translation import seq_to_seq_net
    src = layers.data(name="src", shape=[1], dtype="int64", lod_level=1)
    trg = layers.data(name="trg", shape=[1], dtype="int64", lod_level=1)
    lbl = layers.data(name="lbl", shape=[1], dtype="int64", lod_level=1)
    loss, _ = seq_to_seq_net(src, trg, lbl, src_dict_size=40,
                             trg_dict_size=40, embedding_dim=16,
                             encoder_size=16, decoder_size=16)
    optimizer.Adam(learning_rate=1e-2).minimize(loss)
    return [loss], ["src", "trg", "lbl"]


@_zoo("ocr_recognition")
def _build_ocr():
    from .ocr_recognition import ctc_train_net
    images = layers.data(name="images", shape=[1, 8, 16],
                         dtype="float32")
    label = layers.data(name="label", shape=[1], dtype="int64",
                        lod_level=1)
    loss, _ = ctc_train_net(images, label, num_classes=3, rnn_hidden=16,
                            conv_filters=(8,))
    optimizer.Adam(learning_rate=5e-3).minimize(loss)
    return [loss], ["images", "label"]


@_zoo("label_semantic_roles")
def _build_srl():
    from .label_semantic_roles import db_lstm
    names = ["word", "predicate", "ctx_n2", "ctx_n1", "ctx_0", "ctx_p1",
             "ctx_p2", "mark"]
    ins = [layers.data(name=n, shape=[1], dtype="int64", lod_level=1)
           for n in names]
    target = layers.data(name="target", shape=[1], dtype="int64",
                         lod_level=1)
    feature_out = db_lstm(*ins, word_dict_len=40, label_dict_len=9,
                          pred_dict_len=12, word_dim=8, mark_dim=4,
                          hidden_dim=16, depth=4)
    crf_cost = layers.linear_chain_crf(
        input=feature_out, label=target,
        param_attr=ParamAttr(name="crfw"))
    loss = layers.mean(crf_cost)
    optimizer.SGD(learning_rate=1e-2).minimize(loss)
    return [loss], names + ["target"]


@_zoo("transformer")
def _build_transformer():
    from .transformer import TRANSFORMER_TINY, build_transformer
    src = layers.data(name="src", shape=[-1, 8], dtype="int64",
                      append_batch_size=False)
    tgt = layers.data(name="tgt", shape=[-1, 8], dtype="int64",
                      append_batch_size=False)
    lbl = layers.data(name="lbl", shape=[-1, 8], dtype="int64",
                      append_batch_size=False)
    _, loss = build_transformer(TRANSFORMER_TINY, src, tgt, lbl)
    optimizer.Adam(learning_rate=5e-3).minimize(loss)
    return [loss], ["src", "tgt", "lbl"]


@_zoo("llama")
def _build_llama():
    from .llama import LLAMA_TINY, build_llama
    tokens = layers.data(name="tokens", shape=[-1, 16], dtype="int64",
                         append_batch_size=False)
    targets = layers.data(name="targets", shape=[-1, 16], dtype="int64",
                          append_batch_size=False)
    _, loss = build_llama(LLAMA_TINY, tokens, targets)
    optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return [loss], ["tokens", "targets"]


def _seqs(rng, batch, lo, hi, width=1, min_len=3, max_len=6):
    import numpy as np
    from ..core.sequence import to_sequence_batch
    lens = [int(rng.randint(min_len, max_len + 1)) for _ in range(batch)]
    arrs = [rng.randint(lo, hi, (n, width)) for n in lens]
    return to_sequence_batch(arrs, np.int64, bucket=4), lens


@_feed("mnist")
def _feed_mnist(b, rng):
    import numpy as np
    return {"img": rng.rand(b, 1, 28, 28).astype(np.float32),
            "label": rng.randint(0, 10, (b, 1)).astype(np.int64)}


@_feed("vgg")
def _feed_vgg(b, rng):
    import numpy as np
    return {"img": rng.rand(b, 3, 32, 32).astype(np.float32),
            "label": rng.randint(0, 10, (b, 1)).astype(np.int64)}


@_feed("resnet")
def _feed_resnet(b, rng):
    import numpy as np
    return {"img": rng.rand(b, 3, 32, 32).astype(np.float32),
            "label": rng.randint(0, 4, (b, 1)).astype(np.int64)}


@_feed("se_resnext")
def _feed_se_resnext(b, rng):
    import numpy as np
    return {"img": rng.rand(b, 3, 32, 32).astype(np.float32)}


@_feed("mnist_mlp")
def _feed_mnist_mlp(b, rng):
    import numpy as np
    return {"img": rng.rand(b, 784).astype(np.float32),
            "label": rng.randint(0, 10, (b, 1)).astype(np.int64)}


@_feed("fit_a_line")
def _feed_fit_a_line(b, rng):
    import numpy as np
    x = rng.randn(b, 13).astype(np.float32)
    return {"x": x, "y": rng.randn(b, 1).astype(np.float32)}


@_feed("transformer")
def _feed_transformer(b, rng):
    import numpy as np
    s = rng.randint(2, 64, (b, 8)).astype(np.int64)
    t = np.concatenate([np.ones((b, 1), np.int64), s[:, :-1]], 1)
    return {"src": s, "tgt": t, "lbl": s}


@_feed("llama")
def _feed_llama(b, rng):
    import numpy as np
    toks = rng.randint(2, 256, (b, 16)).astype(np.int64)
    return {"tokens": toks, "targets": np.roll(toks, -1, 1)}


@_feed("word2vec")
def _feed_word2vec(b, rng):
    import numpy as np
    feed = {f"w{i}": rng.randint(0, 30, (b, 1)).astype(np.int64)
            for i in range(4)}
    feed["next"] = rng.randint(0, 30, (b, 1)).astype(np.int64)
    return feed


@_feed("recommender")
def _feed_recommender(b, rng):
    import numpy as np
    cats, _ = _seqs(rng, b, 0, 6, max_len=4)
    title, _ = _seqs(rng, b, 0, 20, max_len=4)
    return {"uid": rng.randint(0, 8, (b, 1)).astype(np.int64),
            "gender": rng.randint(0, 2, (b, 1)).astype(np.int64),
            "age": rng.randint(0, 4, (b, 1)).astype(np.int64),
            "job": rng.randint(0, 4, (b, 1)).astype(np.int64),
            "mid": rng.randint(0, 8, (b, 1)).astype(np.int64),
            "cats": cats, "title": title,
            "rating": rng.rand(b, 1).astype(np.float32)}


@_feed("ctr")
def _feed_ctr(b, rng):
    import numpy as np
    return {"feat": rng.randint(0, 64, (b, 6)).astype(np.int64),
            "label": rng.randint(0, 2, (b, 1)).astype(np.float32)}


@_feed("stacked_dynamic_lstm")
def _feed_stacked_lstm(b, rng):
    import numpy as np
    words, _ = _seqs(rng, b, 0, 100)
    return {"words": words,
            "label": rng.randint(0, 2, (b, 1)).astype(np.int64)}


@_feed("machine_translation")
def _feed_machine_translation(b, rng):
    import numpy as np
    from ..core.sequence import to_sequence_batch
    src, trg, lbl = [], [], []
    for _ in range(b):
        n = int(rng.randint(3, 6))
        s = rng.randint(0, 40, (n, 1))
        src.append(s)
        trg.append(s)                       # copy task
        lbl.append(np.roll(s, -1, 0))
    return {"src": to_sequence_batch(src, np.int64, bucket=4),
            "trg": to_sequence_batch(trg, np.int64, bucket=4),
            "lbl": to_sequence_batch(lbl, np.int64, bucket=4)}


@_feed("ocr_recognition")
def _feed_ocr(b, rng):
    import numpy as np
    from ..core.sequence import to_sequence_batch
    imgs = rng.randn(b, 1, 8, 16).astype(np.float32)
    labs = [rng.randint(0, 3, (2, 1)).astype(np.int64)
            for _ in range(b)]
    return {"images": imgs,
            "label": to_sequence_batch(labs, np.int64, bucket=2)}


@_feed("label_semantic_roles")
def _feed_srl(b, rng):
    import numpy as np
    from ..core.sequence import to_sequence_batch
    names = ("word", "ctx_n2", "ctx_n1", "ctx_0", "ctx_p1", "ctx_p2")
    feats = {n: [] for n in
             names + ("predicate", "mark", "target")}
    for _ in range(b):
        n = int(rng.randint(3, 7))
        for name in names:
            feats[name].append(rng.randint(0, 40, (n, 1)))
        feats["predicate"].append(rng.randint(0, 12, (n, 1)))
        feats["mark"].append(rng.randint(0, 2, (n, 1)))
        feats["target"].append(rng.randint(0, 9, (n, 1)))
    return {k: to_sequence_batch(v, np.int64, bucket=4)
            for k, v in feats.items()}
