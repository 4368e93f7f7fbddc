"""The MNIST MLP of tests/test_mnist_e2e.py (fc 128 → fc 64 → fc 10,
softmax_with_cross_entropy, ``accuracy`` of the softmax) through the
torch port, against the JAX package: SGD and Adam converge as the
reference's test asks, and the first 3 steps' losses, accuracies and
every parameter after them match the reference started from the same
state (losses rtol 2e-3, the f32 training tier of
tests/test_torch_training.py; accuracy exactly, as it counts argmax
hits; parameters rtol 1e-4 / atol 1e-5 after SGD, whose update is linear
in the gradient, and atol 2e-4 = 0.02 lr after Adam, whose first
updates are lr·m/√v ≈ lr·sign(g): a gradient element near zero moves
its update by a fraction of lr for a rounding of g).

Both runs start from the reference's startup state, carried across as
numpy: the two packages draw different initial weights from one seed,
and the reference test's convergence ratios are those of its own draw
(from the port's own Xavier draw, SGD reaches 0.53 of its first loss at
step 30 where the test asks 0.5)."""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import weights
from paddle_tpu_torch.models import zoo

torch.set_num_threads(1)


def make_batch(batch_size=64, seed=0):
    rng = np.random.RandomState(seed)
    # synthetic separable data: 784-dim, 10 classes
    labels = rng.randint(0, 10, size=(batch_size, 1)).astype(np.int64)
    centers = np.eye(10, 784, dtype=np.float32) * 5.0
    imgs = centers[labels[:, 0]] + rng.normal(
        scale=1.0, size=(batch_size, 784)).astype(np.float32)
    return {"img": imgs, "label": labels}


def build_mlp(fluid, make_opt):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=[784], dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        hidden = fluid.layers.fc(input=img, size=128, act="relu")
        hidden = fluid.layers.fc(input=hidden, size=64, act="relu")
        logits = fluid.layers.fc(input=hidden, size=10)
        loss = fluid.layers.softmax_with_cross_entropy(logits, label)
        avg_loss = fluid.layers.mean(loss)
        acc = fluid.layers.accuracy(input=fluid.layers.softmax(logits),
                                    label=label)
        make_opt(fluid).minimize(avg_loss)
    return main, startup, avg_loss, acc


def _reference_state(make_opt):
    """(the reference's startup state in a JAX scope, the same in a port
    scope)."""
    _, js, _, _ = build_mlp(jfluid, make_opt)
    jscope = jfluid.Scope()
    jfluid.Executor(jfluid.CPUPlace()).run(js, scope=jscope)
    return jscope, weights.load_state(
        tfluid.Scope(), {n: np.asarray(jscope.find_var(n))
                         for n in jscope.keys()}, torch.device("cpu"))


OPTS = {"sgd": (lambda f: f.optimizer.SGD(learning_rate=0.1), 0.5),
        "adam": (lambda f: f.optimizer.Adam(learning_rate=0.01), 0.3)}


@pytest.mark.parametrize("opt", sorted(OPTS))
def test_converges(opt):
    make_opt, ratio = OPTS[opt]
    main, startup, avg_loss, acc = build_mlp(tfluid, make_opt)
    exe = tfluid.Executor(tfluid.CPUPlace())
    _, scope = _reference_state(make_opt)
    losses = []
    for step in range(30):
        out = exe.run(main, feed=make_batch(seed=step),
                      fetch_list=[avg_loss, acc], scope=scope)
        losses.append(float(out[0]))
    assert losses[-1] < losses[0] * ratio, losses
    if opt == "sgd":
        assert float(out[1]) > 0.7


@pytest.mark.parametrize("opt", sorted(OPTS))
def test_first_steps_match_reference(opt):
    make_opt, _ = OPTS[opt]
    jm, _, jl, ja = build_mlp(jfluid, make_opt)
    tm, _, tl, ta = build_mlp(tfluid, make_opt)
    jscope, tscope = _reference_state(make_opt)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    params = sorted(p.name for p in tm.all_parameters())
    assert params == sorted(p.name for p in jm.all_parameters())
    for step in range(3):
        feed = make_batch(seed=step)
        w = jexe.run(jm, feed=feed, fetch_list=[jl, ja], scope=jscope)
        g = texe.run(tm, feed=feed, fetch_list=[tl, ta], scope=tscope)
        np.testing.assert_allclose(g[0], w[0], rtol=2e-3)
        np.testing.assert_array_equal(g[1], w[1])
    tol = dict(rtol=1e-4, atol=1e-5) if opt == "sgd" else dict(atol=2e-4)
    for n in params:
        np.testing.assert_allclose(
            np.asarray(tscope.find_var(n)), np.asarray(jscope.find_var(n)),
            err_msg=n, **tol)


@pytest.mark.parametrize("name", ["mnist_mlp", "fit_a_line", "transformer",
                                  "llama", "mnist", "vgg", "resnet",
                                  "se_resnext", "word2vec", "recommender",
                                  "ctr", "stacked_dynamic_lstm"])
def test_zoo_entry_trains(name):
    """The port's zoo entries build, initialize and take 3 steps on their
    example feeds with finite fetches; the reference's other zoo names
    refuse naming their ROADMAP item."""
    zp = zoo.build_zoo_program(name)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(zp.startup, scope=scope)
    for step in range(3):
        out = exe.run(zp.main, feed=zoo.example_feed(name, 4, step),
                      fetch_list=zp.fetch_list, scope=scope)
    assert all(np.isfinite(np.asarray(o)).all() for o in out)
    assert set(zoo.zoo_model_names()) == {"mnist_mlp", "fit_a_line",
                                          "transformer", "llama", "mnist",
                                          "vgg", "resnet", "se_resnext",
                                          "word2vec", "recommender", "ctr",
                                          "stacked_dynamic_lstm",
                                          "machine_translation",
                                          "ocr_recognition",
                                          "label_semantic_roles",
                                          "faster_rcnn"}
    assert not hasattr(zoo, "WAITING")
