"""The conv nets through the torch port, against the JAX package: the
cases of tests/test_resnet.py and tests/test_vgg.py, and each model of
ROADMAP item 5 over Momentum steps from one initial state.

Both packages build each program with the same layer code, so the op
types and parameter names must be equal. The JAX startup initializes
the state, which crosses to the port as numpy (``weights.py``). All
comparisons use rtol 2e-4 / atol 2e-5, the reference NHWC test's own
tolerance. Dropout (VGG, SE-ResNeXt) draws differently in the two
packages, so those programs run with each dropout's probability set to
0 on both sides (ROADMAP "Random draws").

- The cifar ResNet (depth 8) and the MNIST CNN, in float32: the losses
  of two Momentum(1e-3, 0.9) steps, every gradient of the second step,
  every parameter, velocity and batch-norm moving statistic after them.
- ResNet-50 (64², batch 2), VGG16 (the zoo's size) and SE-ResNeXt (64²,
  batch 2), in float64 on both sides (the reference under
  ``jax.enable_x64``): the first step's loss and every gradient, the
  whole state after it, and the second step's loss. These depths are
  ill-conditioned at batch 2, so float32 cannot hold the tolerance
  between any two float orders: in float32 the reference's own
  hand-derived batch-norm backward and its autodiff differ by 1046× the
  tolerance in a ResNet-50 gradient at 32², batch 2. At 32² a
  batch-norm near ResNet-50's head averages 2 nearly equal values a
  channel (E[x²] − E[x]² cancels), which takes even float64's forward
  1.8e-6 apart, so ResNet-50 and SE-ResNeXt run at 64² (8 values). Both
  packages update in float32 (``optimizer_ops._f32``), whose roundings a
  second step's gradients inherit and these depths amplify (a float32
  ulp of the state moves a ResNet-50 gradient by 1e-3 relative), so the
  second step holds the loss.
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.models import mnist as jmnist
from paddle_tpu.models import resnet as jresnet
from paddle_tpu.models import se_resnext as jse
from paddle_tpu.models import vgg as jvgg

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import weights
from paddle_tpu_torch.models import mnist as tmnist
from paddle_tpu_torch.models import resnet as tresnet
from paddle_tpu_torch.models import se_resnext as tse
from paddle_tpu_torch.models import vgg as tvgg

torch.set_num_threads(1)

CPU = torch.device("cpu")
TOL = dict(rtol=2e-4, atol=2e-5)


def _mods(fluid):
    if fluid is jfluid:
        return dict(resnet=jresnet, vgg=jvgg, se=jse, mnist=jmnist)
    return dict(resnet=tresnet, vgg=tvgg, se=tse, mnist=tmnist)


# model -> (image shape, classes, batch, dtype,
#           builder(mods, img, label, layout))
MODELS = {
    "resnet_cifar8": ((3, 16, 16), 4, 4, "float32",
                      lambda m, img, lab, lay: m["resnet"].resnet_cifar10(
                          img, class_num=4, depth=8, layout=lay)),
    "resnet50": ((3, 64, 64), 5, 2, "float64",
                 lambda m, img, lab, lay: m["resnet"].resnet_imagenet(
                     img, class_num=5, depth=50, layout=lay)),
    "vgg16": ((3, 32, 32), 10, 2, "float64",
              lambda m, img, lab, lay: m["vgg"].vgg16_bn_drop(
                  img, class_num=10, fc_size=64, layout=lay)),
    "se_resnext": ((3, 64, 64), 10, 2, "float64",
                   lambda m, img, lab, lay: m["se"].build_se_resnext(
                       img, class_dim=10, depth=50, cardinality=8,
                       reduction_ratio=4)),
    "mnist_cnn": ((1, 28, 28), 10, 4, "float32",
                  lambda m, img, lab, lay: m["mnist"].cnn_model(
                      img, lab)[2]),
}


def build(fluid, model, layout="NCHW", lr=1e-3):
    """(main, startup, loss) of ``model`` with a Momentum(lr, 0.9) step,
    dropout disabled."""
    shape, classes, _, dtype, builder = MODELS[model]
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=list(shape),
                                dtype=dtype)
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        pred = builder(_mods(fluid), img, label, layout)
        loss = fluid.layers.mean(
            fluid.layers.cross_entropy(input=pred, label=label))
        fluid.optimizer.Momentum(learning_rate=lr,
                                 momentum=0.9).minimize(loss)
    for op in main.global_block().ops:
        if op.type == "dropout":
            op.attrs["dropout_prob"] = 0.0
    return main, startup, loss


def feed(model, step, seed=0):
    shape, classes, batch, dtype, _ = MODELS[model]
    rng = np.random.RandomState(seed + 100 * step)
    lab = rng.randint(0, classes, (batch, 1))
    # a class-dependent mean makes the task learnable in a few steps
    xs = (rng.randn(batch, *shape) * 0.5
          + lab[:, :, None, None] * 0.2).astype(dtype)
    return {"img": xs, "label": lab.astype(np.int64)}


def reference_state(startup):
    """The reference's startup state: (JAX scope, {name: array})."""
    jscope = jfluid.Scope()
    jfluid.Executor(jfluid.CPUPlace()).run(startup, scope=jscope)
    return jscope, {n: np.asarray(jscope.find_var(n))
                    for n in jscope.keys()}


def port_scope(state):
    return weights.load_state(tfluid.Scope(), state, CPU)


def grad_names(main):
    return sorted(p.name + "@GRAD" for p in main.all_parameters())


def run_steps(fluid, main, loss, scope, model, steps=2, fetch=(), first=0):
    exe = fluid.Executor(fluid.CPUPlace())
    out = []
    for step in range(first, first + steps):
        out.append(exe.run(main, feed=feed(model, step),
                           fetch_list=[loss] + list(fetch), scope=scope))
    return out


CASES = [(m, lay) for m in sorted(MODELS) for lay in ("NCHW", "NHWC")
         if lay == "NCHW" or m not in ("se_resnext", "mnist_cnn")]


@pytest.mark.parametrize("model,layout", CASES)
def test_momentum_steps_match_reference(model, layout):
    jm, js, jl = build(jfluid, model, layout)
    tm, ts, tl = build(tfluid, model, layout)
    assert [op.type for op in tm.global_block().ops] == \
        [op.type for op in jm.global_block().ops]
    params = sorted(p.name for p in tm.all_parameters())
    assert params == sorted(p.name for p in jm.all_parameters())
    grads = grad_names(tm)
    x64 = MODELS[model][3] == "float64"
    held = 0 if x64 else 1      # the step whose gradients and state hold
    with jax.enable_x64(x64):
        jscope, state = reference_state(js)
        want = run_steps(jfluid, jm, jl, jscope, model, fetch=grads,
                         steps=held + 1)
        jstate = {n: np.asarray(jscope.find_var(n)) for n in state}
        if x64:
            want += run_steps(jfluid, jm, jl, jscope, model, steps=1,
                              first=1)
    tscope = port_scope(state)
    got = run_steps(tfluid, tm, tl, tscope, model, fetch=grads,
                    steps=held + 1)
    # parameters, velocities and the batch-norm moving statistics
    assert model == "mnist_cnn" or any(".global_" in n for n in state)
    for n in sorted(state):
        np.testing.assert_allclose(
            np.asarray(weights.to_host(tscope.find_var(n))), jstate[n],
            err_msg=f"{model} {n}", **TOL)
    if x64:
        got += run_steps(tfluid, tm, tl, tscope, model, steps=1, first=1)
    for step in range(2):
        np.testing.assert_allclose(got[step][0], want[step][0],
                                   err_msg=f"loss {step}", **TOL)
    for name, g, w in zip(grads, got[held][1:], want[held][1:]):
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)


def test_cifar_resnet_trains():
    """tests/test_resnet.py's convergence case, on the port."""
    main, startup, loss = build(tfluid, "resnet_cifar8", lr=0.05)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    losses = []
    for _ in range(15):
        lab = rng.randint(0, 4, (8, 1))
        xs = (rng.randn(8, 3, 16, 16) * 0.1
              + lab[:, :, None, None]).astype(np.float32)
        out = exe.run(main, feed={"img": xs, "label": lab.astype(np.int64)},
                      fetch_list=[loss], scope=scope)
        losses.append(float(out[0].reshape(())))
    assert losses[-1] < losses[0], losses


def test_nhwc_layout_parity():
    """tests/test_resnet.py's NHWC case on the port: the same model from
    one scope gives the same loss and the same updated filters in both
    layouts (rtol 2e-4 / atol 2e-5)."""
    _, js, _ = build(jfluid, "resnet_cifar8")
    _, state = reference_state(js)
    out = {}
    for layout in ("NCHW", "NHWC"):
        main, _, loss = build(tfluid, "resnet_cifar8", layout)
        scope = port_scope(state)
        out[layout] = (run_steps(tfluid, main, loss, scope,
                                 "resnet_cifar8", steps=1)[0][0], scope)
    np.testing.assert_allclose(out["NHWC"][0], out["NCHW"][0], **TOL)
    for n in state:
        if n.endswith(".w_0"):
            np.testing.assert_allclose(
                out["NHWC"][1].find_var(n).numpy(),
                out["NCHW"][1].find_var(n).numpy(), err_msg=n, **TOL)


def test_nhwc_shapes():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        img = tfluid.layers.data(name="img", shape=[3, 64, 64],
                                 dtype="float32")
        y = tfluid.layers.conv2d(
            tfluid.layers.transpose(img, perm=[0, 2, 3, 1]), num_filters=8,
            filter_size=3, padding=1, stride=2, data_format="NHWC",
            bias_attr=False)
        p = tfluid.layers.pool2d(y, pool_size=2, pool_stride=2,
                                 data_format="NHWC")
        g = tfluid.layers.pool2d(p, pool_type="avg", global_pooling=True,
                                 data_format="NHWC")
    assert list(y.shape)[1:] == [32, 32, 8]
    assert list(p.shape)[1:] == [16, 16, 8]
    assert list(g.shape)[1:] == [1, 1, 8]
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    xs = np.random.RandomState(0).randn(2, 3, 64, 64).astype(np.float32)
    got = exe.run(main, feed={"img": xs}, fetch_list=[y, p, g],
                  scope=scope)
    assert [o.shape for o in got] == [(2, 32, 32, 8), (2, 16, 16, 8),
                                      (2, 1, 1, 8)]


def test_imagenet_depth_table_builds():
    """tests/test_resnet.py's depth-table case at depth 18 and 50 on the
    port: softmax rows in test mode, and the cifar form refuses a depth
    that is not 6n + 2."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        img = tfluid.layers.data(name="img", shape=[3, 32, 32],
                                 dtype="float32")
        p18 = tresnet.resnet_imagenet(img, class_num=5, depth=18)
        with tfluid.unique_name.guard("d50"):
            p50 = tresnet.resnet_imagenet(img, class_num=5, depth=50)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    xs = np.random.RandomState(1).randn(2, 3, 32, 32).astype(np.float32)
    o18, o50 = exe.run(main, feed={"img": xs}, fetch_list=[p18, p50],
                       mode="test", scope=scope)
    for o in (o18, o50):
        assert o.shape == (2, 5)
        np.testing.assert_allclose(o.sum(-1), 1.0, rtol=1e-4)
    with pytest.raises(ValueError):
        tresnet.resnet_cifar10(img, depth=9)


def test_vgg_trains():
    """tests/test_vgg.py's case on the port, dropout on: VGG16 at the
    zoo's size takes SGD steps with finite, falling losses."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        img = tfluid.layers.data(name="img", shape=[3, 32, 32],
                                 dtype="float32")
        label = tfluid.layers.data(name="label", shape=[1], dtype="int64")
        loss, acc, _ = tvgg.vgg16(img, label, class_num=10, fc_size=64)
        tfluid.optimizer.Momentum(learning_rate=0.01,
                                  momentum=0.9).minimize(loss)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    lab = rng.randint(0, 10, (8, 1))
    xs = (rng.randn(8, 3, 32, 32) * 0.1
          + lab[:, :, None, None] * 0.3).astype(np.float32)
    losses = [float(exe.run(main, feed={"img": xs,
                                        "label": lab.astype(np.int64)},
                            fetch_list=[loss], scope=scope)[0].reshape(()))
              for _ in range(6)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
