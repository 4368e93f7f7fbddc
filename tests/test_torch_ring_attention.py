"""The port's ring attention (``parallel.ring_attention``) and
``build_llama(shard_sp=True)``, held to the ring cases of
tests/test_attention.py, tests/test_llama.py's
``test_llama_sp_ring_attention`` and the reference's own functions on
the same numpy inputs.

The port's side runs on 4 gloo ranks over an 'sp' axis of 4 (one
spawned group for the module, ``torch_pipe_cases.ring_cases``), where
the reference's tests take 8; the reference's side runs here at sp 4
on jax's virtual devices, or on one device. Tolerances are the
reference tests' own: attention rtol 1e-4 / atol 1e-5, the sp-split
loss against the single device's rtol 2e-4. The ring drops a caller's
``scale`` as the reference's ring branch does (ROADMAP.md section 3,
R3), and that is pinned here on both sides.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as JP

import paddle_tpu as jfluid
from paddle_tpu.models import llama as jllama
from paddle_tpu.ops.pallas_attention import (_ref_attention_lse,
                                             flash_attention as jflash)
from paddle_tpu.parallel import make_mesh
from paddle_tpu.parallel import ring_attention as jring

from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.parallel import ring_attention as tring
from torch_mesh_ranks import shared_ranks
from torch_pipe_cases import (LONG_SHAPE, RING_SHAPE, SP_SEQ,
                              attention_program, llama_data, ring_inputs)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    return shared_ranks("torch_pipe_cases", "ring_cases", 4,
                        tmp_path_factory, timeout=240)


def _close(got, want, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


def test_lse_merge_consistency():
    """Splitting keys in two and lse-merging equals full attention; the
    port's merge equals the reference's on the same partial results."""
    q, k, v = (torch.tensor(a) for a in ring_inputs(0, RING_SHAPE))
    full, _ = tfa.attention_with_lse(q, k, v, causal=False)
    o1, l1 = tfa.attention_with_lse(q, k[:, :, :32], v[:, :, :32])
    o2, l2 = tfa.attention_with_lse(q, k[:, :, 32:], v[:, :, 32:])
    merged, lse = tring._merge(o1, l1, o2, l2)
    _close(merged, full)
    want, want_lse = jring._merge(*(jnp.asarray(x.numpy())
                                    for x in (o1, l1, o2, l2)))
    _close(merged, want, rtol=1e-6, atol=1e-6)
    _close(lse, want_lse, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_4way(cases, causal):
    q, k, v = (jnp.asarray(a) for a in ring_inputs(0, RING_SHAPE))
    got = cases[f"ring_{causal}"]
    ref, _ = _ref_attention_lse(q, k, v, 1.0 / 4.0, causal)
    _close(got, ref)
    ring = jring.ring_attention_sharded(q, k, v, make_mesh({"sp": 4}),
                                        axis="sp", causal=causal)
    _close(got, ring)
    # the chunk entry (a rank's own chunk) is the DTensor entry's body
    assert cases[f"chunk_equal_{causal}"]


def test_ring_matches_flash_long_seq(cases):
    """T 1024 (256 tokens a rank), causal: the ring against the flash
    attention of both packages."""
    q, k, v = ring_inputs(1, LONG_SHAPE, 0.3)
    _close(cases["long"], jflash(*(jnp.asarray(a) for a in (q, k, v)),
                                 True, None))
    _close(cases["long"], tfa.flash_attention(
        *(torch.tensor(a) for a in (q, k, v)), True).numpy())


def test_ring_gradient_matches_flash(cases):
    """The gradient of a weighted sum of the ring's output, back round the
    ring (the permutes' inverse pairs), against flash attention's
    (the port's plain K2/K3 here) and the reference's plain attention."""
    q, k, v = (torch.tensor(a, requires_grad=True)
               for a in ring_inputs(1, LONG_SHAPE, 0.3))
    wts = np.random.RandomState(2).randn(*LONG_SHAPE).astype(np.float32)
    (tfa.flash_attention(q, k, v, True) * torch.tensor(wts)).sum().backward()
    jgrads = jax.grad(lambda q, k, v: jnp.sum(_ref_attention_lse(
        q, k, v, 0.25, True)[0] * wts), argnums=(0, 1, 2))(
            *(jnp.asarray(x.detach().numpy()) for x in (q, k, v)))
    for got, want, jwant in zip(cases["long_grads"], (q, k, v), jgrads):
        _close(got, want.grad.numpy())
        _close(got, jwant)


def _ref_scope(state):
    scope = jfluid.Scope()
    for n, a in state.items():
        scope.set(n, jnp.asarray(a))
    return scope


def _ref_llama(cfg, seq, **kw):
    main, startup = jfluid.Program(), jfluid.Program()
    with jfluid.program_guard(main, startup):
        tokens = jfluid.layers.data(name="tokens", shape=[-1, seq],
                                    dtype="int64", append_batch_size=False)
        targets = jfluid.layers.data(name="targets", shape=[-1, seq],
                                     dtype="int64", append_batch_size=False)
        _, loss = jllama.build_llama(cfg, tokens, targets, **kw)
        jfluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return main, loss


def test_llama_sp_ring_attention(cases):
    """LLAMA_TINY split on the sequence over sp 4 (4 tokens a rank): its
    loss equals the single device's — rope rotates each chunk at its
    global positions — and the reference's single-device loss on the
    same weights; q, k and v reach attention split on T, and the ring
    permutes k and v 3 times a layer."""
    assert abs(cases["sp_pe"] - cases["sp_plain"]) <= \
        2e-4 * abs(cases["sp_plain"])
    main, loss = _ref_llama(jllama.LLAMA_TINY, 16)
    want = jfluid.Executor(jfluid.CPUPlace()).run(
        main, feed=llama_data(0), fetch_list=[loss],
        scope=_ref_scope(cases["sp_init"]))[0]
    _close(cases["sp_pe"], float(np.asarray(want).reshape(())), rtol=2e-4,
           atol=0)
    assert cases["sp_attention_placements"] == [["S(1)"] * 3] * 2
    assert cases["sp_collectives"] == {"collective-permute": 2 * 3 * 2}


def test_ring_attention_long_context_trains(cases):
    """seq 2048 over sp 4 (512 tokens a rank), causal, through
    build_llama(shard_sp=True): finite losses that fall on one batch, the
    first equal to the reference's on the same weights."""
    losses = cases["long_losses"]
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses
    cfg = jllama.LlamaConfig(vocab_size=128, dim=32, n_layers=1, n_heads=2,
                             n_kv_heads=2, ffn_hidden=64, dtype="float32")
    main, loss = _ref_llama(cfg, SP_SEQ, shard_sp=True)
    toks = np.random.RandomState(0).randint(0, 128, (2, SP_SEQ)).astype(
        np.int64)
    want = jfluid.Executor(jfluid.CPUPlace()).run(
        main, feed={"tokens": toks, "targets": np.roll(toks, -1, 1)},
        fetch_list=[loss], scope=_ref_scope(cases["long_init"]))[0]
    _close(losses[0], float(np.asarray(want).reshape(())), rtol=2e-4,
           atol=0)


def test_ring_drops_scale_as_the_reference(cases):
    """R3: multihead_attention(scale=0.5) on an sp mesh is the ring at
    1/sqrt(D) in both packages; off the mesh the scale is taken."""
    _close(cases["ring_0.5"], cases["plain_None"])
    assert not np.allclose(cases["plain_0.5"], cases["plain_None"],
                           rtol=1e-2, atol=1e-3)
    prog, o = attention_program(jfluid, 0.5, JP)
    qkv = ring_inputs(0, RING_SHAPE)
    pe = jfluid.ParallelExecutor(main_program=prog, scope=jfluid.Scope(),
                                 mesh=make_mesh({"sp": 4}))
    ref = pe.run(feed=dict(zip("qkv", (a.transpose(0, 2, 1, 3)
                                       for a in qkv))),
                 fetch_list=[o.name])[0]
    _close(cases["ring_0.5"], ref)
