"""Llama-3-style decoder-only LLM (port of ``paddle_tpu/models/llama.py``).

The port builds the decoder with the same layer calls as the reference,
so its program has the reference's op types and parameter names one for
one: embedding → [rms_norm → GQA attention with rope on the flash
kernels → rms_norm → SwiGLU MLP] × L → rms_norm → lm_head, and with
``targets`` the loss softmax_with_cross_entropy → mean. ``shard_pp``
builds the layers as one layer-stacked ``llama_decoder_stack`` op (on
one device a loop over the layers, each rematerialised with ``remat``),
and ``fused_head_chunk`` the loss as the vocab-chunked
``fused_head_cross_entropy``, which never builds the logits — the
reference's own train benchmark takes both (``bench.py``
``transformer_main``).

Generation: ``build_llama_generator`` (greedy or sampled, W8A8 with
``quantize=True`` over a ``quantize_generator_weights``'d scope, an int8
KV cache with ``kv_int8``) and ``build_llama_spec_generator``
(speculative decoding) serve a scope trained with ``shard_pp=True``
directly, since the parameter names match; ``stack_generator_weights``
converts a per-layer scope, ``copy_weights_as_draft`` aliases the
target as its own draft, and ``save_decode_model`` /
``load_decode_model`` persist (config, weights).
``build_llama_paged_programs`` builds the step programs of the
continuous-batching decode engine (``serving.DecodeEngine``) over the
same names. ``moe_experts`` > 0 makes every FFN a mixture of experts
(``moe_ffn``). ``shard_dp`` / ``shard_tp`` / ``shard_sp`` annotate the
batch, the Megatron splits and the sequence split (ring attention over
the mesh 'sp' axis) for ``parallel.ParallelExecutor``; with ``shard_pp``
a mesh 'pp' axis pipelines the stacked decoder (GPipe, or 1F1B with
``pp_schedule="1f1b"``, whose op ``llama_stack_1f1b_loss`` holds the
head and the loss too).
"""
import json
import os
from dataclasses import asdict, dataclass

import numpy as np
import torch

from .. import layers
from .. import weights as _weights
from ..layers import transformer as tfl
from ..param_attr import ParamAttr
from .. import initializer as init_mod
from ..sharding import PartitionSpec as P

__all__ = ["LlamaConfig", "LLAMA3_8B", "LLAMA_TINY", "build_llama",
           "build_llama_generator", "build_llama_spec_generator",
           "build_llama_paged_programs", "PagedDecodePrograms",
           "quantize_generator_weights", "stack_generator_weights",
           "save_decode_model", "load_decode_model"]


@dataclass
class LlamaConfig:
    vocab_size: int = 128256
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn_hidden: int = 14336
    rope_base: float = 500000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    # MoE: >0 turns every FFN into a mixture of this many SwiGLU experts
    # (GShard top-k routing, expert-parallel over the mesh 'ep' axis)
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 2.0
    moe_aux_weight: float = 0.01


LLAMA3_8B = LlamaConfig()
LLAMA_TINY = LlamaConfig(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                         n_kv_heads=2, ffn_hidden=128, dtype="float32")


def _linear(x, out_dim, name):
    return layers.fc(x, size=out_dim, num_flatten_dims=2, bias_attr=False,
                     param_attr=ParamAttr(
                         name=name,
                         initializer=init_mod.Normal(0.0, 0.02)))


def build_llama(cfg, tokens, targets=None, shard_tp=False, shard_sp=False,
                shard_dp=False, shard_pp=False, pp_n_micro=0,
                pp_schedule="gpipe", fused_head_chunk=0, scan_unroll=1,
                remat=True):
    """Builds the forward (and loss if ``targets``) graph, as the
    reference does. tokens (and targets): int data vars [batch, seq].
    Returns (logits, avg_loss|None); logits are None under
    ``fused_head_chunk``, which needs ``targets``.

    ``shard_pp`` builds the decoder as one layer-stacked op
    (``llama_decoder_stack``) whose stacked weights are annotated
    ``P('pp', ...)``: on one device a loop over the layers, ``remat``
    recomputing each layer in the backward pass; on a mesh with a 'pp'
    axis the GPipe schedule over its stages, ``pp_n_micro``
    microbatches (0: one a stage), embedding and head replicated outside
    the pipeline (``scan_unroll`` changes nothing here).
    ``pp_schedule="1f1b"`` (with ``shard_pp`` and ``targets``) folds
    final norm, lm head and loss into the pipelined op
    (``llama_stack_1f1b_loss``: the backward runs inside the schedule)
    and returns logits None. ``fused_head_chunk`` > 0 computes the loss
    with the vocab-chunked fused lm-head cross entropy in chunks of that
    many columns (under 1F1B, the chunk of the op's own loss).
    ``shard_sp`` splits tokens and targets on the sequence over 'sp',
    where attention is the ring."""
    if pp_schedule not in ("gpipe", "1f1b"):
        raise ValueError(f"unknown pp_schedule {pp_schedule!r}")
    if pp_schedule == "1f1b" and not shard_pp:
        raise ValueError("pp_schedule='1f1b' requires shard_pp=True")
    if pp_schedule == "1f1b" and targets is None:
        raise ValueError("pp_schedule='1f1b' requires targets — the "
                         "loss lives inside the pipelined op")
    if fused_head_chunk and targets is None:
        raise ValueError("fused_head_chunk requires targets")
    if shard_pp and cfg.moe_experts > 0:
        raise ValueError("shard_pp does not compose with moe_experts — "
                         "pick pipeline or expert parallelism per stack")
    if shard_pp and (shard_tp or shard_sp):
        raise ValueError("shard_pp composes with dp (microbatch axis), "
                         "not with tp/sp — stage weights are pp-sharded "
                         "and the stacked decoder runs flash (not ring) "
                         "attention inside the pipeline")
    dt = cfg.dtype
    hd = cfg.dim // cfg.n_heads
    h = layers.embedding(tokens, size=[cfg.vocab_size, cfg.dim],
                         param_attr=ParamAttr(
                             name="tok_emb",
                             initializer=init_mod.Normal(0.0, 0.02)),
                         dtype=dt)
    if shard_pp and pp_schedule == "1f1b":
        loss = tfl.llama_stack_1f1b_loss(
            h, targets, vocab_size=cfg.vocab_size,
            n_layers=cfg.n_layers, n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads, ffn_hidden=cfg.ffn_hidden,
            rope_base=cfg.rope_base, epsilon=cfg.norm_eps,
            n_micro=pp_n_micro, scan_unroll=scan_unroll, remat=remat,
            loss_chunk=fused_head_chunk or 8192, name="blocks")
        tokens.sharding = P(("dp",) if shard_dp else None, None)
        targets.sharding = tokens.sharding
        return None, loss
    if shard_pp:
        h = tfl.llama_decoder_stack(
            h, n_layers=cfg.n_layers, n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads, ffn_hidden=cfg.ffn_hidden,
            rope_base=cfg.rope_base, epsilon=cfg.norm_eps,
            n_micro=pp_n_micro, scan_unroll=scan_unroll, remat=remat,
            name="blocks")
        return _finish(cfg, h, tokens, targets, [], shard_tp=False,
                       shard_dp=shard_dp, fused_head_chunk=fused_head_chunk)
    aux_losses = []
    for i in range(cfg.n_layers):
        pre = tfl.rms_norm(h, epsilon=cfg.norm_eps,
                           param_attr=ParamAttr(name=f"l{i}.attn_norm"))
        q = _linear(pre, cfg.n_heads * hd, f"l{i}.wq")
        k = _linear(pre, cfg.n_kv_heads * hd, f"l{i}.wk")
        v = _linear(pre, cfg.n_kv_heads * hd, f"l{i}.wv")
        q = layers.reshape(q, [0, 0, cfg.n_heads, hd])
        k = layers.reshape(k, [0, 0, cfg.n_kv_heads, hd])
        v = layers.reshape(v, [0, 0, cfg.n_kv_heads, hd])
        q = tfl.rope(q, base=cfg.rope_base)
        k = tfl.rope(k, base=cfg.rope_base)
        attn = tfl.multihead_attention(q, k, v, causal=True)
        attn = layers.reshape(attn, [0, 0, cfg.n_heads * hd])
        o = _linear(attn, cfg.dim, f"l{i}.wo")
        h = layers.elementwise_add(h, o)

        pre2 = tfl.rms_norm(h, epsilon=cfg.norm_eps,
                            param_attr=ParamAttr(name=f"l{i}.mlp_norm"))
        if cfg.moe_experts > 0:
            mlp, aux = tfl.moe_ffn(
                pre2, num_experts=cfg.moe_experts,
                hidden_dim=cfg.ffn_hidden, top_k=cfg.moe_top_k,
                capacity_factor=cfg.moe_capacity_factor,
                name=f"l{i}.moe")
            aux_losses.append(aux)
        else:
            gate = tfl.silu(_linear(pre2, cfg.ffn_hidden, f"l{i}.w_gate"))
            up = _linear(pre2, cfg.ffn_hidden, f"l{i}.w_up")
            mlp = _linear(layers.elementwise_mul(gate, up), cfg.dim,
                          f"l{i}.w_down")
        h = layers.elementwise_add(h, mlp)
    return _finish(cfg, h, tokens, targets, aux_losses, shard_tp=shard_tp,
                   shard_dp=shard_dp, fused_head_chunk=fused_head_chunk,
                   shard_sp=shard_sp)


def _finish(cfg, h, tokens, targets, aux_losses, shard_tp, shard_dp,
            fused_head_chunk=0, shard_sp=False):
    """final_norm → lm_head logits (none under ``fused_head_chunk``) →
    the loss when ``targets``, plus the weighted MoE aux losses; the
    batch annotated over 'dp' with ``shard_dp``, the sequence over 'sp'
    with ``shard_sp`` and the Megatron specs with ``shard_tp``
    (reference ``_finish``)."""
    gb = tokens.block.program.global_block()
    h = tfl.rms_norm(h, epsilon=cfg.norm_eps,
                     param_attr=ParamAttr(name="final_norm"))
    logits = None
    if not fused_head_chunk:
        logits = _linear(h, cfg.vocab_size, "lm_head")
    tok_spec = P(("dp",) if shard_dp else None, "sp" if shard_sp else None)
    tokens.sharding = tok_spec
    avg_loss = None
    if targets is not None:
        targets.sharding = tok_spec
        if fused_head_chunk:
            loss = tfl.fused_head_cross_entropy(
                h, targets, cfg.vocab_size, chunk_size=fused_head_chunk,
                head_name="lm_head")
        else:
            loss = layers.softmax_with_cross_entropy(logits, targets)
        avg_loss = layers.mean(loss)
        if aux_losses:
            total_aux = aux_losses[0]
            for a in aux_losses[1:]:
                total_aux = layers.elementwise_add(total_aux, a)
            avg_loss = layers.elementwise_add(
                avg_loss, layers.scale(total_aux, cfg.moe_aux_weight))
    # the specs go on after every parameter exists (the fused head makes
    # lm_head inside the loss)
    if shard_tp:
        for name, spec in _tp_spec_table(cfg).items():
            if name in gb.vars:
                gb.vars[name].sharding = spec
    return logits, avg_loss


def _tp_spec_table(cfg):
    """Megatron splits: qkv/gate/up column-parallel, o/down row-parallel,
    embedding + lm_head vocab/column split."""
    table = {"tok_emb": P(None, "tp"), "lm_head": P(None, "tp")}
    for i in range(cfg.n_layers):
        table[f"l{i}.wq"] = P(None, "tp")
        table[f"l{i}.wk"] = P(None, "tp")
        table[f"l{i}.wv"] = P(None, "tp")
        table[f"l{i}.wo"] = P("tp", None)
        table[f"l{i}.w_gate"] = P(None, "tp")
        table[f"l{i}.w_up"] = P(None, "tp")
        table[f"l{i}.w_down"] = P("tp", None)
    return table


# the generator's Megatron splits on the stacked [L, in, out] weights
# over 'tp'; MoE experts split inside each expert (hidden dim), the
# router replicated
_GEN_TP_SPECS = {
    "blocks.wq": P(None, None, "tp"), "blocks.wk": P(None, None, "tp"),
    "blocks.wv": P(None, None, "tp"), "blocks.wo": P(None, "tp", None),
    "blocks.w_gate": P(None, None, "tp"), "blocks.w_up": P(None, None, "tp"),
    "blocks.w_down": P(None, "tp", None),
    "blocks.moe_w_gate": P(None, None, None, "tp"),
    "blocks.moe_w_up": P(None, None, None, "tp"),
    "blocks.moe_w_down": P(None, None, "tp", None),
    "tok_emb": P(None, "tp"), "lm_head": P(None, "tp")}


def build_llama_generator(cfg, tokens, max_new_tokens,
                          temperature=0.0, top_k=0, top_p=1.0,
                          quantize=False, eos_id=None, pad_id=0,
                          shard_tp=False, shard_dp=False,
                          unroll_layers=False, decode_unroll=1,
                          kv_int8=False, return_probs=False):
    """KV-cache generation program for a model trained with
    ``build_llama(shard_pp=True)`` (the layer-stacked weight layout):
    build it in its OWN program and run it with the trained scope —
    parameter names match, so there is no conversion step (a per-layer
    scope converts with :func:`stack_generator_weights`). Returns the
    [batch, prompt + max_new] token variable; with ``return_probs``,
    ``(tokens, probs)``, ``probs`` being the first decode step's [batch,
    vocab] distribution from the prefill cache alone. MoE configs decode
    with the drop-free top-k routing of training's test mode.
    ``shard_tp`` annotates the Megatron splits of the stacked weights
    over 'tp' and ``shard_dp`` the batch over 'dp', for
    ``parallel.ParallelExecutor``."""
    out = tfl.llama_generate(
        tokens, vocab_size=cfg.vocab_size, dim=cfg.dim,
        n_layers=cfg.n_layers, n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads, ffn_hidden=cfg.ffn_hidden,
        max_new_tokens=max_new_tokens, rope_base=cfg.rope_base,
        epsilon=cfg.norm_eps, dtype=cfg.dtype,
        temperature=temperature, top_k=top_k, top_p=top_p,
        name="blocks", quantize=quantize, eos_id=eos_id, pad_id=pad_id,
        moe_experts=cfg.moe_experts, moe_top_k=cfg.moe_top_k,
        unroll_layers=unroll_layers, decode_unroll=decode_unroll,
        kv_int8=kv_int8, return_probs=return_probs)
    gen = out[0] if return_probs else out
    if shard_tp:
        gb = tokens.block.program.global_block()
        for name, spec in _GEN_TP_SPECS.items():
            if name in gb.vars:
                gb.vars[name].sharding = spec
    if shard_dp:
        tokens.sharding = P("dp", None)
        gen.sharding = P("dp", None)
    return out


def build_llama_spec_generator(cfg, draft_cfg, tokens, max_new_tokens,
                               gamma=4, unroll_layers=False,
                               temperature=0.0, top_k=0, top_p=1.0,
                               eos_id=None, pad_id=0,
                               return_stats=False,
                               name="blocks", draft_name="draft"):
    """Speculative decoding: ``draft_cfg`` (a smaller LlamaConfig)
    proposes ``gamma`` tokens a round and ``cfg`` (the target) verifies
    them in one cached forward. At ``temperature`` 0 the tokens are
    exactly ``build_llama_generator(cfg, ...)``'s greedy output; above
    it, speculative sampling, distributed as the plain generator's
    sampler. Target weights use the trained ``build_llama`` names, the
    draft's ``{draft_name}.*`` (:func:`copy_weights_as_draft` aliases the
    target there). ``return_stats`` returns (tokens, rounds, emitted):
    (emitted - 1) / rounds against the gamma + 1 ceiling is the achieved
    speculation efficiency. int8 scopes (refused when run) and MoE
    configs go through ``build_llama_generator``."""
    if cfg.vocab_size != draft_cfg.vocab_size:
        raise ValueError(
            f"target and draft must share a vocabulary: "
            f"{cfg.vocab_size} vs {draft_cfg.vocab_size}")
    if cfg.moe_experts or draft_cfg.moe_experts:
        raise NotImplementedError(
            "speculative decoding with MoE configs is not implemented "
            "(the dense path is; route MoE serving through "
            "build_llama_generator)")
    return tfl.llama_spec_generate(
        tokens, vocab_size=cfg.vocab_size,
        max_new_tokens=max_new_tokens, gamma=gamma,
        temperature=temperature, top_k=top_k, top_p=top_p,
        return_stats=return_stats,
        dim=cfg.dim, n_layers=cfg.n_layers, n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads, ffn_hidden=cfg.ffn_hidden,
        draft_dim=draft_cfg.dim, draft_n_layers=draft_cfg.n_layers,
        draft_n_heads=draft_cfg.n_heads,
        draft_n_kv_heads=draft_cfg.n_kv_heads,
        draft_ffn_hidden=draft_cfg.ffn_hidden,
        rope_base=cfg.rope_base, epsilon=cfg.norm_eps, dtype=cfg.dtype,
        # the draft keeps its own rope base, epsilon and dtype
        draft_rope_base=draft_cfg.rope_base,
        draft_epsilon=draft_cfg.norm_eps, draft_dtype=draft_cfg.dtype,
        unroll_layers=unroll_layers, eos_id=eos_id, pad_id=pad_id,
        name=name, draft_name=draft_name)


class PagedDecodePrograms:
    """The step-function program set the continuous-batching decode
    engine runs (serving/decode_engine.py): one prefill program per
    prompt-length bucket, one decode-step program, and optionally one
    speculative-round program — every shape in them static, so the
    whole set compiles exactly once per (model config, max_batch) and
    never again as requests churn through the slots (in the port: one
    step build each).

    ``prefill`` maps bucket length -> a bundle dict with the program,
    feed var names, and fetch vars; ``decode``/``spec`` are single
    bundles. ``kv_shape`` (and ``draft_kv_shape`` when spec) are the
    [L, n_pages, page_size, n_kv, head_dim] pool shapes the engine
    allocates on its device and feeds to every dispatch."""

    def __init__(self, cfg, draft_cfg, page_size, pages_per_seq,
                 n_pages, max_batch, prefill, decode, spec, kv_shape,
                 draft_kv_shape, kv_dtype, draft_kv_dtype,
                 draft_prefill=None, chunk=None, chunk_size=None):
        self.cfg = cfg
        self.draft_cfg = draft_cfg
        self.page_size = page_size
        self.pages_per_seq = pages_per_seq
        self.n_pages = n_pages
        self.max_batch = max_batch
        self.seq_capacity = pages_per_seq * page_size
        self.prefill = prefill
        self.draft_prefill = draft_prefill
        self.decode = decode
        self.spec = spec
        self.chunk = chunk              # chunked-prefill bundle or None
        self.chunk_size = chunk_size
        self.kv_shape = kv_shape
        self.draft_kv_shape = draft_kv_shape
        self.kv_dtype = kv_dtype
        self.draft_kv_dtype = draft_kv_dtype


def build_llama_paged_programs(cfg, *, max_batch, page_size, n_pages,
                               pages_per_seq, prompt_buckets,
                               decode_block=1, prefill_batch=1,
                               quantize=False, draft_cfg=None,
                               gamma=4, chunk_size=None):
    """Builds the paged-KV step programs for ``cfg`` (dense configs
    only): prefill-into-slot per prompt bucket, a ``decode_block``-step
    decode program, and (with ``draft_cfg``) a speculative-round
    program. Parameter names are the generator serving layout
    (``blocks.* / tok_emb / final_norm / lm_head``, draft under
    ``draft.*``), so a scope prepared for ``build_llama_generator`` —
    trained, stacked, optionally ``quantize_generator_weights``'d —
    serves these programs directly. The scope must already hold the
    weights: the throwaway startup programs built here are never
    returned, by design (the engine never initializes weights)."""
    if cfg.moe_experts > 0 or (draft_cfg is not None
                               and draft_cfg.moe_experts > 0):
        raise NotImplementedError(
            "the paged decode engine serves dense configs; route MoE "
            "serving through build_llama_generator")
    if draft_cfg is not None and quantize:
        raise NotImplementedError(
            "speculative paged decoding is float-only (same design-out "
            "as llama_spec_generate); drop quantize or draft_cfg")
    if draft_cfg is not None and draft_cfg.vocab_size != cfg.vocab_size:
        raise ValueError(
            f"target and draft must share a vocabulary: "
            f"{cfg.vocab_size} vs {draft_cfg.vocab_size}")
    from ..core import framework
    hd = cfg.dim // cfg.n_heads
    kv_shape = [cfg.n_layers, n_pages, page_size, cfg.n_kv_heads, hd]
    common = dict(vocab_size=cfg.vocab_size, dim=cfg.dim,
                  n_layers=cfg.n_layers, n_heads=cfg.n_heads,
                  n_kv_heads=cfg.n_kv_heads, ffn_hidden=cfg.ffn_hidden,
                  page_size=page_size, rope_base=cfg.rope_base,
                  epsilon=cfg.norm_eps, dtype=cfg.dtype)

    def _data(name, shape, dtype):
        return layers.data(name=name, shape=list(shape), dtype=dtype,
                           append_batch_size=False)

    prefill = {}
    pb = max(1, int(prefill_batch))
    for bucket in sorted(set(int(b) for b in prompt_buckets)):
        main = framework.Program()
        with framework.program_guard(main, framework.Program()), \
                framework.unique_name.guard():
            tokens = _data("pp_tokens", [pb, bucket], "int64")
            lens = _data("pp_lens", [pb], "int32")
            table = _data("pp_table", [pb, pages_per_seq], "int32")
            kp = _data("pp_kpages", kv_shape, cfg.dtype)
            vp = _data("pp_vpages", kv_shape, cfg.dtype)
            nxt, kp_out, vp_out = tfl.llama_paged_prefill(
                tokens, lens, table, kp, vp, quantize=quantize,
                **common)
        prefill[bucket] = {
            "program": main.clone(for_test=True),
            "feeds": ("pp_tokens", "pp_lens", "pp_table",
                      "pp_kpages", "pp_vpages"),
            "fetch": [nxt, kp_out, vp_out]}

    main = framework.Program()
    with framework.program_guard(main, framework.Program()), \
            framework.unique_name.guard():
        tokens = _data("dc_tokens", [max_batch], "int64")
        positions = _data("dc_positions", [max_batch], "int32")
        table = _data("dc_table", [max_batch, pages_per_seq], "int32")
        kp = _data("dc_kpages", kv_shape, cfg.dtype)
        vp = _data("dc_vpages", kv_shape, cfg.dtype)
        out, kp_out, vp_out = tfl.llama_paged_decode(
            tokens, positions, table, kp, vp, steps=decode_block,
            quantize=quantize, **common)
    decode = {"program": main.clone(for_test=True),
              "feeds": ("dc_tokens", "dc_positions", "dc_table",
                        "dc_kpages", "dc_vpages"),
              "fetch": [out, kp_out, vp_out]}

    chunk = None
    if chunk_size is not None:
        # chunked prefill: ONE executable for every slice of every
        # prompt — batch 1 (a chunk is one request's slice; slices of
        # different requests are separate dispatches so admission stays
        # per-request), width `chunk_size`, per-row offset fed as data.
        # Partial final slices ride the same shape via Lens padding,
        # so chunk churn can never trigger a recompile.
        cs = int(chunk_size)
        if cs < 1:
            raise ValueError(f"chunk_size must be >= 1, got {cs}")
        main = framework.Program()
        with framework.program_guard(main, framework.Program()), \
                framework.unique_name.guard():
            tokens = _data("ck_tokens", [1, cs], "int64")
            lens = _data("ck_lens", [1], "int32")
            offsets = _data("ck_offsets", [1], "int32")
            table = _data("ck_table", [1, pages_per_seq], "int32")
            kp = _data("ck_kpages", kv_shape, cfg.dtype)
            vp = _data("ck_vpages", kv_shape, cfg.dtype)
            nxt, kp_out, vp_out = tfl.llama_paged_prefill_chunk(
                tokens, lens, offsets, table, kp, vp,
                quantize=quantize, **common)
        chunk = {"program": main.clone(for_test=True),
                 "feeds": ("ck_tokens", "ck_lens", "ck_offsets",
                           "ck_table", "ck_kpages", "ck_vpages"),
                 "fetch": [nxt, kp_out, vp_out]}

    spec = None
    draft_prefill = None
    draft_kv_shape = None
    if draft_cfg is not None:
        d_hd = draft_cfg.dim // draft_cfg.n_heads
        draft_kv_shape = [draft_cfg.n_layers, n_pages, page_size,
                          draft_cfg.n_kv_heads, d_hd]
        # the draft prefills its own paged cache over the same prompt
        # (and the same page indices — one table serves both pools)
        draft_prefill = {}
        for bucket in sorted(set(int(b) for b in prompt_buckets)):
            main = framework.Program()
            with framework.program_guard(main, framework.Program()), \
                    framework.unique_name.guard():
                tokens = _data("dp_tokens", [pb, bucket], "int64")
                lens = _data("dp_lens", [pb], "int32")
                table = _data("dp_table", [pb, pages_per_seq], "int32")
                kp = _data("dp_kpages", draft_kv_shape, draft_cfg.dtype)
                vp = _data("dp_vpages", draft_kv_shape, draft_cfg.dtype)
                nxt, kp_out, vp_out = tfl.llama_paged_prefill(
                    tokens, lens, table, kp, vp,
                    vocab_size=draft_cfg.vocab_size, dim=draft_cfg.dim,
                    n_layers=draft_cfg.n_layers,
                    n_heads=draft_cfg.n_heads,
                    n_kv_heads=draft_cfg.n_kv_heads,
                    ffn_hidden=draft_cfg.ffn_hidden,
                    page_size=page_size, rope_base=draft_cfg.rope_base,
                    epsilon=draft_cfg.norm_eps, dtype=draft_cfg.dtype,
                    name="draft", emb_name="draft.tok_emb",
                    final_norm_name="draft.final_norm",
                    head_name="draft.lm_head")
            draft_prefill[bucket] = {
                "program": main.clone(for_test=True),
                "feeds": ("dp_tokens", "dp_lens", "dp_table",
                          "dp_kpages", "dp_vpages"),
                "fetch": [nxt, kp_out, vp_out]}
        main = framework.Program()
        with framework.program_guard(main, framework.Program()), \
                framework.unique_name.guard():
            tokens = _data("sp_tokens", [max_batch], "int64")
            prev = _data("sp_prev", [max_batch], "int64")
            positions = _data("sp_positions", [max_batch], "int32")
            table = _data("sp_table", [max_batch, pages_per_seq],
                          "int32")
            kp = _data("sp_kpages", kv_shape, cfg.dtype)
            vp = _data("sp_vpages", kv_shape, cfg.dtype)
            dkp = _data("sp_draft_kpages", draft_kv_shape,
                        draft_cfg.dtype)
            dvp = _data("sp_draft_vpages", draft_kv_shape,
                        draft_cfg.dtype)
            spec_common = dict(common)
            del spec_common["dtype"]
            outs = tfl.llama_paged_spec_step(
                tokens, prev, positions, table, kp, vp, dkp, dvp,
                draft_dim=draft_cfg.dim,
                draft_n_layers=draft_cfg.n_layers,
                draft_n_heads=draft_cfg.n_heads,
                draft_n_kv_heads=draft_cfg.n_kv_heads,
                draft_ffn_hidden=draft_cfg.ffn_hidden,
                gamma=gamma, dtype=cfg.dtype,
                draft_rope_base=draft_cfg.rope_base,
                draft_epsilon=draft_cfg.norm_eps,
                draft_dtype=draft_cfg.dtype, **spec_common)
        spec = {"program": main.clone(for_test=True),
                "feeds": ("sp_tokens", "sp_prev", "sp_positions",
                          "sp_table", "sp_kpages", "sp_vpages",
                          "sp_draft_kpages", "sp_draft_vpages"),
                "fetch": list(outs)}

    return PagedDecodePrograms(
        cfg, draft_cfg, page_size, pages_per_seq, n_pages, max_batch,
        prefill, decode, spec, kv_shape, draft_kv_shape,
        cfg.dtype, None if draft_cfg is None else draft_cfg.dtype,
        draft_prefill=draft_prefill, chunk=chunk,
        chunk_size=None if chunk is None else int(chunk_size))


# scope-name suffixes of the layer-stacked generator weights (the
# lowercase twins of ops/transformer_ops._STACK_SLOTS) plus the singleton
# tensors: the full tensor set a generator serves from
GENERATOR_STACK_SUFFIXES = ("attn_norm", "wq", "wk", "wv", "wo",
                            "mlp_norm", "w_gate", "w_up", "w_down")
GENERATOR_SINGLETON_NAMES = ("tok_emb", "final_norm", "lm_head")
_QUANT_SUFFIXES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
# columns of the lm head quantized at once (bounds the float32 temporary)
_HEAD_CHUNK = 16384


def _scope(scope):
    from ..core.executor import global_scope
    return scope or global_scope()


def _tensor(v):
    from ..core.executor import global_value
    v = global_value(v)
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(
        np.asarray(v))


def copy_weights_as_draft(scope, name="blocks", draft_name="draft"):
    """Alias the target generator's tensors under the ``{draft_name}.*``
    names llama_spec_generate reads — the 'perfect draft' arrangement
    (acceptance ~1). No tensor is copied."""
    for suffix in GENERATOR_STACK_SUFFIXES:
        scope.set(f"{draft_name}.{suffix}",
                  scope.find_var(f"{name}.{suffix}"))
    for nm in GENERATOR_SINGLETON_NAMES:
        scope.set(f"{draft_name}.{nm}", scope.find_var(nm))


def stack_generator_weights(cfg, scope=None, name="blocks"):
    """Convert a scope trained with the PER-LAYER weight layout (the
    unstacked ``build_llama`` path) into the layer-stacked ``{name}.*``
    tensors the generator reads: ``l{i}.wq [d, H*hd]`` -> ``blocks.wq
    [L, d, H*hd]`` etc., on the weights' own device. Norms and MoE
    tables stack the same way (``l{i}.moe.router`` -> ``blocks.
    moe_router`` [L, d, E], the expert tables [L, E, ...]). The per-layer
    entries stay in the scope."""
    scope = _scope(scope)

    def stack(fmt):
        rows = []
        for i in range(cfg.n_layers):
            v = scope.find_var(fmt.format(i=i))
            if v is None:
                raise KeyError(f"missing trained weight {fmt.format(i=i)}")
            rows.append(_tensor(v))
        return torch.stack(rows)

    suffixes = ["attn_norm", "wq", "wk", "wv", "wo", "mlp_norm"]
    if cfg.moe_experts > 0:
        for stacked, per_layer in (("moe_router", "moe.router"),
                                   ("moe_w_gate", "moe.w_gate"),
                                   ("moe_w_up", "moe.w_up"),
                                   ("moe_w_down", "moe.w_down")):
            scope.set(f"{name}.{stacked}", stack("l{i}." + per_layer))
    else:
        suffixes += ["w_gate", "w_up", "w_down"]
    for sfx in suffixes:
        scope.set(f"{name}.{sfx}", stack("l{i}." + sfx))


def _quantize_columns(w):
    """Symmetric int8 of ``w`` [in, out] with one scale per output
    column (the reference's numpy recipe: absmax / 127 in float32, at
    least 1e-10, then round half to even and clip to [-127, 127]; both
    divisions by a tensor, so bit for bit the recipe's on either
    device). Returns (int8 [in, out], float32 [1, out])."""
    m = w.abs().amax(dim=0, keepdim=True).float()
    scale = torch.clamp(m / torch.full_like(m, 127.0), min=1e-10)
    q = torch.round(w.float() / scale).clamp_(-127, 127).to(torch.int8)
    return q, scale


def quantize_generator_weights(scope=None, name="blocks",
                               head_name="lm_head"):
    """Rewrite a trained scope's stacked decoder matmul weights and lm
    head to int8 (symmetric, per layer x output channel) with
    ``<w>@scale`` float32 companions — the serving scope of
    ``build_llama_generator(..., quantize=True)``. Embedding and norm
    weights stay float. Works on each tensor's own device, one layer (and
    one block of head columns) at a time, so the float32 temporaries stay
    a layer's size; the int8 values and scales are the reference's numpy
    recipe bit for bit. The scope's entries are replaced, not written
    into: a tensor another scope also holds keeps its float values. An
    MoE scope's expert stacks [L, E, in, out] get one scale per layer x
    expert x output channel ([L, E, 1, out]); its router stays float."""
    scope = _scope(scope)
    moe = scope.find_var(f"{name}.moe_router") is not None
    suffixes = (("wq", "wk", "wv", "wo", "moe_w_gate", "moe_w_up",
                 "moe_w_down") if moe else _QUANT_SUFFIXES)
    for suffix in suffixes:
        n = f"{name}.{suffix}"
        v = scope.find_var(n)
        if v is None:
            raise KeyError(
                f"missing {n!r} in scope — run the startup program (or "
                "stack_generator_weights on a trained per-layer scope) "
                "before quantize_generator_weights")
        w = _tensor(v)                      # [L, in, out] / [L, E, in, out]
        wq = torch.empty(w.shape, dtype=torch.int8, device=w.device)
        scale = torch.empty(w.shape[:-2] + (1, w.shape[-1]),
                            dtype=torch.float32, device=w.device)
        for idx in np.ndindex(*w.shape[:-2]):
            wq[idx], scale[idx] = _quantize_columns(w[idx])
        scope.set(n, wq)
        scope.set(n + "@scale", scale)      # [L, 1, out] / [L, E, 1, out]
    head = _tensor(scope.find_var(head_name))           # [D, V]
    hq = torch.empty(head.shape, dtype=torch.int8, device=head.device)
    hscale = torch.empty(head.shape[1], dtype=torch.float32,
                         device=head.device)
    for c in range(0, head.shape[1], _HEAD_CHUNK):
        hq[:, c:c + _HEAD_CHUNK], sc = _quantize_columns(
            head[:, c:c + _HEAD_CHUNK])
        hscale[c:c + _HEAD_CHUNK] = sc[0]
    scope.set(head_name, hq)
    scope.set(head_name + "@scale", hscale)             # [V]


def save_decode_model(dirname, cfg, scope):
    """Persist a decode-servable model: the LlamaConfig as JSON
    (``llama_config.json``) and every scope tensor in one ``params.npz``
    (bfloat16 as numpy writes the reference's: ``weights.savez``)."""
    os.makedirs(dirname, exist_ok=True)
    with open(os.path.join(dirname, "llama_config.json"), "w") as f:
        json.dump(asdict(cfg), f, indent=1, sort_keys=True)
    params = {n: scope.find_var(n) for n in scope.keys()
              if scope.find_var(n) is not None}
    _weights.savez(os.path.join(dirname, "params.npz"), params)
    return dirname


def load_decode_model(dirname):
    """Load a :func:`save_decode_model` directory (the port's or the
    reference's) back into ``(LlamaConfig, Scope)`` with host tensors,
    which the executor stages to its device at its first run. A 2-byte
    void array is a bfloat16 array as numpy writes one."""
    from ..core.executor import Scope
    with open(os.path.join(dirname, "llama_config.json")) as f:
        cfg = LlamaConfig(**json.load(f))
    scope = Scope()
    with np.load(os.path.join(dirname, "params.npz")) as blobs:
        for n in blobs.files:
            arr = blobs[n]
            scope.set(n, _weights.array_to_tensor(
                arr, torch.device("cpu"),
                dtype="bfloat16" if arr.dtype.kind == "V" else None))
    return cfg, scope
