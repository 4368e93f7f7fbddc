"""Transformer encoder-decoder (Vaswani et al.) for sequence-to-sequence
tasks (port of ``paddle_tpu/models/transformer.py``): fluid layers
building multi-head attention, sinusoid position encoding, label
smoothing. Unbiased attention — the causal decoder self-attention, and
every attention when no source lengths are given — goes to
``multihead_attention`` and so to the flash kernels K1/K2/K3
(``ops/flash_attention.py``); padded encoder self-attention and
cross-attention take the explicit matmul + softmax path with an
additive bias.
"""
import math
from dataclasses import dataclass

import numpy as np

from .. import layers
from ..layers import transformer as tfl
from ..param_attr import ParamAttr
from .. import initializer as init_mod

__all__ = ["TransformerConfig", "TRANSFORMER_BASE", "TRANSFORMER_TINY",
           "build_transformer", "position_encoding"]


@dataclass
class TransformerConfig:
    src_vocab_size: int = 10000
    tgt_vocab_size: int = 10000
    max_length: int = 256
    d_model: int = 512
    n_head: int = 8
    n_encoder_layers: int = 6
    n_decoder_layers: int = 6
    d_ff: int = 2048
    dropout: float = 0.1
    label_smooth_eps: float = 0.1
    dtype: str = "float32"


TRANSFORMER_BASE = TransformerConfig()
TRANSFORMER_TINY = TransformerConfig(
    src_vocab_size=64, tgt_vocab_size=64, max_length=32, d_model=32,
    n_head=4, n_encoder_layers=2, n_decoder_layers=2, d_ff=64, dropout=0.0,
    label_smooth_eps=0.0)


def position_encoding(max_length, d_model):
    """Sinusoid table [max_length, d_model] (fixed, not trained)."""
    pos = np.arange(max_length, dtype=np.float64)[:, None]
    dim = np.arange(d_model // 2, dtype=np.float64)[None, :]
    angle = pos / np.power(10000.0, 2.0 * dim / d_model)
    table = np.zeros((max_length, d_model), dtype=np.float32)
    table[:, 0::2] = np.sin(angle)
    table[:, 1::2] = np.cos(angle)
    return table


def _proj(x, size, name):
    return layers.fc(x, size=size, num_flatten_dims=2, bias_attr=False,
                     param_attr=ParamAttr(
                         name=name, initializer=init_mod.Xavier()))


def _split_heads(x, n_head, head_dim):
    # [b, s, d] -> [b, h, s, hd]
    x = layers.reshape(x, [0, 0, n_head, head_dim])
    return layers.transpose(x, [0, 2, 1, 3])


def _attention(q_in, kv_in, cfg, name, causal=False, bias=None):
    """Multi-head attention. causal (no padding bias) lowers to the flash
    kernel; with an additive ``bias`` ([b, 1, 1, s_k], -inf at pads) the
    explicit scores path is used."""
    hd = cfg.d_model // cfg.n_head
    q = _proj(q_in, cfg.d_model, name + ".wq")
    k = _proj(kv_in, cfg.d_model, name + ".wk")
    v = _proj(kv_in, cfg.d_model, name + ".wv")
    if bias is None:
        q = layers.reshape(q, [0, 0, cfg.n_head, hd])
        k = layers.reshape(k, [0, 0, cfg.n_head, hd])
        v = layers.reshape(v, [0, 0, cfg.n_head, hd])
        out = tfl.multihead_attention(q, k, v, causal=causal)
        out = layers.reshape(out, [0, 0, cfg.d_model])
    else:
        qh = _split_heads(q, cfg.n_head, hd)
        kh = _split_heads(k, cfg.n_head, hd)
        vh = _split_heads(v, cfg.n_head, hd)
        scores = layers.matmul(qh, kh, transpose_y=True,
                               alpha=1.0 / math.sqrt(hd))
        scores = layers.elementwise_add(scores, bias)
        weights = layers.softmax(scores, axis=-1)
        if cfg.dropout:
            weights = layers.dropout(weights, cfg.dropout)
        out = layers.matmul(weights, vh)           # [b, h, s_q, hd]
        out = layers.transpose(out, [0, 2, 1, 3])
        out = layers.reshape(out, [0, 0, cfg.d_model])
    return _proj(out, cfg.d_model, name + ".wo")


def _ffn(x, cfg, name):
    h = layers.fc(x, size=cfg.d_ff, num_flatten_dims=2, act="relu",
                  param_attr=ParamAttr(name=name + ".w1",
                                       initializer=init_mod.Xavier()))
    if cfg.dropout:
        h = layers.dropout(h, cfg.dropout)
    return layers.fc(h, size=cfg.d_model, num_flatten_dims=2,
                     param_attr=ParamAttr(name=name + ".w2",
                                          initializer=init_mod.Xavier()))


def _add_norm(x, sub, cfg):
    if cfg.dropout:
        sub = layers.dropout(sub, cfg.dropout)
    return layers.layer_norm(layers.elementwise_add(x, sub),
                             begin_norm_axis=2)


def _embed(tokens, vocab, cfg, name):
    emb = layers.embedding(tokens, size=[vocab, cfg.d_model],
                           param_attr=ParamAttr(
                               name=name,
                               initializer=init_mod.Normal(
                                   0.0, cfg.d_model ** -0.5)),
                           dtype=cfg.dtype)
    emb = layers.scale(emb, scale=cfg.d_model ** 0.5)
    seq = int(tokens.shape[1])
    pos_table = layers.create_parameter(
        [cfg.max_length, cfg.d_model], cfg.dtype, name=name + ".pos",
        attr=ParamAttr(name=name + ".pos", trainable=False,
                       initializer=init_mod.NumpyArrayInitializer(
                           position_encoding(cfg.max_length, cfg.d_model))))
    pos = layers.slice(pos_table, axes=[0], starts=[0], ends=[seq])
    pos = layers.unsqueeze(pos, [0])
    out = layers.elementwise_add(emb, pos)
    if cfg.dropout:
        out = layers.dropout(out, cfg.dropout)
    return out


def _pad_bias(lengths, seq, dtype):
    """[b] lengths -> additive bias [b, 1, 1, seq]: 0 keep, -1e9 pad."""
    mask = layers.sequence_mask(lengths, maxlen=seq, dtype=dtype)
    bias = layers.scale(mask, scale=1e9, bias=-1e9)   # 1->0, 0->-1e9
    return layers.unsqueeze(bias, [1, 2])


def build_transformer(cfg, src_tokens, tgt_tokens, labels=None,
                      src_lengths=None, tgt_lengths=None):
    """Builds the enc-dec graph.

    src_tokens/tgt_tokens: int64 [batch, seq]. labels: int64 [batch, seq]
    (tgt shifted left). src_lengths: optional int64 [batch] for padding
    bias on encoder self-attention and decoder cross-attention.
    tgt_lengths: optional int64 [batch]; when given, the loss averages
    over valid target positions only (pads contribute nothing).
    Returns (logits, avg_loss|None).

    Note on attention dropout: the explicit biased path applies
    cfg.dropout to the attention weights; the flash-kernel path (causal
    decoder self-attention, and unbiased attention when src_lengths is
    None) does not, as in the reference, whose fused kernel has no
    attention dropout. Residual/FFN/embed dropout applies everywhere.
    """
    src_seq = int(src_tokens.shape[1])
    bias = None
    if src_lengths is not None:
        bias = _pad_bias(src_lengths, src_seq, cfg.dtype)

    # encoder
    enc = _embed(src_tokens, cfg.src_vocab_size, cfg, "src_emb")
    for i in range(cfg.n_encoder_layers):
        name = f"enc{i}"
        enc = _add_norm(enc, _attention(enc, enc, cfg, name + ".self",
                                        causal=False, bias=bias), cfg)
        enc = _add_norm(enc, _ffn(enc, cfg, name + ".ffn"), cfg)

    # decoder
    dec = _embed(tgt_tokens, cfg.tgt_vocab_size, cfg, "tgt_emb")
    for i in range(cfg.n_decoder_layers):
        name = f"dec{i}"
        dec = _add_norm(dec, _attention(dec, dec, cfg, name + ".self",
                                        causal=True), cfg)
        dec = _add_norm(dec, _attention(dec, enc, cfg, name + ".cross",
                                        causal=False, bias=bias), cfg)
        dec = _add_norm(dec, _ffn(dec, cfg, name + ".ffn"), cfg)

    logits = layers.fc(dec, size=cfg.tgt_vocab_size, num_flatten_dims=2,
                       bias_attr=False,
                       param_attr=ParamAttr(name="out_proj",
                                            initializer=init_mod.Xavier()))
    if labels is None:
        return logits, None

    flat_logits = layers.reshape(logits, [-1, cfg.tgt_vocab_size])
    flat_labels = layers.reshape(labels, [-1, 1])
    if cfg.label_smooth_eps:
        soft = layers.label_smooth(
            layers.one_hot(flat_labels, cfg.tgt_vocab_size),
            epsilon=cfg.label_smooth_eps, dtype=cfg.dtype)
        loss = layers.softmax_with_cross_entropy(flat_logits, soft,
                                                 soft_label=True)
    else:
        loss = layers.softmax_with_cross_entropy(flat_logits, flat_labels)
    if tgt_lengths is None:
        return logits, layers.mean(loss)
    tgt_seq = int(tgt_tokens.shape[1])
    weight = layers.sequence_mask(tgt_lengths, maxlen=tgt_seq,
                                  dtype=cfg.dtype)
    weight = layers.reshape(weight, [-1, 1])
    masked = layers.elementwise_mul(loss, weight)
    avg = layers.elementwise_div(layers.reduce_sum(masked),
                                 layers.reduce_sum(weight))
    return logits, avg
