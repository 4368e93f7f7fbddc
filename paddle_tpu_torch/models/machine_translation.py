"""Seq2seq attention machine translation (port of
``paddle_tpu/models/machine_translation.py``; parity with
benchmark/fluid/models/machine_translation.py): bidirectional GRU
encoder, Bahdanau-style attention, GRU decoder with teacher forcing
(train, a DynamicRNN) and greedy decode (inference, a StaticRNN).
"""
from .. import layers

__all__ = ["seq_to_seq_net", "greedy_decode"]


def _encoder(src_word_idx, src_dict_size, embedding_dim, encoder_size):
    src_embedding = layers.embedding(
        input=src_word_idx, size=[src_dict_size, embedding_dim])
    fwd_proj = layers.fc(input=src_embedding, size=encoder_size * 3,
                         bias_attr=False)
    fwd_proj.lod_level = 1
    src_forward = layers.dynamic_gru(input=fwd_proj, size=encoder_size)
    bwd_proj = layers.fc(input=src_embedding, size=encoder_size * 3,
                         bias_attr=False)
    bwd_proj.lod_level = 1
    src_reversed = layers.dynamic_gru(input=bwd_proj, size=encoder_size,
                                      is_reverse=True)
    encoded = layers.concat([src_forward, src_reversed], axis=-1)
    return encoded


def _attention(decoder_state, encoder_vec, encoder_proj):
    """Bahdanau attention over the padded encoder sequence
    (reference machine_translation.py simple_attention)."""
    decoder_state_proj = layers.fc(input=decoder_state,
                                   size=int(encoder_proj.shape[-1]),
                                   bias_attr=False)
    decoder_state_expand = layers.sequence_expand(x=decoder_state_proj,
                                                  y=encoder_proj)
    concated = layers.elementwise_add(encoder_proj, decoder_state_expand)
    concated.lod_level = 1
    tanh = layers.tanh(concated)
    tanh.lod_level = 1
    attention_weights = layers.fc(input=tanh, size=1,
                                  bias_attr=False)
    attention_weights.lod_level = 1
    attention_weights = layers.sequence_softmax(input=attention_weights)
    scaled = layers.elementwise_mul(encoder_vec, attention_weights)
    scaled.lod_level = 1
    context = layers.sequence_pool(input=scaled, pool_type="sum")
    return context


def seq_to_seq_net(src_word_idx, trg_word_idx, label, src_dict_size,
                   trg_dict_size, embedding_dim=512, encoder_size=512,
                   decoder_size=512):
    """Teacher-forced training graph. src/trg/label are lod-level-1 int64
    data vars; label is trg shifted by one."""
    encoded = _encoder(src_word_idx, src_dict_size, embedding_dim,
                       encoder_size)
    encoder_proj = layers.fc(input=encoded, size=decoder_size,
                             bias_attr=False)
    encoder_proj.lod_level = 1
    enc_last = layers.sequence_last_step(input=encoded)
    decoder_boot = layers.fc(input=enc_last, size=decoder_size,
                             act="tanh", bias_attr=False)

    trg_embedding = layers.embedding(
        input=trg_word_idx, size=[trg_dict_size, embedding_dim])

    rnn = layers.DynamicRNN()
    with rnn.block():
        current_word = rnn.step_input(trg_embedding)
        mem = rnn.memory(init=decoder_boot)
        context = _attention(mem, encoded, encoder_proj)
        fc_in = layers.concat([context, current_word], axis=1)
        decoder_inputs = layers.fc(input=fc_in,
                                   size=decoder_size * 3, bias_attr=False)
        h, _, _ = layers.gru_unit(input=decoder_inputs, hidden=mem,
                                  size=decoder_size * 3)
        rnn.update_memory(mem, h)
        out = layers.fc(input=h, size=trg_dict_size, act="softmax")
        rnn.step_output(out)
    prediction = rnn()
    cost = layers.cross_entropy(input=prediction, label=label)
    cost.lod_level = 1
    avg_cost = layers.mean(layers.sequence_pool(cost, "sum"))
    return avg_cost, prediction


def greedy_decode(src_word_idx, src_dict_size, trg_dict_size, max_len,
                  embedding_dim=512, encoder_size=512, decoder_size=512,
                  bos_id=0):
    """Greedy inference decode: fixed max_len scan feeding back the argmax
    token (the padded-representation analogue of the reference's
    while_op+beam_search decoder)."""
    encoded = _encoder(src_word_idx, src_dict_size, embedding_dim,
                       encoder_size)
    encoder_proj = layers.fc(input=encoded, size=decoder_size,
                             bias_attr=False)
    encoder_proj.lod_level = 1
    enc_last = layers.sequence_last_step(input=encoded)
    decoder_boot = layers.fc(input=enc_last, size=decoder_size,
                             act="tanh", bias_attr=False)
    bos = layers.fill_constant_batch_size_like(
        input=enc_last, shape=[-1, 1], dtype="int64", value=bos_id)

    rnn = layers.StaticRNN(masked=False)
    # drive the scan for max_len steps with a dummy step input
    steps = layers.fill_constant_batch_size_like(
        input=enc_last, shape=[-1, max_len, 1], dtype="float32", value=0.0)
    with rnn.step():
        _ = rnn.step_input(steps)
        mem = rnn.memory(init=decoder_boot)
        word = rnn.memory(init=bos)
        word_int = layers.cast(word, "int64")
        emb = layers.embedding(input=word_int,
                               size=[trg_dict_size, embedding_dim],
                               param_attr="decode_emb")
        context = _attention(mem, encoded, encoder_proj)
        fc_in = layers.concat([context, emb], axis=1)
        decoder_inputs = layers.fc(input=fc_in, size=decoder_size * 3,
                                   bias_attr=False)
        h, _, _ = layers.gru_unit(input=decoder_inputs, hidden=mem,
                                  size=decoder_size * 3)
        logits = layers.fc(input=h, size=trg_dict_size)
        next_word = layers.argmax(logits, axis=-1)
        next_word = layers.reshape(layers.cast(next_word, "int64"), [-1, 1])
        rnn.update_memory(mem, h)
        rnn.update_memory(word, next_word)
        rnn.step_output(next_word)
    tokens = rnn()
    return tokens
