"""Semantic role labeling model (port of
``paddle_tpu/models/label_semantic_roles.py``; capability parity with
the book chapter-7 example, reference
python/paddle/fluid/tests/book/test_label_semantic_roles.py:52 db_lstm):
eight sequence features (word, predicate, five context windows, mark)
are embedded, mixed with per-feature projections, run through a stack of
alternating-direction LSTMs with direct edges, and scored per tag; the
cost is a linear-chain CRF over the emission scores with Viterbi
decoding at inference. Sequences arrive as SequenceBatch (padded dense
+ lengths); the LSTMs and the CRF recursions are masked loops over the
padded axis.
"""
from .. import layers
from ..param_attr import ParamAttr

__all__ = ["db_lstm"]


def db_lstm(word, predicate, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2, mark,
            word_dict_len, label_dict_len, pred_dict_len, mark_dict_len=2,
            word_dim=32, mark_dim=5, hidden_dim=512, depth=8,
            is_sparse=False, embedding_name="emb", hidden_act=None):
    """All inputs are int64 sequence vars (lod_level=1, shape [.., 1]).
    Returns the per-position emission scores [sum_len, label_dict_len]
    (feed to linear_chain_crf / crf_decoding).

    ``hidden_act`` applies to the hidden_0/mix_hidden projections: the
    book test (test_label_semantic_roles.py:81) leaves them linear, the
    high-level-api variant passes "tanh" — default matches the former.
    """
    predicate_embedding = layers.embedding(
        input=predicate, size=[pred_dict_len, word_dim], dtype="float32",
        is_sparse=is_sparse, param_attr="vemb")
    mark_embedding = layers.embedding(
        input=mark, size=[mark_dict_len, mark_dim], dtype="float32",
        is_sparse=is_sparse)

    word_input = [word, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2]
    # the six word-position features share one (optionally pretrained,
    # frozen) table, as in the reference
    emb_layers = [
        layers.embedding(
            input=x, size=[word_dict_len, word_dim], dtype="float32",
            is_sparse=is_sparse,
            param_attr=ParamAttr(name=embedding_name, trainable=False))
        for x in word_input
    ]
    emb_layers += [predicate_embedding, mark_embedding]

    hidden_0 = layers.sums(input=[
        layers.fc(input=emb, size=hidden_dim, act=hidden_act)
        for emb in emb_layers])
    hidden_0.lod_level = 1
    lstm_0, _ = layers.dynamic_lstm(
        input=hidden_0, size=hidden_dim, candidate_activation="relu",
        gate_activation="sigmoid", cell_activation="sigmoid")

    # stack L-LSTM and R-LSTM with direct edges
    input_tmp = [hidden_0, lstm_0]
    for i in range(1, depth):
        mix_hidden = layers.sums(input=[
            layers.fc(input=input_tmp[0], size=hidden_dim, act=hidden_act),
            layers.fc(input=input_tmp[1], size=hidden_dim, act=hidden_act),
        ])
        mix_hidden.lod_level = 1
        lstm, _ = layers.dynamic_lstm(
            input=mix_hidden, size=hidden_dim,
            candidate_activation="relu", gate_activation="sigmoid",
            cell_activation="sigmoid", is_reverse=(i % 2) == 1)
        input_tmp = [mix_hidden, lstm]

    feature_out = layers.sums(input=[
        layers.fc(input=input_tmp[0], size=label_dict_len, act="tanh"),
        layers.fc(input=input_tmp[1], size=label_dict_len, act="tanh"),
    ])
    feature_out.lod_level = 1
    return feature_out
