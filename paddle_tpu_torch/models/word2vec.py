"""word2vec N-gram language model (port of
``paddle_tpu/models/word2vec.py``) — capability parity with the book
example (reference python/paddle/fluid/tests/book/test_word2vec.py):
embed N context words with a shared table, concat, hidden layer,
softmax over the vocabulary.
"""
from .. import layers
from ..param_attr import ParamAttr

__all__ = ["build_word2vec"]


def build_word2vec(context_words, next_word, dict_size, embed_size=32,
                   hidden_size=256, is_sparse=False):
    """context_words: list of int64 data vars [batch, 1]; next_word:
    int64 [batch, 1]. All context slots share one embedding table.
    Returns (predict_probs, avg_loss)."""
    embeds = [layers.embedding(w, size=[dict_size, embed_size],
                               is_sparse=is_sparse, dtype="float32",
                               param_attr=ParamAttr(name="shared_w"))
              for w in context_words]
    concat = layers.concat(input=embeds, axis=1)
    hidden = layers.fc(input=concat, size=hidden_size, act="sigmoid")
    predict = layers.fc(input=hidden, size=dict_size, act="softmax")
    loss = layers.cross_entropy(input=predict, label=next_word)
    return predict, layers.mean(loss)
