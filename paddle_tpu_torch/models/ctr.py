"""CTR models on the embedding path: DeepFM and wide&deep (port of
``paddle_tpu/models/ctr.py``; capability parity with the reference's
CTR workloads, whose embedding gradients are SelectedRows-style sparse
rows; here the lookup is a gather and its gradient a dense scatter-add
into the table, which the optimizer then updates whole).
"""
from .. import layers
from ..param_attr import ParamAttr
from .. import initializer as init_mod

__all__ = ["build_deepfm", "build_wide_deep"]


def _logloss(logit, label):
    loss = layers.sigmoid_cross_entropy_with_logits(logit, label)
    prob = layers.sigmoid(logit)
    return prob, layers.mean(loss)


def build_deepfm(feat_ids, label=None, num_features=100000, num_fields=23,
                 embed_size=8, hidden_sizes=(128, 64), is_sparse=True,
                 is_distributed=False):
    """DeepFM (Guo et al.): first-order weights + factorization-machine
    second-order interactions + deep MLP, all on one shared id space.

    feat_ids: int64 [batch, num_fields]; label: float32 [batch, 1].
    Returns (click_prob, avg_loss|None).

    ``is_distributed=True`` is the large-vocab deployment: both tables
    (and their optimizer state) shard row-wise over the mesh 'mp' axis —
    the mesh form of the reference's pserver distributed lookup table.
    """
    # first order: per-feature scalar weight
    w1 = layers.embedding(feat_ids, size=[num_features, 1],
                          is_sparse=is_sparse, dtype="float32",
                          is_distributed=is_distributed,
                          param_attr=ParamAttr(
                              name="fm_w1",
                              initializer=init_mod.Constant(0.0)))
    first = layers.reduce_sum(w1, dim=[1, 2], keep_dim=False)
    first = layers.reshape(first, [-1, 1])

    # second order: 0.5 * sum_k ((sum_i v_ik)^2 - sum_i v_ik^2)
    v = layers.embedding(feat_ids, size=[num_features, embed_size],
                         is_sparse=is_sparse, dtype="float32",
                         is_distributed=is_distributed,
                         param_attr=ParamAttr(
                             name="fm_v",
                             initializer=init_mod.Normal(0.0, 0.01)))
    sum_v = layers.reduce_sum(v, dim=1)                  # [b, k]
    sum_v_sq = layers.square(sum_v)
    sq_v_sum = layers.reduce_sum(layers.square(v), dim=1)
    second = layers.reduce_sum(
        layers.elementwise_sub(sum_v_sq, sq_v_sum), dim=1, keep_dim=True)
    second = layers.scale(second, scale=0.5)

    # deep: MLP over the concatenated field embeddings
    deep = layers.reshape(v, [-1, num_fields * embed_size])
    for i, h in enumerate(hidden_sizes):
        deep = layers.fc(deep, size=h, act="relu",
                         param_attr=ParamAttr(
                             name=f"deep_w{i}",
                             initializer=init_mod.Xavier()))
    deep_out = layers.fc(deep, size=1)

    logit = layers.elementwise_add(
        layers.elementwise_add(first, second), deep_out)
    if label is None:
        return layers.sigmoid(logit), None
    return _logloss(logit, label)


def build_wide_deep(wide_ids, deep_ids, label=None, num_features=100000,
                    embed_size=8, hidden_sizes=(128, 64), is_sparse=True):
    """wide&deep (Cheng et al.): a linear wide part over cross-feature
    ids joint-trained with a deep MLP over embedded ids.

    wide_ids/deep_ids: int64 [batch, n_wide] / [batch, n_deep].
    Returns (click_prob, avg_loss|None)."""
    wide_w = layers.embedding(wide_ids, size=[num_features, 1],
                              is_sparse=is_sparse, dtype="float32",
                              param_attr=ParamAttr(
                                  name="wide_w",
                                  initializer=init_mod.Constant(0.0)))
    wide = layers.reshape(
        layers.reduce_sum(wide_w, dim=[1, 2]), [-1, 1])

    n_deep = int(deep_ids.shape[1])
    emb = layers.embedding(deep_ids, size=[num_features, embed_size],
                           is_sparse=is_sparse, dtype="float32",
                           param_attr=ParamAttr(
                               name="deep_emb",
                               initializer=init_mod.Normal(0.0, 0.01)))
    deep = layers.reshape(emb, [-1, n_deep * embed_size])
    for i, h in enumerate(hidden_sizes):
        deep = layers.fc(deep, size=h, act="relu")
    deep_out = layers.fc(deep, size=1)

    logit = layers.elementwise_add(wide, deep_out)
    if label is None:
        return layers.sigmoid(logit), None
    return _logloss(logit, label)
