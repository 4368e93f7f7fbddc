"""Personalized recommendation (movielens-style; port of
``paddle_tpu/models/recommender.py``) — capability parity with the book
example (reference python/paddle/fluid/tests/book/
test_recommender_system.py): twin towers embedding user features and
movie features into a shared space, scored by cosine similarity and
trained with square error against the rating.
"""
from .. import layers, nets
from ..param_attr import ParamAttr

__all__ = ["build_recommender", "DEFAULT_SIZES"]

# feature-space sizes: (user ids, genders, ages, jobs, movie ids,
# categories, title vocab); movielens ids are 1-based so tables hold
# max_id + 1 rows
DEFAULT_SIZES = dict(uid=6041, gender=2, age=7, job=21, mid=3953,
                     category=18, title=5175)


def _embed_fc(ids, vocab, embed_size=32, fc_size=32, is_sparse=False,
              name=None):
    emb = layers.embedding(ids, size=[vocab, embed_size],
                           is_sparse=is_sparse, dtype="float32",
                           param_attr=ParamAttr(name=name))
    return layers.fc(input=emb, size=fc_size)


def user_tower(uid, gender, age, job, sizes, is_sparse=False):
    feats = [_embed_fc(uid, sizes["uid"], name="user_table",
                       is_sparse=is_sparse),
             _embed_fc(gender, sizes["gender"], 16, 16,
                       name="gender_table", is_sparse=is_sparse),
             _embed_fc(age, sizes["age"], 16, 16, name="age_table",
                       is_sparse=is_sparse),
             _embed_fc(job, sizes["job"], 16, 16, name="job_table",
                       is_sparse=is_sparse)]
    concat = layers.concat(input=feats, axis=1)
    return layers.fc(input=concat, size=200, act="tanh")


def movie_tower(mid, categories, title, sizes, is_sparse=False):
    """categories/title are lod_level=1 sequence vars (variable number
    of category ids / title words per movie)."""
    mid_fc = _embed_fc(mid, sizes["mid"], name="movie_table",
                       is_sparse=is_sparse)
    cat_emb = layers.embedding(categories, size=[sizes["category"], 32],
                               is_sparse=is_sparse, dtype="float32",
                               param_attr=ParamAttr(name="category_table"))
    cat_pool = layers.sequence_pool(input=cat_emb, pool_type="sum")
    title_emb = layers.embedding(title, size=[sizes["title"], 32],
                                 is_sparse=is_sparse, dtype="float32",
                                 param_attr=ParamAttr(name="title_table"))
    title_conv = nets.sequence_conv_pool(input=title_emb, num_filters=32,
                                         filter_size=3, act="tanh",
                                         pool_type="sum")
    concat = layers.concat(input=[mid_fc, cat_pool, title_conv], axis=1)
    return layers.fc(input=concat, size=200, act="tanh")


def build_recommender(uid, gender, age, job, mid, categories, title,
                      rating=None, sizes=None, is_sparse=False):
    """Scalar id inputs are int64 [batch, 1]; categories/title are
    sequence (lod_level=1) int64 vars; rating float32 [batch, 1].
    Returns (scaled_score, avg_loss|None); score is cos_sim * 5 to match
    the 0-5 rating scale."""
    sizes = sizes or DEFAULT_SIZES
    usr = user_tower(uid, gender, age, job, sizes, is_sparse)
    mov = movie_tower(mid, categories, title, sizes, is_sparse)
    sim = layers.cos_sim(X=usr, Y=mov)
    scale_infer = layers.scale(x=sim, scale=5.0)
    if rating is None:
        return scale_infer, None
    loss = layers.square_error_cost(input=scale_infer, label=rating)
    return scale_infer, layers.mean(loss)
