"""MQ2007 learning-to-rank readers — reference
python/paddle/dataset/mq2007.py: LETOR 4.0 lines
``rel qid:N 1:v ... 46:v # comment`` grouped per query, served in
pointwise / pairwise / listwise forms.

Nothing downloads: reads ``Fold1/{train,test}.txt`` (the extracted MQ2007
layout) under DATA_HOME/MQ2007/; the reference extracts the same files
from MQ2007.rar. Synthetic ranking data is the fallback.
"""
import itertools
import os
import warnings

import numpy as np

from . import common

__all__ = ["train", "test", "Query", "QueryList"]

N_FEATURES = 46


class Query:
    """One query-document pair: relevance, qid, 46 dense features and
    the trailing comment (reference mq2007.py Query)."""

    def __init__(self, query_id=-1, relevance_score=-1,
                 feature_vector=None, description=""):
        self.query_id = query_id
        self.relevance_score = relevance_score
        self.feature_vector = feature_vector or []
        self.description = description

    def __str__(self):
        feats = " ".join(str(f) for f in self.feature_vector)
        return f"{self.relevance_score} {self.query_id} {feats}"

    @classmethod
    def parse(cls, text):
        comment_pos = text.find("#")
        desc = text[comment_pos + 1:].strip() if comment_pos >= 0 else ""
        line = (text[:comment_pos] if comment_pos >= 0 else text).strip()
        parts = line.split()
        if len(parts) != N_FEATURES + 2:
            return None
        rel = int(parts[0])
        qid = int(parts[1].split(":")[1])
        feats = [float(p.split(":")[1]) for p in parts[2:]]
        return cls(qid, rel, feats, desc)


class QueryList:
    """All documents of one query (reference mq2007.py QueryList)."""

    def __init__(self, querylist=None):
        self.querylist = querylist or []
        self.query_id = self.querylist[0].query_id if self.querylist \
            else -1
        for q in self.querylist:
            if q.query_id != self.query_id:
                raise ValueError("query in list must share query_id")

    def __iter__(self):
        return iter(self.querylist)

    def __len__(self):
        return len(self.querylist)

    def __getitem__(self, i):
        return self.querylist[i]

    def _correct_ranking_(self):
        self.querylist.sort(key=lambda q: -q.relevance_score)

    def _add_query(self, query):
        if self.query_id == -1:
            self.query_id = query.query_id
        elif query.query_id != self.query_id:
            raise ValueError("query in list must share query_id")
        self.querylist.append(query)


def _load_querylists(path):
    grouped = {}
    order = []
    with open(path) as f:
        for line in f:
            q = Query.parse(line)
            if q is None:
                continue
            if q.query_id not in grouped:
                grouped[q.query_id] = QueryList()
                order.append(q.query_id)
            grouped[q.query_id]._add_query(q)
    for qid in order:
        yield grouped[qid]


def gen_point(querylist):
    """(relevance, feature_vector) per document."""
    for q in querylist:
        yield q.relevance_score, np.array(q.feature_vector)


def gen_pair(querylist, partial_order="full"):
    """(label, f_better, f_worse) per document pair with differing
    relevance; label is +1 (first wins)."""
    querylist._correct_ranking_()
    for a, b in itertools.combinations(querylist, 2):
        if a.relevance_score == b.relevance_score:
            continue
        hi, lo = (a, b) if a.relevance_score > b.relevance_score \
            else (b, a)
        yield (np.array([1.0]), np.array(hi.feature_vector),
               np.array(lo.feature_vector))


def gen_list(querylist):
    """(relevance_list, feature_matrix) for the whole query."""
    querylist._correct_ranking_()
    rels = [q.relevance_score for q in querylist]
    feats = np.array([q.feature_vector for q in querylist])
    return rels, feats


def _reader_creator(path, format):
    def reader():
        for ql in _load_querylists(path):
            if format == "pointwise":
                yield from gen_point(ql)
            elif format == "pairwise":
                yield from gen_pair(ql)
            elif format == "listwise":
                yield gen_list(ql)
            else:
                raise ValueError(f"unknown mq2007 format {format!r}")
    return reader


def _resolve(split):
    path = os.path.join(common.DATA_HOME, "MQ2007", "Fold1",
                        f"{split}.txt")
    if not os.path.exists(path):
        raise common.DatasetNotDownloaded(
            f"MQ2007 file not found: {path} (extract MQ2007.rar there)")
    return path


def _synthetic(format, split):
    from .synthetic import ranking as syn
    base = syn.train() if split == "train" else syn.test()

    def reader():
        for qid, rows in itertools.groupby(base(), key=lambda r: r[1]):
            ql = QueryList([Query(qid, rel, list(f))
                            for rel, _, f in rows])
            if format == "pointwise":
                yield from gen_point(ql)
            elif format == "pairwise":
                yield from gen_pair(ql)
            else:
                yield gen_list(ql)
    return reader


def train(format="pairwise"):
    try:
        return _reader_creator(_resolve("train"), format)
    except common.DatasetNotDownloaded as e:
        warnings.warn(f"mq2007.train: {e}; synthetic fallback")
        return _synthetic(format, "train")


def test(format="pairwise"):
    try:
        return _reader_creator(_resolve("test"), format)
    except common.DatasetNotDownloaded as e:
        warnings.warn(f"mq2007.test: {e}; synthetic fallback")
        return _synthetic(format, "test")
