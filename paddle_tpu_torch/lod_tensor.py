"""LoDTensor construction helpers (port of ``paddle_tpu/lod_tensor.py``;
parity with python/paddle/fluid/lod_tensor.py create_lod_tensor:23,
create_random_int_lodtensor:93).

The variable-length container is SequenceBatch (padded data + per-
sequence lengths, ``core/sequence.py``) rather than the reference's
offset-LoD flat tensor. These helpers accept the reference's
length-based ``recursive_seq_lens`` and produce a SequenceBatch of host
tensors; feed the result directly to ``Executor.run``.
"""
import numpy as np

from .core.sequence import (SequenceBatch, to_nested_sequence_batch,
                            to_sequence_batch)

__all__ = ["create_lod_tensor", "create_random_int_lodtensor"]


def _check_lens(recursive_seq_lens):
    if (not isinstance(recursive_seq_lens, (list, tuple))
            or not recursive_seq_lens
            or not isinstance(recursive_seq_lens[0], (list, tuple))):
        raise ValueError(
            "recursive_seq_lens must be a list of lists, e.g. [[2, 3]]")
    if len(recursive_seq_lens) > 2:
        raise NotImplementedError(
            "LoD nesting beyond 2 levels is not supported (the "
            "reference's user-visible APIs use at most 2 — "
            "create_lod_tensor's own doc example); express deeper "
            "nesting as a dense axis or repeated 2-level batches")
    return [[int(n) for n in level] for level in recursive_seq_lens]


def _split_flat(data, lens):
    offsets = np.cumsum([0] + list(lens))
    return [data[offsets[i]:offsets[i + 1]] for i in range(len(lens))]


def create_lod_tensor(data, recursive_seq_lens, place=None):
    """Build a SequenceBatch from flat ``data`` plus length-based LoD.

    ``data`` may be a numpy array of shape [sum(lens), ...], a list of
    per-sequence index lists (each becomes an int64 [len, 1] segment, as
    in the reference), or an existing level-1 SequenceBatch (re-lodded).
    ``place`` is accepted for API parity; the executor moves the batch
    to its device when it is fed.
    """
    if isinstance(data, SequenceBatch):
        if data.lod_level != 1:
            raise ValueError("re-lodding expects a level-1 input")
        flat = np.concatenate(
            [np.asarray(data.data)[i, :int(n)]
             for i, n in enumerate(np.asarray(data.lengths))], axis=0)
        return create_lod_tensor(flat, recursive_seq_lens, place)
    levels = _check_lens(recursive_seq_lens)
    if isinstance(data, list):
        got = [len(seq) for seq in data]
        if got != levels[-1]:
            raise ValueError(
                f"data and recursive_seq_lens do not match: {got} vs "
                f"{levels[-1]}")
        flat = np.concatenate([np.asarray(s) for s in data],
                              axis=0).astype("int64")
        data = flat.reshape(len(flat), 1)
    data = np.asarray(data)
    inner = levels[-1]
    if data.shape[0] != sum(inner):
        raise ValueError(
            f"the provided lod info is invalid: data has {data.shape[0]} "
            f"rows but recursive_seq_lens sums to {sum(inner)}")
    segments = _split_flat(data, inner)
    if len(levels) == 1:
        return to_sequence_batch(segments, dtype=data.dtype)
    # 2-level (the reference doc's own example): outer lens group the
    # inner subsequences into a nested SequenceBatch
    outer = levels[0]
    if sum(outer) != len(inner):
        raise ValueError(
            f"outer level sums to {sum(outer)} but there are "
            f"{len(inner)} inner sequences")
    return to_nested_sequence_batch(_split_flat(segments, outer),
                                    dtype=data.dtype)


def create_random_int_lodtensor(recursive_seq_lens, base_shape, place=None,
                                low=0, high=1):
    """Random-integer sequence batch: one [len, *base_shape] int64
    segment per sequence, values in [low, high] inclusive (numpy's global
    generator, as the reference's)."""
    lens = _check_lens(recursive_seq_lens)[-1]
    shape = [sum(lens)] + list(base_shape)
    data = np.random.randint(low, high + 1, size=shape).astype("int64")
    return create_lod_tensor(data, recursive_seq_lens, place)
