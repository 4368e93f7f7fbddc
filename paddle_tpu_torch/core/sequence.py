"""SequenceBatch — the padded replacement for LoDTensor.

Port of ``paddle_tpu/core/sequence.py``. Fluid's LoDTensor (reference
paddle/fluid/framework/lod_tensor.h) stores variable-length sequences
flattened with level-of-detail offset tables; the port, as the JAX
package, keeps a batch of sequences as a padded dense tensor ``data`` of
shape [batch, max_len, ...] plus a ``lengths`` vector [batch]. Sequence
ops consume the implied mask; multi-level LoD (sequences of sequences)
nests a second (batch, outer_len) padding level.

The reference registers the class as a jax pytree so it flows through
jit; here it is a plain class whose leaves are torch tensors (or, in a
fetch with ``return_numpy=True``, numpy arrays). Lengths are int64, the
port's ``canonical_int`` (the reference's are int32): compare them by
value.
"""
import numpy as np
import torch

__all__ = ["SequenceBatch", "to_sequence_batch",
           "to_nested_sequence_batch", "sequence_mask_from_lengths"]


class SequenceBatch:
    def __init__(self, data, lengths, outer_counts=None):
        self.data = data
        self.lengths = lengths
        # level-2 only: explicit subsequence count per outer sequence,
        # so a legitimate zero-length subsequence is distinguishable
        # from slot padding
        self.outer_counts = outer_counts

    @property
    def shape(self):
        return self.data.shape

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def lod_level(self):
        """1 for flat sequences ([B, T, ...] + lengths [B]); 2 for
        nested sequences-of-sequences ([B, S, T, ...] + lengths [B, S],
        where a zero length marks subsequence padding)."""
        # a tensor's own ndim: np.ndim of a tensor does not trace in a
        # body torch.export traces through a higher-order op
        lengths = self.lengths
        return int(lengths.ndim if hasattr(lengths, "ndim")
                   else np.ndim(lengths))

    def sub_counts(self):
        """Level-2 only: number of real subsequences per outer sequence.
        Uses the explicit ``outer_counts`` when present; the
        nonzero-length fallback covers derived batches and cannot
        represent zero-length subsequences."""
        if self.lod_level != 2:
            raise ValueError("sub_counts is a 2-level LoD accessor")
        if self.outer_counts is not None:
            return self.outer_counts
        return (self.lengths > 0).sum(dim=-1)

    def mask(self, dtype=torch.float32):
        """[batch, max_len] (or [batch, s, max_len] at level 2)
        validity mask (a tensor; a fetched batch's numpy lengths too)."""
        lengths = torch.as_tensor(self.lengths)
        if self.lod_level == 2:
            pos = torch.arange(self.data.shape[2], device=lengths.device)
            return (pos[None, None, :] < lengths[:, :, None]).to(dtype)
        return sequence_mask_from_lengths(lengths, self.data.shape[1], dtype)

    def leaves(self):
        """(data, lengths[, outer_counts]) — the padded decomposition."""
        if self.outer_counts is None:
            return (self.data, self.lengths)
        return (self.data, self.lengths, self.outer_counts)

    def map(self, fn):
        """A SequenceBatch of ``fn`` applied to each leaf."""
        return SequenceBatch(*(fn(v) for v in self.leaves()))

    def with_data(self, data):
        """The same lengths (and counts) over new ``data``."""
        return SequenceBatch(data, self.lengths, self.outer_counts)

    def __repr__(self):
        return (f"SequenceBatch(data={tuple(self.data.shape)}, "
                f"lengths={tuple(self.lengths.shape)})")


def sequence_mask_from_lengths(lengths, max_len, dtype=torch.float32):
    pos = torch.arange(max_len, device=lengths.device)[None, :]
    return (pos < lengths[:, None]).to(dtype)


def _np_dtype(dtype, arrays):
    if dtype is None:
        dtype = np.result_type(*[np.asarray(a).dtype for a in arrays])
        if dtype == np.float64:
            dtype = np.float32
    if isinstance(dtype, torch.dtype):
        return np.dtype(str(dtype).replace("torch.", ""))
    return np.dtype(dtype)


def to_sequence_batch(seqs, dtype=None, pad_value=0, max_len=None,
                      bucket=8):
    """Pads a python list of variable-length sequences (lists / 1D or ND
    arrays) into a SequenceBatch of host tensors (the executor moves it
    to its device). ``bucket`` rounds max_len up to a multiple, so a
    length signature repeats across batches. dtype defaults to the
    input's own (integer rows stay integer — embedding/label feeds)."""
    dtype = _np_dtype(dtype, seqs)
    arrs = [np.asarray(s, dtype=dtype) for s in seqs]
    lengths = np.asarray([a.shape[0] for a in arrs], dtype=np.int64)
    ml = max_len or int(max(1, lengths.max()))
    if bucket:
        ml = int(-(-ml // bucket) * bucket)
    tail = arrs[0].shape[1:] if arrs[0].ndim > 1 else ()
    out = np.full((len(arrs), ml) + tail, pad_value, dtype=dtype)
    for i, a in enumerate(arrs):
        out[i, :a.shape[0]] = a[:ml]
    return SequenceBatch(torch.from_numpy(out), torch.from_numpy(lengths))


def to_nested_sequence_batch(nested, dtype=None, pad_value=0,
                             bucket=8):
    """Pads a list (outer sequences) of lists of variable-length
    subsequences into a 2-level SequenceBatch: data
    [n_outer, max_subseqs, max_len, ...], lengths [n_outer, max_subseqs]
    (0 = subsequence padding), outer_counts [n_outer]."""
    if not nested or not isinstance(nested[0], (list, tuple)):
        raise ValueError(
            "to_nested_sequence_batch wants a list of lists of "
            "sequences; for flat sequences use to_sequence_batch")
    flat = [np.asarray(s) for outer in nested for s in outer]
    dtype = _np_dtype(dtype, flat)
    s_max = max(len(outer) for outer in nested)
    t_max = max(max((np.asarray(s).shape[0] for s in outer),
                    default=1) for outer in nested)
    if bucket:
        t_max = int(-(-t_max // bucket) * bucket)
    tail = flat[0].shape[1:] if flat and flat[0].ndim > 1 else ()
    b = len(nested)
    data = np.full((b, s_max, t_max) + tail, pad_value, dtype=dtype)
    lengths = np.zeros((b, s_max), np.int64)
    for i, outer in enumerate(nested):
        for j, s in enumerate(outer):
            a = np.asarray(s, dtype=dtype)
            lengths[i, j] = a.shape[0]
            data[i, j, :a.shape[0]] = a[:t_max]
    counts = np.asarray([len(outer) for outer in nested], np.int64)
    return SequenceBatch(torch.from_numpy(data), torch.from_numpy(lengths),
                         torch.from_numpy(counts))
