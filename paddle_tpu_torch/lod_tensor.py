"""LoD tensor construction helpers (a copy of ``paddle_tpu/lod_tensor.py``,
which the port cannot import: that package imports JAX).

There is no LoDTensor runtime type: a variable-length batch is a padded
``[batch, time, ...]`` array plus its ``@LEN`` companion vector (see
``layers.data``).  ``create_lod_tensor`` returns a ``PaddedSequence``
holding those two arrays, and ``as_feed(name)`` gives the feed-dict
entries the executor takes.  One nesting level is supported; a deeper
LoD raises.
"""

import numpy as np

__all__ = ["PaddedSequence", "LoDTensor", "LoDTensorArray",
           "create_lod_tensor", "create_random_int_lodtensor"]


class PaddedSequence(object):
    """What create_lod_tensor returns: the padded batch + lengths."""

    def __init__(self, data, seq_lens):
        self.data = data
        self.seq_lens = np.asarray(seq_lens, dtype="int32")

    def recursive_sequence_lengths(self):
        """Length-based LoD, reference LoDTensor API."""
        return [list(int(l) for l in self.seq_lens)]

    def has_valid_recursive_sequence_lengths(self):
        return bool(np.all(self.seq_lens >= 0) and
                    self.data.shape[1] >= int(self.seq_lens.max(initial=0)))

    def shape(self):
        return tuple(self.data.shape)

    def as_feed(self, name):
        """Feed-dict entries for a data var declared with lod_level=1."""
        return {name: self.data, name + "@LEN": self.seq_lens}

    def __array__(self, dtype=None):
        a = self.data
        return a.astype(dtype) if dtype is not None else a


class LoDTensor(PaddedSequence):
    """Constructible host LoD tensor (reference pybind ``core.LoDTensor``
    surface: ``set`` / ``set_recursive_sequence_lengths`` / ``lod``).
    The storage is the padded+@LEN pair; offset-based ``lod()`` is
    derived from the lengths on demand."""

    def __init__(self, data=None, seq_lens=None):
        if data is None:
            data = np.zeros((0, 0), dtype="float32")
        if seq_lens is None:
            seq_lens = np.zeros((0,), dtype="int32")
        super().__init__(np.asarray(data), seq_lens)

    def set(self, array, place=None):
        """Stage a host array (``place`` accepted for parity; residency
        is decided at feed time by the executor)."""
        self.data = np.asarray(array)

    def set_recursive_sequence_lengths(self, recursive_seq_lens):
        self.seq_lens = np.asarray(_check_lod(recursive_seq_lens),
                                   dtype="int32")

    def lod(self):
        """Offset-based LoD (the reference's native form): one level of
        [0, l0, l0+l1, ...]."""
        if self.seq_lens.size == 0:
            return []
        return [[0] + [int(v) for v in np.cumsum(self.seq_lens)]]

    def set_lod(self, lod):
        if not lod:
            self.seq_lens = np.zeros((0,), dtype="int32")
            return
        if len(lod) > 1:
            raise NotImplementedError(
                "multi-level LoD is flattened by the padded+@LEN design "
                "(SURVEY §5); pass one level of offsets")
        offs = list(lod[0])
        if offs and (offs[0] != 0 or
                     any(b < a for a, b in zip(offs, offs[1:]))):
            raise ValueError(
                "lod offsets must start at 0 and be non-decreasing, "
                "got %s" % (offs,))
        self.seq_lens = np.asarray(
            [b - a for a, b in zip(offs, offs[1:])], dtype="int32")


class LoDTensorArray(list):
    """Host-side tensor array (reference ``core.LoDTensorArray``): a
    plain list of LoDTensor/arrays — in-program arrays are preallocated
    device tensors (layers.create_array), this is the feed/fetch shim."""


def _check_lod(recursive_seq_lens):
    if (not isinstance(recursive_seq_lens, (list, tuple)) or
            len(recursive_seq_lens) == 0):
        raise ValueError("recursive_seq_lens must be a non-empty list of "
                         "lists, e.g. [[2, 3]]")
    if len(recursive_seq_lens) > 1:
        raise NotImplementedError(
            "multi-level LoD is flattened by the padded+@LEN design "
            "(SURVEY §5); pass one level of lengths")
    return [int(l) for l in recursive_seq_lens[0]]


def create_lod_tensor(data, recursive_seq_lens, place=None):
    """Build a PaddedSequence from flat data + lengths (reference
    lod_tensor.py:23).

    ``data`` may be a list of per-sequence lists (word ids -> int64
    [n, 1] as the reference does), a flat numpy array of shape
    [sum(lens), ...], or an existing PaddedSequence (re-checked).
    ``place`` is accepted for parity; arrays stay host-side until fed.
    """
    from .data_feeder import _SequenceConverter

    lens = _check_lod(recursive_seq_lens)
    if isinstance(data, PaddedSequence):
        return create_lod_tensor(
            _unpad(data), recursive_seq_lens, place)
    if isinstance(data, list):
        got = [len(seq) for seq in data]
        if got != lens:
            raise AssertionError(
                "data and recursive_seq_lens do not match: %s vs %s"
                % (got, lens))
        # word-id lists -> int64 [n, 1], as the reference specializes
        conv = _SequenceConverter(shape=(-1, -1, 1), dtype="int64")
        for seq in data:
            conv.feed(np.asarray(seq, dtype="int64").reshape(-1))
        padded, got_lens = conv.done()
        return LoDTensor(padded, got_lens)
    data = np.asarray(data)
    if data.shape[0] != sum(lens):
        raise AssertionError(
            "data rows (%d) != sum of sequence lengths (%d)"
            % (data.shape[0], sum(lens)))
    # split the flat rows per sequence and reuse the DataFeeder padder
    conv = _SequenceConverter(shape=None, dtype=data.dtype)
    off = 0
    for l in lens:
        conv.feed(data[off:off + l])
        off += l
    padded, got_lens = conv.done()
    return LoDTensor(padded, got_lens)


def _unpad(ps):
    rows = []
    for i, l in enumerate(ps.seq_lens):
        rows.append(ps.data[i, :int(l)])
    return np.concatenate(rows, axis=0) if rows else \
        np.zeros((0,) + ps.data.shape[2:], ps.data.dtype)


def create_random_int_lodtensor(recursive_seq_lens, base_shape, place=None,
                                low=0, high=1):
    """Random-integer sequence batch (reference lod_tensor.py:92): one
    int64 row of shape ``base_shape`` per timestep, lengths as given."""
    lens = _check_lod(recursive_seq_lens)
    total = sum(lens)
    shape = (total,) + tuple(base_shape)
    data = np.random.randint(low, high + 1, size=shape).astype("int64")
    return create_lod_tensor(data, recursive_seq_lens, place)
