"""DataFeeder: reader rows to executor feed dicts (counterpart of
``paddle_tpu/data_feeder.py``, whose conversion is copied: that module
imports no JAX, but importing it would import ``paddle_tpu``).

``feed`` produces numpy arrays, bit for bit the JAX feeder's; the
executor moves them to its device.  A ragged sequence field (a variable
of ``lod_level >= 1``) becomes a zero-padded [batch, T, ...] array plus
its int32 [batch] length companion ``<name>@LEN``; ``pad_to`` fixes T
(per call or per feeder), so that a bucket's batches share one feed
signature.  ``prefetch`` wraps a reader in a ``DevicePrefetcher`` that
converts and stages batch N+1 on the card while step N runs.
"""

import math

import numpy as np

from .core import dtype_name
from .framework import Variable, default_main_program

__all__ = ["DataFeeder"]


def _np_dtype(dtype):
    """A program dtype (a ``torch.dtype``) as numpy's."""
    return np.dtype(dtype_name(dtype))


class _Converter:
    def __init__(self, shape, dtype):
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = dtype
        self.rows = []

    def feed(self, item):
        self.rows.append(np.asarray(item, dtype=self.dtype))

    def done(self):
        arr = np.stack(self.rows) if self.rows else np.zeros((0,), self.dtype)
        if self.shape is not None and -1 not in self.shape[1:]:
            want = tuple(s for s in self.shape if s != -1)
            if arr.size and arr.shape[1:] != want[-len(arr.shape[1:]):]:
                try:
                    arr = arr.reshape((arr.shape[0],) + tuple(
                        s for s in self.shape[1:]))
                except ValueError:
                    pass
        return arr


class _SequenceConverter:
    """Ragged rows -> padded [batch, T, ...] + int32 [batch] lengths;
    ``pad_to`` fixes T (the batch's longest row otherwise, a new feed
    signature for every new T)."""

    def __init__(self, shape, dtype, pad_to=None):
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = dtype
        self.pad_to = pad_to
        self.rows = []

    def feed(self, item):
        arr = np.asarray(item, dtype=self.dtype)
        # a declared per-step shape [1]: accept [T] and lift it to [T, 1]
        if self.shape is not None:
            trailing = tuple(s for s in self.shape[2:])
            if trailing == (1,) and arr.ndim == 1:
                arr = arr[:, None]
        self.rows.append(arr)

    def done(self):
        lens = np.asarray([r.shape[0] for r in self.rows], dtype=np.int32)
        t = int(self.pad_to) if self.pad_to else int(lens.max() if len(lens)
                                                     else 0)
        if len(self.rows) and any(r.shape[0] > t for r in self.rows):
            raise ValueError(
                "sequence longer than pad_to=%d" % t)
        trailing = self.rows[0].shape[1:] if self.rows else ()
        out = np.zeros((len(self.rows), t) + trailing, self.dtype)
        for i, r in enumerate(self.rows):
            out[i, :r.shape[0]] = r
        return out, lens


class DataFeeder:
    def __init__(self, feed_list, place=None, program=None, pad_to=None):
        self.feed_dtypes = []
        self.feed_names = []
        self.feed_shapes = []
        self.feed_lod_levels = []
        self.place = place
        self.pad_to = pad_to
        if program is None:
            program = default_main_program()
        for v in feed_list:
            if isinstance(v, str):
                v = program.global_block().var(v)
            if not isinstance(v, Variable):
                raise TypeError("feed_list holds a %s, not a Variable or "
                                "a variable name" % type(v).__name__)
            self.feed_names.append(v.name)
            self.feed_dtypes.append(_np_dtype(v.dtype))
            self.feed_shapes.append(v.shape)
            self.feed_lod_levels.append(v.lod_level or 0)

    def feed(self, iterable, pad_to=None):
        """Rows of tuples -> ``{name: batched ndarray}``; sequence fields
        (``lod_level >= 1``) also produce ``<name>@LEN``.  ``pad_to``
        overrides the feeder's pad length for this batch (a bucket's
        bound, ``reader.bucket_by_length``)."""
        pad = pad_to if pad_to is not None else self.pad_to
        converters = [
            _SequenceConverter(shape, dtype, pad_to=pad)
            if lod >= 1 else _Converter(shape, dtype)
            for shape, dtype, lod in zip(
                self.feed_shapes, self.feed_dtypes, self.feed_lod_levels)
        ]
        for each_sample in iterable:
            if len(each_sample) != len(converters):
                raise ValueError("sample has %d fields, expected %d"
                                 % (len(each_sample), len(converters)))
            for item, conv in zip(each_sample, converters):
                conv.feed(item)
        out = {}
        for name, conv, lod in zip(self.feed_names, converters,
                                   self.feed_lod_levels):
            if lod >= 1:
                arr, lens = conv.done()
                out[name] = arr
                out[name + "@LEN"] = lens
            else:
                out[name] = conv.done()
        return out

    def prefetch(self, reader, capacity=2, place=None, shardings=None):
        """A ``DevicePrefetcher`` that runs this feeder's conversion and
        the host-to-device copies of batch N+1 while step N runs.
        ``reader`` yields sample rows (a reader creator or an iterable).
        The place is ``place``, else the feeder's, else ``CUDAPlace(0)``.
        ``shardings`` (``DevicePrefetcher``'s) lands each feed as the
        rank's block of it."""
        from .executor import CUDAPlace
        from .reader import DevicePrefetcher

        if place is None:
            place = self.place if self.place is not None else CUDAPlace(0)
        return DevicePrefetcher(reader, feeder=self, place=place,
                                capacity=capacity, shardings=shardings)

    def feed_parallel(self, iterable, num_places=None):
        """Split one batch into ``num_places`` feeds, ragged fields padded
        to the batch's longest row so the feeds stack."""
        rows = list(iterable)
        n = num_places or 1
        per = math.ceil(len(rows) / n)
        old_pad = self.pad_to
        try:
            if old_pad is None and any(l >= 1 for l in self.feed_lod_levels):
                global_max = 0
                for row in rows:
                    for item, lod in zip(row, self.feed_lod_levels):
                        if lod >= 1:
                            global_max = max(global_max,
                                             np.asarray(item).shape[0])
                self.pad_to = global_max or None
            return [self.feed(rows[i * per:(i + 1) * per]) for i in range(n)]
        finally:
            self.pad_to = old_pad
