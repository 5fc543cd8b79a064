"""Readers and the device prefetcher (counterpart of
``paddle_tpu/reader/__init__.py``): the decorators, ``batch``,
``DevicePrefetcher`` and its reference-named facade ``PyReader``.

``DevicePrefetcher`` runs a producer thread that converts batch N+1 and
stages it on the card while the executor runs step N.  On a CUDA place
the producer, for each batch, runs the feeder's conversion, copies each
array into pinned host memory, issues ``non_blocking`` host-to-device
copies on a side stream that the prefetcher owns, and records an event
there.  The consumer (the thread that iterates) hands a batch out only
after making its current stream wait on that event, and marks every
staged tensor as used on that stream (``record_stream``), so the caching
allocator does not give the tensor's memory to a later batch while the
step's reads of it are still queued.  Pinned blocks come from PyTorch's
caching host allocator, which does not reuse a block before the copy out
of it has finished.  The executor then copies the staged tensors device
to device into its feed buffers, on the stream that replays the step.
On a CPU place only the conversion runs.

The prefetcher is tracked by the monitor (its queue's occupancy reaches
every step record and the watchdog's stall dump), its producer
heartbeats once a batch while the monitor is on, and its staging is the
``prefetch/h2d_transfer`` span (overlapped work in the goodput ledger).
``shardings`` (a ``{feed name: parallel.parallel_executor.Sharding}``
dict, or one ``Sharding`` for every feed; ``ParallelExecutor.
feed_sharding()`` gives the batch split) lands each feed as the rank's
block of it, which ``ParallelExecutor.run(..., local_feed=True)`` takes.
"""

import queue
import threading
import weakref

import numpy as np
import torch

from .. import monitor
from ..profiler import RecordEvent
from .decorator import *  # noqa: F401,F403
from . import creator  # noqa: F401
from . import decorator  # noqa: F401

__all__ = decorator.__all__ + ["DevicePrefetcher", "PyReader", "batch"]


def batch(reader, batch_size, drop_last=False):
    """Group samples into lists of ``batch_size`` (reference
    ``paddle.batch``)."""
    def batch_reader():
        b = []
        for item in reader():
            b.append(item)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b
    return batch_reader


class _Staged:
    """A batch copied to the card on the prefetcher's side stream, and the
    event recorded after its copies."""

    __slots__ = ("feed", "event")

    def __init__(self, feed, event):
        self.feed = feed
        self.event = event


class DevicePrefetcher:
    """Converts and stages feeds on the card ahead of the training loop.

    * ``source`` — a reader creator (callable returning an iterator) or
      an iterable; its items are sample-row lists when ``feeder`` is given
      (converted by ``DataFeeder.feed``), feed dicts otherwise.
    * ``place`` — an executor Place; ``CUDAPlace(0)`` when None.
      ``CPUPlace()`` runs the conversion only.
    * ``capacity`` — how many staged batches may wait ahead of the
      consumer.

    Iterate to get feed dicts (of CUDA tensors on a CUDA place).  A
    producer exception is re-raised at the consumer after the batches
    already staged have been handed out.  ``close()`` (or leaving the
    context manager) stops the producer and joins it, also when the
    consumer abandoned the iteration.  With a callable or a re-iterable
    container as ``source`` the prefetcher is re-iterable, one epoch a
    fresh producer; over a one-shot iterator a second iteration raises.
    """

    _END = object()

    def __init__(self, source, feeder=None, place=None, capacity=2,
                 shardings=None):
        self._shardings = shardings
        if place is None:
            from ..executor import CUDAPlace

            place = CUDAPlace(0)
        self._source = source
        self._feeder = feeder
        self._place = place
        self._stream = None     # the side stream of the copies (CUDA)
        self._q = queue.Queue(maxsize=max(1, int(capacity)))
        self._stop = threading.Event()
        self._failure = []
        self._thread = None
        # epoch generation: producer and consumer bind the epoch's
        # (queue, stop, failure) at start, so a stale iterator of a
        # superseded epoch can neither take the new epoch's batches nor
        # stop it when it is collected
        self._epoch = 0
        # weakref to the epoch's consumer generator: a live iterator is
        # seen even before its first next() (when no producer exists
        # yet), and one dropped unadvanced reads as dead
        self._consumer = None
        monitor.track(self)

    def monitor_state(self):
        return {"kind": "prefetcher", "epoch": self._epoch,
                "occupancy": self._q.qsize(),
                "capacity": self._q.maxsize,
                "stopped": self._stop.is_set()}

    # -- staging -------------------------------------------------------
    def _shard(self, feed):
        """Each feed cut to the rank's block of its sharding."""
        sh = self._shardings
        if sh is None:
            return feed
        out = {}
        for k, v in feed.items():
            s = sh.get(k) if isinstance(sh, dict) else sh
            out[k] = v if s is None else s.shard(v)
        return out

    def _stage(self, feed):
        """``feed`` (cut to its shardings) copied to the card on the side
        stream (a ``_Staged``), or as it is on a CPU place."""
        feed = self._shard(feed)
        dev = self._place.device
        if dev.type != "cuda":
            return feed
        out = {}
        with RecordEvent("prefetch/h2d_transfer"), torch.cuda.device(dev), \
                torch.cuda.stream(self._stream):
            for k, v in feed.items():
                t = v if isinstance(v, torch.Tensor) \
                    else torch.from_numpy(np.ascontiguousarray(v))
                if t.device.type == "cpu":
                    pinned = torch.empty(t.shape, dtype=t.dtype,
                                         pin_memory=True)
                    pinned.copy_(t)
                    t = pinned
                out[k] = t.to(dev, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        return _Staged(out, event)

    def _hand_out(self, item):
        """A staged batch, ready for work on the consumer's current
        stream."""
        if not isinstance(item, _Staged):
            return item
        stream = torch.cuda.current_stream(self._place.device)
        stream.wait_event(item.event)
        for t in item.feed.values():
            t.record_stream(stream)
        return item.feed

    def _producer(self, q, stop, failure):
        try:
            it = self._source() if callable(self._source) \
                else iter(self._source)
            for item in it:
                if stop.is_set():
                    return
                if monitor._enabled:
                    # a producer wedged in its source or its copies shows
                    # a stale heartbeat in the watchdog's dump
                    monitor.heartbeat("prefetch/producer")
                feed = self._feeder.feed(item) if self._feeder is not None \
                    else item
                feed = self._stage(feed)
                while not stop.is_set():
                    try:
                        q.put(feed, timeout=0.05)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # noqa: BLE001 — re-raised by the consumer
            failure.append(e)
        finally:
            while not stop.is_set():
                try:
                    q.put(self._END, timeout=0.05)
                    break
                except queue.Full:
                    continue

    def _ensure_started(self, epoch, q, stop, failure):
        # called inside the consumer generator with its epoch's objects: a
        # superseded generator (stop set) or one whose epoch was reset
        # before its first advance starts no producer
        if epoch == self._epoch and self._thread is None \
                and not stop.is_set():
            if self._place.device.type == "cuda" and self._stream is None:
                self._stream = torch.cuda.Stream(self._place.device)
            self._thread = threading.Thread(
                target=self._producer, args=(q, stop, failure),
                name="prefetch-producer-%d" % epoch, daemon=True)
            self._thread.start()

    def _restartable(self):
        """Whether the source gives a fresh stream an epoch: reader
        creators and re-iterable containers do, a one-shot iterator
        (``iter(x) is x``) does not."""
        src = self._source
        return callable(src) or iter(src) is not src

    # -- consumer protocol ---------------------------------------------
    def __iter__(self):
        live_consumer = (self._consumer is not None
                         and self._consumer() is not None)
        if live_consumer and not self._stop.is_set():
            if self._restartable():
                # iter() over a live stream of a restartable source starts
                # a fresh epoch: stop the current producer first, so the
                # new epoch never shares a half-consumed stream
                self.close()
            else:
                # two live consumers over a one-shot iterator would share
                # the queue, and dropping either would end the epoch under
                # the other
                raise RuntimeError(
                    "DevicePrefetcher already has an active iterator;"
                    " a one-shot iterator source supports a single pass")
        if self._stop.is_set():
            if not self._restartable():
                raise RuntimeError(
                    "DevicePrefetcher over a one-shot iterator is"
                    " exhausted; pass a callable reader creator or a"
                    " re-iterable container to re-iterate")
            self._epoch += 1
            self._q = queue.Queue(maxsize=self._q.maxsize)
            self._stop = threading.Event()
            self._failure = []
            self._thread = None
        gen = self._consume(self._epoch, self._q, self._stop,
                            self._failure)
        self._consumer = weakref.ref(gen)
        return gen

    def _consume(self, epoch, q, stop, failure):
        try:
            # the producer starts inside the generator body: an iterator
            # created and never advanced has no thread to leak (its
            # finally below would never run)
            self._ensure_started(epoch, q, stop, failure)
            while True:
                if stop.is_set():
                    return
                try:
                    # a bounded wait, so that a concurrent close() cannot
                    # strand the consumer on an empty queue
                    item = q.get(timeout=0.05)
                except queue.Empty:
                    continue
                if item is self._END:
                    if failure:
                        # the producer's error, where the training loop is
                        raise failure[0]
                    return
                yield self._hand_out(item)
        finally:
            # also on GeneratorExit: an abandoned iteration stops its
            # producer.  Only the current epoch's iterator closes the
            # prefetcher; a superseded one stops its own producer
            if epoch == self._epoch:
                self.close()
            else:
                stop.set()

    def close(self):
        """Stop the producer and join it (idempotent); drains the queue so
        that a blocked ``put`` sees the stop flag."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        if self._thread is not None:
            self._thread.join(timeout=10)
        return self

    def __enter__(self):
        # lazy: the first iter() starts the producer
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class PyReader:
    """Host-to-device prefetch pipeline, the reference-named facade over
    ``DevicePrefetcher``.

    ``decorate_batch_reader(reader, feeder, place)``: ``reader`` yields
    lists of samples, ``feeder`` converts them to feed dicts (None: the
    reader yields feed dicts), and a producer thread stages up to
    ``capacity`` batches ahead on ``place`` (``CUDAPlace(0)`` when None).
    Iterate for feed dicts; every iteration is a fresh prefetcher.
    """

    def __init__(self, capacity=4):
        self.capacity = capacity
        self._reader = None
        self._feeder = None
        self._place = None

    def decorate_batch_reader(self, reader, feeder, place=None):
        self._reader = reader
        self._feeder = feeder
        self._place = place
        return self

    def decorate_paddle_reader(self, reader, feeder, place=None):
        # reference alias
        return self.decorate_batch_reader(reader, feeder, place)

    def __iter__(self):
        if self._reader is None:
            raise RuntimeError("call decorate_batch_reader first")
        return iter(DevicePrefetcher(
            self._reader, feeder=self._feeder, place=self._place,
            capacity=self.capacity))
