"""Reader decorators: composable transforms of reader creators
(counterpart of ``paddle_tpu/reader/decorator.py``, copied: that module
imports no JAX, but importing it would import ``paddle_tpu``, which
does).

A *reader creator* is a zero-arg callable returning an iterator over
samples.  ``bucket_by_length`` groups variable-length samples into
fixed pad bounds, one executor entry (and one captured graph) per bound;
feed a bucket's batch with ``DataFeeder.feed(samples, pad_to=bound)``.
"""

import itertools
import queue
import random
import threading

__all__ = [
    "ComposeNotAligned",
    "map_readers",
    "buffered",
    "compose",
    "chain",
    "shuffle",
    "firstn",
    "xmap_readers",
    "multiprocess_reader",
    "cache",
    "bucket_by_length",
    "checkpointable",
    "CheckpointableReader",
    "Fake",
    "PipeReader",
]


class ComposeNotAligned(ValueError):
    pass


def map_readers(func, *readers):
    """func applied across the zip of readers' samples."""
    def reader():
        rs = [r() for r in readers]
        for vals in zip(*rs):
            yield func(*vals)
    return reader


def shuffle(reader, buf_size):
    """Pool-based shuffle (reference decorator.py:58)."""
    def data_reader():
        buf = []
        for e in reader():
            buf.append(e)
            if len(buf) >= buf_size:
                random.shuffle(buf)
                for b in buf:
                    yield b
                buf = []
        if buf:
            random.shuffle(buf)
            for b in buf:
                yield b
    return data_reader


class CheckpointableReader:
    """Position-tracking wrapper over a reader creator — the reader leg
    of exact-resume checkpoints (``TrainState`` captures it alongside
    params/optimizer/PRNG state).

    Tracks ``(epoch, offset)``: how many epochs the source has been
    fully consumed, and how many items of the current epoch were
    yielded.  ``state_dict()``/``load_state_dict()`` round-trip that
    position; the first iteration after a restore FAST-FORWARDS by
    drawing and discarding ``offset`` items from a fresh source
    iterator, so the next item yielded is exactly the one the killed
    run would have trained on.  Exactness requires a deterministic
    source (fixed-seed shuffle, stable file order) — the same property
    the loss-trajectory drill already needs.

    Used as a reader creator: ``reader()`` returns the epoch's
    iterator, like any other decorator product.
    """

    def __init__(self, reader_creator):
        if not callable(reader_creator):
            raise TypeError(
                "checkpointable() wraps a reader CREATOR (zero-arg "
                "callable returning an iterator); got %r"
                % type(reader_creator).__name__)
        self._creator = reader_creator
        self._epoch = 0
        self._offset = 0
        self._skip_debt = 0      # fast-forward remainder; spans epochs

    def state_dict(self):
        return {"epoch": self._epoch, "offset": self._offset}

    def load_state_dict(self, state):
        self._epoch = int(state["epoch"])
        self._offset = int(state["offset"])
        # the restored position is authoritative: pending fast-forward
        # debt from before the restore would skip healthy batches AT
        # the restored position (the rollback protocol re-applies its
        # own fast_forward after the restore)
        self._skip_debt = 0

    def fast_forward(self, n):
        """Advance the position ``n`` items WITHOUT yielding them — the
        guardian's rollback-recovery uses this to jump past a poisoned
        window (quarantined batches that would deterministically re-trip
        the sentinel on replay).  Takes effect at the next iteration(s):
        unlike the saved ``offset`` (whose overshoot of a SHRUNK source
        resets at the epoch boundary), a fast-forward that overshoots
        the epoch carries its remainder into the next epoch — the
        poisoned window must be skipped, however the epochs fall."""
        self._skip_debt += max(0, int(n))
        return self._offset + self._skip_debt

    def __call__(self):
        it = iter(self._creator())
        skip = self._offset
        for _ in range(skip):
            try:
                next(it)
            except StopIteration:
                # source shrank below the saved offset: treat as an
                # epoch boundary rather than replaying a partial epoch
                self._epoch += 1
                self._offset = 0
                return
        while self._skip_debt:
            try:
                next(it)
            except StopIteration:
                # the skip spans the epoch boundary: roll the epoch,
                # keep the remaining debt for the next iterator
                self._epoch += 1
                self._offset = 0
                return
            self._skip_debt -= 1
            self._offset += 1
        for item in it:
            self._offset += 1
            yield item
        self._epoch += 1
        self._offset = 0

    def __iter__(self):
        return self()


def checkpointable(reader):
    """Wrap a reader creator so its position checkpoints and restores
    exactly (see ``CheckpointableReader``)."""
    return CheckpointableReader(reader)


def chain(*readers):
    """Concatenate readers end to end."""
    def reader():
        for r in readers:
            for e in r():
                yield e
    return reader


def compose(*readers, **kwargs):
    """Zip readers into tuple samples; check_alignment validates equal
    lengths (reference ComposeNotAligned)."""
    check_alignment = kwargs.pop("check_alignment", True)

    def make_tuple(x):
        if isinstance(x, tuple):
            return x
        return (x,)

    def reader():
        rs = [r() for r in readers]
        if not check_alignment:
            for outputs in zip(*rs):
                yield sum(list(map(make_tuple, outputs)), ())
        else:
            for outputs in itertools.zip_longest(*rs):
                if any(o is None for o in outputs):
                    raise ComposeNotAligned(
                        "outputs of readers are not aligned")
                yield sum(list(map(make_tuple, outputs)), ())
    return reader


def buffered(reader, size):
    """Background-thread prefetch buffer (reference buffered)."""
    class _End:
        pass

    def data_reader():
        r = reader()
        q = queue.Queue(maxsize=size)

        def fill():
            try:
                for d in r:
                    q.put(d)
            finally:
                q.put(_End)

        t = threading.Thread(target=fill, daemon=True)
        t.start()
        while True:
            e = q.get()
            if e is _End:
                break
            yield e
    return data_reader


def firstn(reader, n):
    def data_reader():
        for i, item in enumerate(reader()):
            if i == n:
                break
            yield item
    return data_reader


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """Parallel-thread map over a reader (reference xmap_readers:243)."""
    end = object()

    def data_reader():
        in_q = queue.Queue(buffer_size)
        out_q = queue.Queue(buffer_size)
        out_order = [0]

        def read_worker():
            for i, sample in enumerate(reader()):
                in_q.put((i, sample) if order else sample)
            in_q.put(end)

        def map_worker():
            sample = in_q.get()
            while sample is not end:
                if order:
                    order_id, data = sample
                    result = mapper(data)
                    while order_id != out_order[0]:
                        threading.Event().wait(0.001)
                    out_q.put(result)
                    out_order[0] += 1
                else:
                    out_q.put(mapper(sample))
                sample = in_q.get()
            in_q.put(end)  # relay for sibling workers
            out_q.put(end)

        t_read = threading.Thread(target=read_worker, daemon=True)
        t_read.start()
        workers = []
        for _ in range(process_num):
            t = threading.Thread(target=map_worker, daemon=True)
            t.start()
            workers.append(t)

        finished = 0
        while finished < process_num:
            sample = out_q.get()
            if sample is end:
                finished += 1
            else:
                yield sample
    return data_reader


def multiprocess_reader(readers, use_pipe=True, queue_size=1000):
    """Fork one OS process per reader (reference multiprocess_reader:338).
    Samples interleave in arrival order.  A worker that DIES re-raises in
    the consumer — a crashed shard must never read as a clean (truncated)
    end-of-stream."""
    import multiprocessing as mp
    import pickle
    import traceback

    _ERR = "__mp_reader_worker_error__"

    def queue_reader():
        q = mp.Queue(queue_size)

        def worker(r):
            try:
                for sample in r():
                    q.put(pickle.dumps(sample))
            except BaseException:  # noqa: BLE001 — relayed to the consumer
                q.put((_ERR, traceback.format_exc()))
                return
            q.put(None)

        procs = [mp.Process(target=worker, args=(r,), daemon=True)
                 for r in readers]
        for p in procs:
            p.start()
        finished = 0
        while finished < len(readers):
            item = q.get()
            if item is None:
                finished += 1
            elif isinstance(item, tuple) and item and item[0] == _ERR:
                for p in procs:
                    p.terminate()
                raise RuntimeError(
                    "multiprocess_reader worker failed:\n" + item[1])
            else:
                yield pickle.loads(item)
        for p in procs:
            p.join()
    return queue_reader


def cache(reader):
    """Materialize once, replay from memory.

    An interrupted first pass (early break, ``firstn`` wrapper) must not
    poison the cache, so each uncached pass rebuilds from scratch and only
    a fully-consumed pass is kept.
    """
    all_data = []
    state = {"cached": False}

    def data_reader():
        if not state["cached"]:
            fresh = []
            for item in reader():
                fresh.append(item)
                yield item
            all_data[:] = fresh
            state["cached"] = True
        else:
            for item in all_data:
                yield item
    return data_reader


def bucket_by_length(reader, length_fn, bucket_bounds, batch_size,
                     drop_last=False):
    """Group variable-length samples into length buckets and yield
    ``(bound, samples)`` batches where every sample's length fits the
    bucket's bound.

    Each bucket pads to its own fixed bound, so a program sees
    ``len(bucket_bounds)`` feed signatures in all (one executor entry and
    one captured CUDA graph each) while the padding of pad-to-max
    batching shrinks.  Feed a bucket's batch with
    ``DataFeeder.feed(samples, pad_to=bound)``.

    ``length_fn(sample) -> int``; samples longer than the last bound
    raise (declare a final bound >= the true maximum).  Trailing
    partial batches flush at end-of-stream unless ``drop_last``.

    ``batch_size`` may be a per-bucket list (short buckets take larger
    batches so tokens-per-step — and therefore step efficiency — stays
    roughly constant across buckets, the bucket_by_sequence_length
    recipe).
    """
    raw_bounds = [int(b) for b in bucket_bounds]
    if not raw_bounds:
        raise ValueError("bucket_bounds must be non-empty")
    if isinstance(batch_size, (list, tuple)):
        if len(batch_size) != len(raw_bounds):
            raise ValueError("batch_size list must match bucket_bounds")
        raw_sizes = [int(b) for b in batch_size]
    else:
        raw_sizes = [int(batch_size)] * len(raw_bounds)
    # sizes sort WITH their bounds: callers pair them positionally
    pairs = sorted(zip(raw_bounds, raw_sizes))
    bounds = [b for b, _ in pairs]
    sizes = [s for _, s in pairs]

    def data_reader():
        buckets = [[] for _ in bounds]
        for sample in reader():
            n = int(length_fn(sample))
            for i, b in enumerate(bounds):
                if n <= b:
                    buckets[i].append(sample)
                    if len(buckets[i]) == sizes[i]:
                        yield bounds[i], buckets[i]
                        buckets[i] = []
                    break
            else:
                raise ValueError(
                    "sample length %d exceeds the largest bucket bound %d"
                    % (n, bounds[-1]))
        if not drop_last:
            for b, bucket in zip(bounds, buckets):
                if bucket:
                    yield b, bucket
    return data_reader


class Fake(object):
    """Replay the first epoch's samples forever (reference decorator.py
    Fake — the throughput-testing reader that removes data-source cost
    from the measurement)."""

    def __init__(self):
        self.fake_reader = None

    def __call__(self, reader, length):
        def fake():
            if self.fake_reader is None:
                self.fake_reader = list(
                    item for item, _ in zip(reader(), range(length)))
                if not self.fake_reader:
                    raise ValueError(
                        "Fake: the wrapped reader produced no samples")
            for i in range(length):
                yield self.fake_reader[i % len(self.fake_reader)]

        return fake


class PipeReader(object):
    """Stream records from a shell command's stdout (reference
    decorator.py PipeReader — the HDFS/S3 `hadoop fs -cat`-style
    ingestion path).  ``get_line`` yields decoded lines with a bounded
    read buffer."""

    def __init__(self, command, bufsize=8192, file_type="plain"):
        if not isinstance(command, str):
            raise TypeError("a command string is required")
        if file_type not in ("gzip", "plain"):
            raise TypeError("file_type %s is not allowed" % file_type)
        import shlex
        import subprocess
        self.command = command
        self.bufsize = bufsize
        self.file_type = file_type
        self.process = subprocess.Popen(
            shlex.split(command), bufsize=bufsize, stdout=subprocess.PIPE)

    def get_line(self, cut_lines=True, line_break="\n"):
        import codecs
        stream = self.process.stdout
        if self.file_type == "gzip":
            import gzip
            stream = gzip.GzipFile(fileobj=stream)
        # incremental decoder: a multi-byte UTF-8 sequence split across
        # two reads decodes correctly instead of becoming U+FFFD pairs
        decoder = codecs.getincrementaldecoder("utf-8")(errors="replace")
        remained = ""
        while True:
            buf = stream.read(self.bufsize)
            if not buf:
                break
            buf = remained + decoder.decode(buf)
            if not cut_lines:
                remained = ""
                if buf:
                    yield buf
                continue
            lines = buf.split(line_break)
            remained = lines.pop()
            for line in lines:
                yield line
        remained += decoder.decode(b"", final=True)
        if remained:
            yield remained
