"""Continuous-batching request scheduler (counterpart of
``paddle_tpu/serving/scheduler.py``).

Requests queue with a length; the scheduler admits them into a fixed
number of slots, padding each admitted prompt to the smallest bucket
bound that covers it, and recycles a finished request's slot to the next
queued request without draining the rest of the batch.  A request may
hold several rows of the batch (a client micro-batch, ``rows``).  An
optional ``admission_gate(req, picked_so_far) -> bool`` vets each
candidate (the paged engine's free-page check); a refused request stays
queued, in order, for a later admission.  It is pure
control logic: time enters only through the injected ``clock``.  One
condition variable makes ``submit`` safe from any thread; the engine's
loop thread calls ``admit`` / ``complete`` / ``fail``.

With request tracing on (``FLAGS_trace``), ``submit`` hangs a
``monitor.tracing.RequestTrace`` on each request before the loop can see
it; the engine then closes its queue wait at admission and records its
dispatches, and the terminal publishes the request's root span.
"""

import collections
import itertools
import threading
import time

from ..monitor import tracing

__all__ = [
    "ServingRequest", "BatchPlan", "ContinuousBatchingScheduler",
    "RequestTimeoutError", "PoisonedRequestError", "EngineClosedError",
]


class RequestTimeoutError(RuntimeError):
    """The request spent longer than its timeout budget (queued or
    running)."""


class PoisonedRequestError(RuntimeError):
    """The request's forward produced non-finite outputs; it was failed
    and the engine kept serving the rest of the batch."""


class EngineClosedError(RuntimeError):
    """The engine shut down before the request completed."""


_req_ids = itertools.count()


class ServingRequest:
    """One queued unit of work, doubling as the caller's future:
    ``result()`` blocks until the engine completes or fails it."""

    def __init__(self, payload, length=0, arrival=0.0, deadline=None,
                 rows=1):
        self.id = "req-%06d" % next(_req_ids)
        self.payload = payload
        self.length = int(length)
        self.rows = max(1, int(rows))
        self.slots_held = []
        self.arrival = arrival
        self.deadline = deadline
        self.status = "queued"     # queued|running|ok|failed|expired|
        self.slot = None           # quarantined|cancelled
        self.admitted_at = None
        self.finished_at = None
        self.bucket = None
        # the request's tracing.RequestTrace while FLAGS_trace is on;
        # every later site gates on None, so a dark engine never calls it
        self.trace = None
        self._result = None
        self._error = None
        self._done = threading.Event()

    def result(self, timeout=None):
        """Block for the engine's verdict; returns the result payload or
        raises the failure."""
        if not self._done.wait(timeout):
            raise TimeoutError("request %s still pending" % self.id)
        if self._error is not None:
            raise self._error
        return self._result

    def done(self):
        return self._done.is_set()

    def _finish(self, result, status="ok", now=None):
        self.status = status
        self.finished_at = now
        self._result = result
        self._done.set()

    def _fail(self, error, status="failed", now=None):
        self.status = status
        self.finished_at = now
        self._error = error
        self._done.set()

    def __repr__(self):
        return "ServingRequest(%s, len=%d, %s)" % (self.id, self.length,
                                                   self.status)


class BatchPlan:
    """One admission decision: which requests run, in which slots, at
    which padded bucket length."""

    def __init__(self, requests, slots, bucket):
        self.requests = list(requests)
        self.slots = list(slots)
        self.bucket = bucket

    def __repr__(self):
        return "BatchPlan(%d reqs, bucket=%s, slots=%s)" % (
            len(self.requests), self.bucket, self.slots)


class ContinuousBatchingScheduler:
    """Thread-safe FIFO queue + fixed-slot admission + timeout expiry."""

    def __init__(self, slots, bucket_bounds=None, clock=time.monotonic,
                 default_timeout_s=None, max_queue=4096,
                 admission_gate=None, trace_kind="request"):
        if slots < 1:
            raise ValueError("need at least one slot")
        self.slots = int(slots)
        # the ``kind`` of request trace roots ("infer" / "generate")
        self.trace_kind = str(trace_kind)
        self.bucket_bounds = (sorted(int(b) for b in bucket_bounds)
                              if bucket_bounds else None)
        self._clock = clock
        self.default_timeout_s = default_timeout_s
        self.max_queue = int(max_queue)
        self.admission_gate = admission_gate
        self._cv = threading.Condition()
        self._queue = collections.deque()
        self._free = collections.deque(range(self.slots))
        self._running = {}           # slot -> request
        self._closed = False

    def bucket_for(self, length):
        """Smallest bound covering ``length``, or None when unbucketed."""
        if self.bucket_bounds is None:
            return None
        for b in self.bucket_bounds:
            if b >= length:
                return b
        raise ValueError(
            "request length %d exceeds the top bucket bound %d"
            % (length, self.bucket_bounds[-1]))

    def submit(self, payload, length=0, timeout_s=None, rows=1):
        """Enqueue one request of ``rows`` batch rows; returns it (the
        caller's future)."""
        timeout_s = (self.default_timeout_s if timeout_s is None
                     else timeout_s)
        if rows > self.slots:
            raise ValueError("request rows %d exceed the %d-slot batch"
                             % (rows, self.slots))
        now = self._clock()
        # timeout_s=0 is an already-expired budget, not "no limit"
        req = ServingRequest(
            payload, length, arrival=now,
            deadline=(now + timeout_s) if timeout_s is not None else None,
            rows=rows)
        req.bucket = self.bucket_for(req.length)
        # attached before the request is visible to the admission loop,
        # so an admission racing this submit already sees it
        if tracing._enabled:
            req.trace = tracing.RequestTrace(
                req.id, kind=self.trace_kind, length=req.length,
                rows=req.rows, parent=tracing.current())
        with self._cv:
            if self._closed:
                raise EngineClosedError("scheduler is closed")
            if len(self._queue) >= self.max_queue:
                raise RuntimeError(
                    "serving queue full (%d requests)" % self.max_queue)
            self._queue.append(req)
            self._cv.notify_all()
        return req

    def admit(self, now=None, max_batch=None):
        """One admission decision: ``(plan_or_None, expired_requests)``.
        Expires timed-out queued requests, then admits up to the free row
        count (at most ``max_batch`` rows) FIFO: the head request picks the
        bucket and the scan fills the batch with queued requests that fit
        it and the rows left."""
        now = self._clock() if now is None else now
        with self._cv:
            expired = self._expire_queued_locked(now)
            limit = len(self._free)
            if max_batch is not None:
                limit = min(limit, int(max_batch))
            if not self._queue or limit < 1:
                return None, expired
            bucket = self._queue[0].bucket
            picked, kept, rows = [], collections.deque(), 0
            while self._queue and rows < limit:
                req = self._queue.popleft()
                if (bucket is None or req.length <= bucket) \
                        and rows + req.rows <= limit \
                        and (self.admission_gate is None
                             or self.admission_gate(req, picked)):
                    picked.append(req)
                    rows += req.rows
                else:
                    kept.append(req)
            kept.extend(self._queue)      # the unscanned tail, in order
            self._queue = kept
            if not picked:
                return None, expired
            slots = []
            for req in picked:
                req.slots_held = [self._free.popleft()
                                  for _ in range(req.rows)]
                req.slot = req.slots_held[0]
                req.status = "running"
                req.admitted_at = now
                self._running[req.slot] = req
                slots.extend(req.slots_held)
            return BatchPlan(picked, slots, bucket), expired

    def _expire_queued_locked(self, now):
        expired = []
        keep = collections.deque()
        for req in self._queue:
            if req.deadline is not None and now >= req.deadline:
                req._fail(RequestTimeoutError(
                    "request %s expired after %.3fs in queue"
                    % (req.id, now - req.arrival)), status="expired",
                    now=now)
                expired.append(req)
            else:
                keep.append(req)
        self._queue = keep
        return expired

    def expired_running(self, now=None):
        """Running requests past their deadline; the caller must ``fail``
        each."""
        now = self._clock() if now is None else now
        with self._cv:
            return [r for r in self._running.values()
                    if r.deadline is not None and now >= r.deadline]

    def _release_locked(self, req):
        if req.slot is not None and self._running.get(req.slot) is req:
            del self._running[req.slot]
            self._free.extend(req.slots_held or [req.slot])
            self._cv.notify_all()

    def complete(self, req, result, now=None):
        """Finish one running request and recycle its slot.  Returns False
        when the request had already reached a terminal state."""
        now = self._clock() if now is None else now
        with self._cv:
            self._release_locked(req)
        if req.done():
            return False
        req._finish(result, now=now)
        return True

    def fail(self, req, error, status="failed", now=None):
        now = self._clock() if now is None else now
        with self._cv:
            self._release_locked(req)
        if req.done():
            return False
        req._fail(error, status=status, now=now)
        return True

    def wait_for_work(self, timeout=None):
        """Block until a request is queued (and a slot is free) or the
        scheduler closes; returns whether work might be available."""
        with self._cv:
            if self._closed:
                return False
            if self._queue and self._free:
                return True
            self._cv.wait(timeout)
            return bool(self._queue and self._free) and not self._closed

    def close(self, error=None):
        """Refuse new work and fail everything in flight."""
        error = error or EngineClosedError("serving engine closed")
        with self._cv:
            self._closed = True
            pending = list(self._queue) + list(self._running.values())
            self._queue.clear()
            self._running.clear()
            self._free = collections.deque(range(self.slots))
            self._cv.notify_all()
        for req in pending:
            req._fail(error, status="cancelled")

    @property
    def closed(self):
        return self._closed

    def queue_depth(self):
        with self._cv:
            return len(self._queue)

    def busy_slots(self):
        with self._cv:
            return sum(r.rows for r in self._running.values())

    def occupancy(self):
        """Busy fraction of the fixed slot batch."""
        return self.busy_slots() / float(self.slots)

    def running(self):
        """Snapshot of the running requests, by first slot."""
        with self._cv:
            return dict(self._running)

    def pending(self):
        """Snapshot of the queued requests, in FIFO order."""
        with self._cv:
            return list(self._queue)
