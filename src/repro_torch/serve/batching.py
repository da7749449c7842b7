"""Dynamic micro-batching: the scheduler between request queue and artifact.

The counterpart of :mod:`repro.serve.batching` for the PyTorch port; the
scheduling is the same, the staging differs (see below).

Requests (one or a few rows each) are enqueued from any thread; a single
worker drains the queue into micro-batches bounded by ``max_batch`` rows and
``max_wait_ms`` of queueing delay, pads each batch up to a power-of-two
*bucket* so the predict program only ever sees a small closed set of batch
shapes (each warmed up eagerly), runs the artifact once per micro-batch, and
scatters the per-row results back to the callers' futures.

Padding uses zero rows and is sliced off before results are returned —
every lowering is row-independent, so padding can never perturb a real
row's prediction (the batch-invariance property tests assert exactly this).

Staging: each micro-batch is written into one of two preallocated buffers
per (bucket, row shape, dtype), used alternately.  When the artifact runs on
a CUDA device, the buffers are pinned host tensors: rows are written
through their ``.numpy()`` view and the tensor is handed to ``predict``,
whose copy to the card then runs asynchronously, with no pageable bounce.
A returning ``predict`` has waited for its copy (it returns host labels),
but one that raises may have left it in flight, so each pinned buffer
carries a CUDA event recorded after its dispatch and waited on before the
buffer is written again (:class:`StagingBuffer`).

Fault tolerance (see :mod:`repro_torch.serve.reliability`):

* **deadlines** — ``submit(x, timeout_s=...)`` attaches a deadline; a
  request that expires while queued is resolved with
  :class:`DeadlineExceeded` and *skipped* when batches form — never
  dispatched, never holding up live batchmates.
* **bounded retry** — a dispatch that raises a :class:`TransientError` is
  retried under the endpoint's :class:`RetryPolicy` (exponential backoff +
  jitter over an injectable clock/sleep).
* **poison-batch bisection** — a batch whose dispatch keeps failing is
  split in halves and the halves retried, recursively: the offending
  request(s) fail alone with a structured :class:`DispatchError`
  (``isolated=True``) while their batchmates are served normally —
  bit-identically, because rows are independent and every sub-batch pads
  to a warmed bucket.  A single poison request in a batch of n costs
  O(log n) extra dispatches.
* **worker survival** — no exception (predict, concatenation of
  incompatible rows, a cancelled future) can kill the worker loop: every
  future of the affected batch resolves with a structured error and the
  loop keeps serving.
"""

from __future__ import annotations

import dataclasses
import queue
import random
import threading
import time
import zlib
from concurrent.futures import Future
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from .reliability import DeadlineExceeded, DispatchError, RetryPolicy

__all__ = ["BatchingPolicy", "MicroBatcher"]


@dataclasses.dataclass(frozen=True)
class BatchingPolicy:
    """Scheduler knobs for one endpoint.

    * ``max_batch``   — row budget of one micro-batch (and the top bucket).
    * ``max_wait_ms`` — how long the first request of a batch may wait for
      company before the batch is dispatched anyway.
    * ``eager_when_idle`` — dispatch a partial batch immediately when the
      queue runs dry instead of idling out the full ``max_wait_ms``: under
      load the queue stays non-empty and batches fill anyway, while a lone
      sequential client is not taxed the wait on every request.  Disable to
      always hold for ``max_wait_ms`` (maximum fill under slow open-loop
      arrivals, at a latency cost).
    * ``bucketing``   — ``pow2``: pad each micro-batch up to the next
      power-of-two bucket (a closed shape set); ``exact``: no padding.
    * ``warmup``      — run every bucket with zero rows before the first
      micro-batch is served (triggered lazily by the first request, which
      supplies the row shape and therefore absorbs the warm-up latency,
      the kernels' first build included).
    * ``replicas``    — data-parallel replica count of the endpoint's
      artifact (set by :class:`repro_torch.serve.router.Endpoint` from
      ``CompiledArtifact.replicas``; 1 for a single-device artifact).  The
      bucket ladder is *replica-aware*: every bucket is ``replicas`` x a
      power-of-two shard.
    """

    max_batch: int = 64
    max_wait_ms: float = 2.0
    eager_when_idle: bool = True
    bucketing: str = "pow2"
    warmup: bool = True
    replicas: int = 1

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if self.max_wait_ms < 0:
            raise ValueError("max_wait_ms must be >= 0")
        if self.bucketing not in ("pow2", "exact"):
            raise ValueError("bucketing must be 'pow2' or 'exact'")
        if self.replicas < 1:
            raise ValueError("replicas must be >= 1")

    def buckets(self) -> Tuple[int, ...]:
        """The closed set of batch shapes predict will be called with (in
        exact mode there is no closed set; only the cap is warmed up)."""
        if self.bucketing == "exact":
            return (self.max_batch,)
        out, b = [], min(self.replicas, self.max_batch)
        while b < self.max_batch:
            out.append(b)
            b *= 2
        out.append(self.max_batch)
        return tuple(out)

    def bucket_for(self, n: int) -> int:
        """Smallest bucket holding ``n`` rows (``n`` itself in exact mode)."""
        if self.bucketing == "exact":
            return n
        for b in self.buckets():
            if b >= n:
                return b
        return self.max_batch

    def clamped(self, max_supported: Optional[int]) -> "BatchingPolicy":
        """Respect an artifact's fixed-batch ceiling (see
        ``CompiledArtifact.max_supported_batch``)."""
        if max_supported is None or self.max_batch <= max_supported:
            return self
        return dataclasses.replace(self, max_batch=max_supported)

    def with_replicas(self, replicas: int,
                      align_top: bool = True) -> "BatchingPolicy":
        """Replica-aware variant of this policy (no-op when it matches).

        ``align_top`` rounds ``max_batch`` up to ``replicas * pow2`` so the
        top bucket is exactly a replica-aligned shard set — otherwise a full
        dispatch on a non-power-of-two replica count would be silently
        re-padded inside the mesh artifact (e.g. 64 rows on 6 replicas pad
        to 96: computed shape 96, warmed/traced shape 64, up to ~50% padded
        work on the busiest bucket).  Callers whose artifact has a hard
        batch ceiling (fixed batch policy — already replica-aligned by
        construction) pass ``align_top=False``.
        """
        replicas = max(1, int(replicas))
        if replicas == self.replicas:
            return self
        max_batch = self.max_batch
        if align_top and replicas > 1:
            per = -(-max_batch // replicas)
            max_batch = replicas * (1 << max(0, (per - 1).bit_length()))
        return dataclasses.replace(self, replicas=replicas,
                                   max_batch=max_batch)


@dataclasses.dataclass
class _Request:
    x: np.ndarray  # (n, ...) rows
    future: Future
    t_enqueue: float
    deadline: Optional[float] = None  # absolute, on the batcher's clock


def _fail(fut: Future, exc: BaseException) -> None:
    """Resolve a future with an exception, tolerating cancelled/raced
    futures — resolving a batch must never abort mid-scatter."""
    try:
        fut.set_exception(exc)
    except BaseException:
        pass


# detach_worker() wake-up sentinel: tells the worker thread to exit while
# leaving the batcher open for an external driver (the fleet coalescer).
_DETACH = object()


class StagingBuffer:
    """One staging buffer: ``handed`` is what predict is given, ``view`` its
    numpy view, where rows are written.

    For a CUDA ``device`` it is a pinned host tensor (for dtypes torch has),
    so its copy to the card runs asynchronously.  :meth:`release`, called by
    the thread that dispatched from the buffer once the dispatch returned or
    raised, records a CUDA event on that thread's current stream, after
    every copy the dispatch enqueued; :meth:`acquire` waits on it before the
    buffer is written again.  Otherwise a numpy array, handed as itself.
    """

    def __init__(self, shape: tuple, dtype,
                 device: Optional[torch.device] = None):
        self.device: Optional[torch.device] = None  # set when pinned
        self._copied = None  # CUDA event: the last copy from the buffer
        if device is not None and device.type == "cuda":
            try:
                tdtype = torch.from_numpy(np.zeros(0, dtype)).dtype
            except TypeError:
                tdtype = None  # no torch dtype: stage in numpy
            if tdtype is not None:
                self.handed = torch.zeros(shape, dtype=tdtype,
                                          pin_memory=True)
                self.view = self.handed.numpy()
                self.device = device
                return
        self.handed = self.view = np.zeros(shape, dtype)

    def acquire(self) -> np.ndarray:
        """The numpy view, once no copy from the buffer can be in flight."""
        if self._copied is not None:
            self._copied.synchronize()
        return self.view

    def release(self) -> None:
        """Mark the end of a dispatch from the buffer (see the class)."""
        if self.device is None:
            return
        if self._copied is None:
            self._copied = torch.cuda.Event()
        self._copied.record(torch.cuda.current_stream(self.device))


# on_batch(n_requests, n_rows, bucket, per-request latencies in seconds,
#          meta=batch metadata dict or None)
OnBatch = Callable[[int, int, int, Sequence[float]], None]
# on_dispatch(ok: bool, exc) — one call per dispatch *attempt* (the circuit
# breaker's outcome feed; retries and bisection sub-dispatches each count)
OnDispatch = Callable[[bool, Optional[BaseException]], None]


class MicroBatcher:
    """Single-worker dynamic micro-batching loop over one predict callable.

    ``predict(x: (bucket, ...)) -> (bucket, ...) per-row outputs``; any
    exception it raises is delivered to the futures of that micro-batch —
    after retries (transient failures, per ``retry``) and poison isolation
    (persistent failures: the batch is bisected so only the offending
    requests fail).  The worker keeps serving subsequent batches no matter
    what predict does.

    ``predict`` may instead return ``(outputs, meta)`` where ``meta`` is a
    dict describing how the batch was served (e.g. the degraded-precision
    flag): the meta dict is stamped onto every future of the batch as
    ``future.batch_meta`` *before* the result is set, and forwarded to the
    ``on_batch`` stats sink.

    ``clock``/``sleep`` default to ``time.perf_counter``/``time.sleep`` and
    are injectable so deadline and backoff behavior is unit-testable.

    ``device`` is the artifact's: for a CUDA device micro-batches are
    staged in pinned host tensors, which ``predict`` must accept; otherwise
    (the default) in numpy arrays.
    """

    def __init__(self, predict: Callable[[np.ndarray], np.ndarray],
                 policy: Optional[BatchingPolicy] = None,
                 on_batch: Optional[OnBatch] = None,
                 name: str = "endpoint",
                 retry: Optional[RetryPolicy] = None,
                 on_dispatch: Optional[OnDispatch] = None,
                 clock: Optional[Callable[[], float]] = None,
                 sleep: Optional[Callable[[float], None]] = None,
                 device: Optional[torch.device] = None):
        self.predict = predict
        self.device = device
        self.policy = policy or BatchingPolicy()
        self.name = name
        self.retry = retry
        self._on_batch = on_batch
        self._on_dispatch = on_dispatch
        self._clock = clock or time.perf_counter
        self._sleep = sleep or time.sleep
        # Deterministic per-endpoint jitter stream (stable across restarts).
        self._rng = random.Random(zlib.crc32(name.encode()) & 0xFFFFFFFF)
        self._queue: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._carry: Optional[_Request] = None  # didn't fit the last batch
        self._warmed = False
        self._closed = False
        self._detached = False
        self._submit_lock = threading.Lock()  # orders submit() vs close()
        # Reliability counters (single-writer: the worker thread; readers
        # tolerate torn reads — they are monotone gauges for stats).
        self.n_expired = 0        # requests resolved with DeadlineExceeded
        self.n_retries = 0        # dispatch retries after transient faults
        self.n_dispatch_failures = 0  # failed dispatch attempts
        self.n_failed_requests = 0    # requests resolved with an error
        # Zero-copy assembly state.  Per-(bucket, row shape, dtype) pair of
        # preallocated staging buffers, used alternately, so a buffer whose
        # copy to the card may still be in flight is never the one being
        # written.  Allocation happens once per key — the steady state
        # writes rows into a long-lived buffer instead of concatenate +
        # fresh pad per dispatch.
        self._staging: dict = {}
        self._staging_parity: dict = {}
        self.n_staging_allocs = 0       # staging buffers ever allocated
        self.n_zero_copy_assemblies = 0  # batches assembled into staging
        self.n_concat_assemblies = 0    # legacy concatenate fallbacks
        self.n_batch1_fastpath = 0      # lone full-bucket requests, no copy
        self.assembly_s = 0.0           # host batch-assembly time
        self.device_s = 0.0             # predict, labels back on the host
        # Optional hook fired after every successful submit() enqueue — the
        # fleet coalescer's wake-up signal (no-arg callable, must not raise).
        self.on_enqueue: Optional[Callable[[], None]] = None
        self._worker: Optional[threading.Thread] = threading.Thread(
            target=self._run, name=f"microbatch-{name}", daemon=True)
        self._worker.start()

    # -- client side ---------------------------------------------------------
    def submit(self, x: np.ndarray,
               timeout_s: Optional[float] = None) -> Future:
        """Enqueue rows; the future resolves to the (n,) per-row outputs.

        ``x`` is one row (1-D, resolves to a length-1 array) or an (n, ...)
        row block with ``n <= max_batch``.  ``timeout_s`` attaches a
        deadline: if the request is still queued when it passes, the future
        resolves with :class:`DeadlineExceeded` instead of being computed.
        """
        x = np.asarray(x)
        if x.ndim == 1:
            x = x[None, :]
        if x.shape[0] > self.policy.max_batch:
            raise ValueError(
                f"request of {x.shape[0]} rows exceeds max_batch "
                f"{self.policy.max_batch}; split it across submissions")
        now = self._clock()
        deadline = None if timeout_s is None else now + max(0.0, timeout_s)
        fut: Future = Future()
        # The closed check and the enqueue must be atomic vs close(), or a
        # racing submit could land a request in a dead queue after the final
        # drain — a future that never resolves.
        with self._submit_lock:
            if self._closed:
                raise RuntimeError(f"MicroBatcher '{self.name}' is closed")
            self._queue.put(_Request(x, fut, now, deadline))
        cb = self.on_enqueue
        if cb is not None:
            try:
                cb()
            except Exception:
                pass  # a wake-up hook must never fail a submit
        return fut

    def depth(self) -> int:
        """Requests currently queued (including a carried head-of-line
        request) — the admission/degradation load signal."""
        return self._queue.qsize() + (1 if self._carry is not None else 0)

    def close(self, drain: bool = True,
              timeout: Optional[float] = None) -> None:
        """Stop the worker; ``drain`` serves queued requests first.

        Every queued future RESOLVES — served while ``timeout`` (seconds of
        total drain budget; None = unbounded) allows, rejected with a
        RuntimeError once the deadline passes or when ``drain`` is False.
        Nothing is silently dropped.
        """
        with self._submit_lock:
            if self._closed:
                return
            self._closed = True
            self._queue.put(None)  # sentinel; no submit can follow it
        deadline = (None if timeout is None
                    else time.perf_counter() + timeout)
        if self._worker is not None:
            self._worker.join(timeout)
        worker_done = self._worker is None or not self._worker.is_alive()
        leftovers = []
        if worker_done and self._carry is not None:
            leftovers.append(self._carry)
            self._carry = None
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if req is _DETACH:
                continue  # stale detach wake-up; nothing to resolve
            if req is None:
                # Shutdown sentinel.  If the worker overran the join timeout
                # it still needs it to terminate — hand it back and stop
                # stealing from the queue (FIFO order guarantees no request
                # sits behind the first sentinel).
                if not worker_done:
                    self._queue.put(None)
                    break
                continue
            leftovers.append(req)
        for req in leftovers:
            # Serving leftovers requires the worker to be gone (predict is
            # single-caller by contract) and budget to remain.
            if drain and worker_done and (
                    deadline is None or time.perf_counter() < deadline):
                self._serve([req])
            else:
                _fail(req.future, RuntimeError(
                    f"MicroBatcher '{self.name}' closed"
                    + (" (drain deadline exceeded)" if drain else "")))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- worker side ---------------------------------------------------------
    def _expired(self, req: _Request, now: Optional[float] = None) -> bool:
        if req.deadline is None:
            return False
        if now is None:
            now = self._clock()
        return now >= req.deadline

    def _expire(self, req: _Request) -> None:
        self.n_expired += 1
        self.n_failed_requests += 1
        _fail(req.future, DeadlineExceeded(
            f"deadline passed after {self._clock() - req.t_enqueue:.3f}s in "
            f"queue on '{self.name}'"))

    def _collect(self) -> Optional[list]:
        """Block for the first live request, then gather until the batch is
        full or the first request's ``max_wait_ms`` budget runs out.
        Requests already past their deadline are resolved with
        :class:`DeadlineExceeded` and never join a batch.  Returns None on
        shutdown sentinel."""
        first = self._carry
        self._carry = None
        while True:
            if first is None:
                if self._detached:
                    return None
                first = self._queue.get()
                if first is None:
                    return None
            if first is _DETACH:
                return None
            if self._detached:
                self._carry = first  # hand head-of-line to the driver
                return None
            if not self._expired(first):
                break
            self._expire(first)
            first = None
        batch, rows = [first], first.x.shape[0]
        deadline = first.t_enqueue + self.policy.max_wait_ms / 1e3
        while rows < self.policy.max_batch:
            wait = deadline - self._clock()
            try:
                if wait <= 0 or self.policy.eager_when_idle:
                    req = self._queue.get_nowait()
                else:
                    req = self._queue.get(timeout=wait)
            except queue.Empty:
                if wait <= 0 or self.policy.eager_when_idle:
                    break
                continue
            if req is None:  # shutdown: serve what we have, then exit
                self._queue.put(None)
                break
            if req is _DETACH:  # detach: serve what we have, then exit
                break
            if self._expired(req):
                self._expire(req)
                continue
            if rows + req.x.shape[0] > self.policy.max_batch:
                self._carry = req  # head-of-line for the next batch
                break
            batch.append(req)
            rows += req.x.shape[0]
        return batch

    # -- external-driver interface (the fleet coalescer) ---------------------
    def detach_worker(self, timeout: float = 5.0) -> None:
        """Retire the internal worker thread WITHOUT closing the batcher.

        Afterward ``submit`` keeps enqueueing but nothing serves the queue
        until an external driver does, via :meth:`collect_nowait` +
        :meth:`serve` — how the fleet coalescer takes over a member
        endpoint's scheduling while preserving its client-facing API.
        Idempotent; :meth:`close` still drains whatever remains.
        """
        if self._worker is None:
            return
        self._detached = True
        self._queue.put(_DETACH)  # wake a blocked _collect
        self._worker.join(timeout)
        if self._worker.is_alive():  # pragma: no cover - defensive
            raise RuntimeError(
                f"MicroBatcher '{self.name}' worker did not detach")
        self._worker = None

    def collect_nowait(self) -> list:
        """Gather the next micro-batch without blocking (external drivers
        only — the internal worker must be detached).  Returns possibly-[].
        Honors carry/deadlines/max_batch exactly like the worker's collect;
        preserves a close() sentinel for the final drain."""
        batch: list = []
        rows = 0
        first = self._carry
        self._carry = None
        if first is not None:
            if self._expired(first):
                self._expire(first)
            else:
                batch, rows = [first], first.x.shape[0]
        while rows < self.policy.max_batch:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if req is None:
                self._queue.put(None)  # keep the shutdown sentinel
                break
            if req is _DETACH:
                continue  # stale wake-up; the driver is already here
            if self._expired(req):
                self._expire(req)
                continue
            if rows + req.x.shape[0] > self.policy.max_batch:
                self._carry = req
                break
            batch.append(req)
            rows += req.x.shape[0]
        return batch

    def serve(self, batch: list) -> None:
        """Serve an externally-collected micro-batch on the caller's thread
        (lazy bucket warmup included) — the coalescer's per-member solo and
        fallback path.  Single-caller, like the worker loop it replaces."""
        if not batch:
            return
        if self.policy.warmup and not self._warmed:
            self._warmup(batch[0].x)
        self._serve(batch)

    def _warmup(self, example: np.ndarray) -> None:
        """Run every bucket once (zero rows shaped like the example)."""
        for b in self.policy.buckets():
            zeros = np.zeros((b,) + example.shape[1:], example.dtype)
            try:
                self.predict(zeros)
            except Exception:
                pass  # real traffic will surface the error with context
        self._warmed = True

    def _staging_buffer(self, bucket: int, trailing: tuple,
                        dtype) -> StagingBuffer:
        """The next staging buffer for this (bucket, row shape, dtype).

        Two buffers per key, returned alternately: the batch being assembled
        must never write the buffer an in-flight copy may still read.  A
        pipeline depth of 1 (a returning ``predict`` has waited for its
        copy) makes two enough; a dispatch that raised is covered by the
        buffer's event (:meth:`StagingBuffer.acquire`).
        """
        key = (bucket,) + tuple(trailing) + (np.dtype(dtype).str,)
        bufs = self._staging.get(key)
        if bufs is None:
            shape = (bucket,) + tuple(trailing)
            bufs = (StagingBuffer(shape, dtype, self.device),
                    StagingBuffer(shape, dtype, self.device))
            self._staging[key] = bufs
            self._staging_parity[key] = 0
            self.n_staging_allocs += 2
        p = self._staging_parity[key]
        self._staging_parity[key] = p ^ 1
        return bufs[p]

    def _assemble(self, batch: list, rows: int,
                  bucket: int) -> Tuple[Any, Optional[StagingBuffer]]:
        """Gather ``batch`` into one (bucket, ...) input without per-dispatch
        allocation on the steady-state path; returns ``(input, the staging
        buffer it lives in or None)``.

        * lone full-bucket request — forwarded as-is, zero copies;
        * homogeneous rows — written at offsets into a preallocated staging
          buffer (pinned for a CUDA artifact), tail zeroed (the padding
          contract: zero rows, sliced off);
        * heterogeneous rows (mismatched trailing shape/dtype — a malformed
          submit) — the legacy ``np.concatenate`` path, preserving its error
          surface: the raise propagates to ``_serve``'s poison bisection.
        """
        first = batch[0].x
        if len(batch) == 1 and rows == bucket:
            self.n_batch1_fastpath += 1
            return first, None
        trailing, dtype = first.shape[1:], first.dtype
        if any(r.x.shape[1:] != trailing or r.x.dtype != dtype
               for r in batch):
            self.n_concat_assemblies += 1
            x = np.concatenate([r.x for r in batch], axis=0)
            if bucket > rows:
                pad = np.zeros((bucket - rows,) + x.shape[1:], x.dtype)
                x = np.concatenate([x, pad], axis=0)
            return x, None
        staged = self._staging_buffer(bucket, trailing, dtype)
        buf = staged.acquire()
        off = 0
        for r in batch:
            n = r.x.shape[0]
            buf[off:off + n] = r.x
            off += n
        if rows < bucket:
            buf[rows:bucket] = 0
        self.n_zero_copy_assemblies += 1
        return staged.handed, staged

    def assembly_stats(self) -> dict:
        """Allocation/timing accounting of the batch-assembly path (the
        zero-copy acceptance hook: steady state must show assemblies growing
        while staging allocations plateau at two per active bucket)."""
        return {"n_staging_allocs": self.n_staging_allocs,
                "n_zero_copy_assemblies": self.n_zero_copy_assemblies,
                "n_concat_assemblies": self.n_concat_assemblies,
                "n_batch1_fastpath": self.n_batch1_fastpath,
                "assembly_s": self.assembly_s,
                "device_s": self.device_s}

    def _dispatch_once(self, batch: list) -> None:
        """One dispatch attempt for ``batch``: assemble into the bucket, run
        predict, record stats, scatter results.  Raises on predict failure
        (nothing resolved); on success every future in ``batch`` resolves."""
        rows = sum(r.x.shape[0] for r in batch)
        bucket = self.policy.bucket_for(rows)
        t0 = self._clock()
        x, staged = self._assemble(batch, rows, bucket)
        t1 = self._clock()
        try:
            out = self.predict(x)
        finally:
            if staged is not None:
                staged.release()
        meta = None
        if type(out) is tuple:  # (outputs, batch metadata)
            out, meta = out
        # predict returns host labels — everything after t1 up to here is
        # copy + launch + device time, split from assembly time.
        y = np.asarray(out)[:rows]
        self.assembly_s += t1 - t0
        self.device_s += self._clock() - t1
        if self._on_dispatch is not None:
            try:
                self._on_dispatch(True, None)
            except Exception:
                pass
        done = self._clock()
        # Stats are recorded BEFORE the futures resolve: a caller woken by
        # its result (e.g. an HTTP client that immediately queries
        # /v1/stats) must already see the batch that served it counted.
        if self._on_batch is not None:
            try:
                self._on_batch(len(batch), rows, bucket,
                               [done - r.t_enqueue for r in batch], meta=meta)
            except Exception:
                pass  # a stats sink must never take down serving
        off = 0
        for r in batch:
            n = r.x.shape[0]
            if meta is not None:
                # Stamped before set_result: a waiter woken by the result
                # can always read the meta of the batch that served it.
                r.future.batch_meta = meta
            try:
                r.future.set_result(y[off:off + n])
            except BaseException:
                pass  # cancelled/raced future; keep scattering the rest
            off += n

    def _try_dispatch(self, batch: list) -> Optional[BaseException]:
        """Dispatch with bounded transient retry; returns None on success
        (futures resolved) or the final exception (nothing resolved)."""
        attempts = self.retry.max_attempts if self.retry is not None else 1
        last: Optional[BaseException] = None
        for attempt in range(attempts):
            try:
                self._dispatch_once(batch)
                return None
            except Exception as e:
                last = e
                self.n_dispatch_failures += 1
                if self._on_dispatch is not None:
                    try:
                        self._on_dispatch(False, e)
                    except Exception:
                        pass
                if (self.retry is None or attempt + 1 >= attempts
                        or not self.retry.retryable(e)):
                    return last
                self.n_retries += 1
                self._sleep(self.retry.backoff_s(attempt, self._rng))
        return last

    def _serve(self, batch: list, isolated: bool = False) -> None:
        """Serve ``batch``: expire the stale, dispatch the live, bisect on
        failure so a poison request fails alone.  Every future in ``batch``
        is resolved by the time this returns; nothing escapes (the worker
        loop must survive any predict/concatenate/future misbehavior)."""
        try:
            now = self._clock()
            live = []
            for r in batch:
                if self._expired(r, now):
                    self._expire(r)
                else:
                    live.append(r)
            if not live:
                return
            err = self._try_dispatch(live)
            if err is None:
                return
            if len(live) == 1:
                self.n_failed_requests += 1
                final = DispatchError(
                    f"dispatch failed on '{self.name}': {err!r}",
                    cause=err, isolated=isolated)
                final.__cause__ = err
                _fail(live[0].future, final)
                return
            # Poison-batch bisection: retry the halves independently so the
            # offending request(s) fail alone.  Each half re-pads to its own
            # (warmed) bucket; row independence keeps survivors' results
            # bit-identical to any other batch composition.
            mid = len(live) // 2
            self._serve(live[:mid], isolated=True)
            self._serve(live[mid:], isolated=True)
        except BaseException as e:  # belt-and-braces: resolve, don't die
            for r in batch:
                if not r.future.done():
                    self.n_failed_requests += 1
                    _fail(r.future, DispatchError(
                        f"scheduler error on '{self.name}': {e!r}", cause=e))

    def _run(self) -> None:
        while True:
            batch = self._collect()
            if batch is None:
                return
            if not batch:
                continue  # everything collected had already expired
            self.serve(batch)
