"""Fleet coalescing: many endpoints' micro-batches, ONE stacked launch.

The counterpart of :mod:`repro.serve.fleet` for the PyTorch port.  The
:class:`FleetCoalescer` takes over scheduling for a set of endpoints whose
artifacts share a :func:`repro_torch.compile.fleet_signature` — their
:class:`~repro_torch.serve.batching.MicroBatcher` workers are detached and
one coalescer thread drains all their queues.  Each round it gathers every
member's pending micro-batch, writes them into slots of a preallocated
``(E, bucket, F)`` staging buffer (double-buffered, pinned host memory when
the stack runs on a CUDA device), and launches the fleet's single stacked
kernel (:class:`repro_torch.compile.FleetStack`).  Outputs are scattered
back to each member's futures bit-identically to that member's own
``predict`` — the stack's slot-isolation contract.

Per-endpoint semantics are preserved, not flattened:

* **degradation** — a member whose precision governor says "degraded"
  leaves the round and is served by its own dispatch path (the fallback
  artifact), exactly as without coalescing;
* **circuit breaking** — a member with a non-closed breaker serves solo so
  its probe dispatches feed its own breaker; successful stacked rounds
  record success on every riding member's breaker;
* **fault isolation** — a stacked dispatch failure falls back to
  per-member serving (retries, poison bisection and all); one member's
  malformed rows never fail another member's round.

Overlap: the stacked launch is *asynchronous* —
``FleetStack.predict_device`` copies the pinned buffer to the card without
blocking, launches, and returns the labels as a device tensor without
waiting for them — and the round is finalized (``.cpu()``, which waits)
only after the *next* round's host assembly has been handed to the device,
so batch assembly for round t+1 runs concurrently with device compute of
round t.  A buffer is written again only two rounds later, after the round
that read it was finalized, so no copy from it can still be in flight; a
launch that raised is covered by the buffer's CUDA event
(:class:`~repro_torch.serve.batching.StagingBuffer`).
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional

import numpy as np

from .batching import StagingBuffer, _fail
from .reliability import DispatchError

__all__ = ["FleetCoalescer"]

# (device_out, stacked=[(slot, endpoint, batch, rows)...], bucket, t_launch)
_Pending = tuple

# How long the idle coalescer thread sleeps between checks of its members'
# queues when nothing woke it (an enqueue wakes it at once).
_IDLE_WAIT_S = 0.05


class FleetCoalescer:
    """Single-threaded cross-endpoint scheduler over one FleetStack.

    ``endpoints`` are the member :class:`~repro_torch.serve.router.Endpoint`\\ s
    in *slot order* — ``endpoints[e]``'s artifact must be member ``e`` of
    ``stack``.  Construction detaches each member's internal worker; the
    members' ``submit`` APIs keep working unchanged, served by this thread.
    """

    def __init__(self, stack, endpoints):
        if len(endpoints) != stack.n_models:
            raise ValueError(f"{len(endpoints)} endpoints for a "
                             f"{stack.n_models}-model stack")
        self.stack = stack
        self.members = list(endpoints)
        # Fill hold: when a round collects some but not all members, wait
        # this long for stragglers before dispatching — a narrow stack
        # wastes the dispatch the whole design exists to amortize.  The
        # members' own max_wait is the latency budget their callers
        # already accepted, so holding for its minimum adds no new tail.
        self._hold_s = min(ep.batcher.policy.max_wait_ms
                           for ep in endpoints) / 1e3
        self._event = threading.Event()
        self._closed = False
        self._warmed = False
        self._pending: Optional[_Pending] = None
        # Double-buffered (E, bucket, F) staging, one pair per bucket: the
        # host->device copy of the in-flight round must never see the
        # buffer the next round is being assembled into.  Pinned when the
        # stack runs on a CUDA device, so that copy does not block.
        self._device = getattr(stack, "device", None)
        self._staging: dict = {}
        self._parity: dict = {}
        self.n_staging_allocs = 0
        # Round accounting (single-writer: the coalescer thread).
        self.n_rounds = 0              # stacked rounds launched
        self.n_stacked_dispatches = 0  # == n_rounds unless a launch raised
        self.n_stacked_requests = 0
        self.n_solo_batches = 0        # member batches served per-endpoint
        self.n_stack_fallbacks = 0     # stacked rounds re-served per member
        self.assembly_s = 0.0          # host staging-buffer assembly time
        self.device_s = 0.0            # launch -> materialized outputs
        for ep in self.members:
            ep.batcher.detach_worker()
            ep.batcher.on_enqueue = self._event.set
        self._worker = threading.Thread(
            target=self._run, name="fleet-coalescer", daemon=True)
        self._worker.start()

    # -- lifecycle -----------------------------------------------------------
    def close(self, timeout: Optional[float] = None) -> None:
        """Stop the coalescer thread and finalize any in-flight round.

        Members' queues are NOT drained here — closing their batchers
        (``Endpoint.close`` / ``ModelRouter.close``) serves what remains on
        the closing thread, exactly as for a detach-free endpoint.
        """
        if self._closed:
            return
        self._closed = True
        self._event.set()
        self._worker.join(timeout)
        self._finalize_pending()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def snapshot(self) -> dict:
        return {"members": [ep.name for ep in self.members],
                "rounds": self.n_rounds,
                "stacked_dispatches": self.n_stacked_dispatches,
                "stacked_requests": self.n_stacked_requests,
                "solo_batches": self.n_solo_batches,
                "stack_fallbacks": self.n_stack_fallbacks,
                "staging_allocs": self.n_staging_allocs,
                "assembly_s": self.assembly_s,
                "device_s": self.device_s}

    # -- round machinery -----------------------------------------------------
    def _staging_buffer(self, bucket: int) -> StagingBuffer:
        """The next (E, bucket, F) staging buffer of this bucket."""
        key = int(bucket)
        bufs = self._staging.get(key)
        if bufs is None:
            shape = (self.stack.n_models, bucket, self.stack.n_features)
            bufs = (StagingBuffer(shape, np.float32, self._device),
                    StagingBuffer(shape, np.float32, self._device))
            self._staging[key] = bufs
            self._parity[key] = 0
            self.n_staging_allocs += 2
        p = self._parity[key]
        self._parity[key] = p ^ 1
        return bufs[p]

    def _warmup(self) -> None:
        """Run the stacked program over the shared bucket ladder before the
        first live round (which builds the fleet kernel) — and every
        member's own solo ladder too: a member can leave the stack at any
        moment (degradation engages, a breaker trips, a malformed row), and
        its first solo batch must not eat a cold ladder mid-traffic."""
        shape = (self.stack.n_models, self.stack.n_features)
        for b in self.members[0].policy.buckets():
            try:
                self.stack.predict_device(
                    np.zeros((shape[0], b, shape[1]), np.float32)).cpu()
            except Exception:
                pass  # live rounds surface the error with fallback
        example = np.zeros((1, shape[1]), np.float32)
        for ep in self.members:
            if ep.batcher.policy.warmup and not ep.batcher._warmed:
                try:
                    ep.batcher._warmup(example)
                except Exception:
                    pass  # solo serving will retry with real rows
        self._warmed = True

    def _serve_solo(self, ep, batch: list) -> None:
        """One member's batch through its own dispatch path (degradation,
        breaker feed, retries, bisection — unchanged semantics)."""
        try:
            ep.batcher.serve(batch)
        except BaseException as e:  # pragma: no cover - serve() resolves all
            for r in batch:
                if not r.future.done():
                    _fail(r.future, DispatchError(
                        f"solo serve error on '{ep.name}': {e!r}", cause=e))
        self.n_solo_batches += 1

    def _round(self) -> bool:
        """Collect/dispatch one coalescing round; True if any work moved."""
        stacked: List[tuple] = []  # (slot, ep, batch, rows)
        solo: List[tuple] = []
        def collect(skip=()):
            for slot, ep in enumerate(self.members):
                if slot in skip:
                    continue
                batch = ep.batcher.collect_nowait()
                if not batch:
                    continue
                rows = sum(r.x.shape[0] for r in batch)
                if ep.fleet_route():
                    stacked.append((slot, ep, batch, rows))
                else:
                    solo.append((ep, batch))

        collect()
        if 2 <= len(stacked) < len(self.members) and self._hold_s > 0:
            # Partial stack: hold briefly for stragglers, then sweep once
            # more.  While a previous round is still on the device the
            # hold overlaps its compute and costs nothing.
            time.sleep(self._hold_s)
            collect(skip={slot for slot, _, _, _ in stacked})
        if not stacked and not solo:
            # Idle: nothing can overlap with the in-flight round — force it
            # out so its callers are not held hostage to future traffic.
            self._finalize_pending()
            return False
        for ep, batch in solo:
            self._serve_solo(ep, batch)
        if len(stacked) < 2:
            # A lone rider gains nothing from the stack (the E-wide dispatch
            # would compute E-1 idle slots); its own path is strictly better.
            for _, ep, batch, _ in stacked:
                self._serve_solo(ep, batch)
            self._finalize_pending()
            return True
        if not self._warmed:
            self._warmup()
        bucket = max(ep.policy.bucket_for(rows)
                     for _, ep, _, rows in stacked)
        t0 = time.perf_counter()
        staged = self._staging_buffer(bucket)
        buf = staged.acquire()
        riders: List[tuple] = []
        for slot, ep, batch, rows in stacked:
            try:
                off = 0
                for r in batch:
                    n = r.x.shape[0]
                    buf[slot, off:off + n] = r.x
                    off += n
                buf[slot, rows:bucket] = 0
            except Exception:
                # Malformed rows (shape/dtype) fail alone on the member's
                # own path (bisection isolates the poison request); the
                # slot's half-written data is simply never scattered.
                self._serve_solo(ep, batch)
                continue
            riders.append((slot, ep, batch, rows))
        if not riders:
            self._finalize_pending()
            return True
        t1 = time.perf_counter()
        try:
            out = self.stack.predict_device(staged.handed)  # not waited for
        except Exception:
            out = None
        finally:
            staged.release()
        if out is None:
            self.n_stack_fallbacks += 1
            for _, ep, batch, _ in riders:
                self._serve_solo(ep, batch)
            self._finalize_pending()
            return True
        self.assembly_s += t1 - t0
        self.n_rounds += 1
        self.n_stacked_dispatches += 1
        # Pipeline depth 1: hand the new round to the device FIRST, then
        # finalize the previous one — round t's materialization wait runs
        # while round t+1 computes, and round t+1's assembly already ran
        # while round t computed.
        prev, self._pending = self._pending, (out, riders, bucket, t1)
        if prev is not None:
            self._finalize_round(prev)
        return True

    def _finalize_pending(self) -> None:
        prev, self._pending = self._pending, None
        if prev is not None:
            self._finalize_round(prev)

    def _finalize_round(self, pending: _Pending) -> None:
        """Materialize a launched round and scatter results to futures.
        Every rider's future resolves by the time this returns."""
        out, riders, bucket, t_launch = pending
        try:
            y = out.cpu().numpy().astype(np.int32, copy=False)  # waits
        except Exception:
            # Deferred device failure: the whole round recomputes on the
            # members' own paths (retry/bisection semantics included).
            self.n_stack_fallbacks += 1
            for _, ep, batch, _ in riders:
                self._serve_solo(ep, batch)
            return
        self.device_s += time.perf_counter() - t_launch
        done = time.perf_counter()
        for slot, ep, batch, rows in riders:
            meta = {"coalesced": True, "degraded": False,
                    "number_format": ep.artifact.target.number_format}
            try:
                ep.stats.record_batch(len(batch), rows, bucket,
                                      [done - r.t_enqueue for r in batch],
                                      meta=meta)
            except Exception:
                pass  # a stats sink must never take down serving
            if ep.breaker is not None:
                ep.breaker.record_success()
            self.n_stacked_requests += len(batch)
            row, off = y[slot], 0
            for r in batch:
                n = r.x.shape[0]
                r.future.batch_meta = meta
                try:
                    r.future.set_result(row[off:off + n])
                except BaseException:
                    pass  # cancelled/raced future; keep scattering
                off += n

    def _run(self) -> None:
        while True:
            if self._closed:
                self._finalize_pending()
                return
            try:
                moved = self._round()
            except BaseException:  # pragma: no cover - belt and braces
                moved = False
            if not moved:
                self._event.wait(_IDLE_WAIT_S)
                self._event.clear()
