"""Deterministic fault injection for the serving plane.

A copy of :mod:`repro.serve.faults` for the PyTorch port.  Every failure
mode the serving plane claims to tolerate must be reproducible in a test.
This module is the single chaos source: a seeded :class:`FaultPlan` (a list
of :class:`FaultRule`\\ s) drives a :class:`FaultInjector` whose hooks are
threaded through the serving stack at named **sites**:

========================  ==================================================
site                      where it fires
========================  ==================================================
``endpoint.dispatch``     :meth:`repro_torch.serve.router.Endpoint._dispatch`,
                          once per micro-batch dispatch (``name`` = endpoint)
``cache.compile``         :meth:`repro_torch.serve.cache.ArtifactCache
                          .get_or_compile`, in the single-flight owner
                          (``name`` = lowering kind)
``artifact.load``         a byte filter over an archive (``corrupt`` rules
                          flip seeded bytes; ``name`` = path)
``mesh.replica``          once per replica-shard execution of a fused mesh
                          artifact while its health is tracked
                          (:func:`repro_torch.compile.specialize_mesh`;
                          ``name`` = replica id)
``http.request``          once per parsed HTTP request (``name`` = path)
========================  ==================================================

Rules are matched by site + ``match`` substring (+ optional ``poison``
sentinel contained in the batch), and fire deterministically: per-rule
eligible-event counters drive ``first`` / ``every`` / ``count``, and the
probabilistic form (``p < 1``) draws from a per-rule ``random.Random``
seeded from ``(plan seed, rule index)`` — the same plan replayed over the
same traffic fires the same faults.

Actions: ``error`` raises :class:`TransientInjectedFault` (retryable) or
:class:`InjectedFault` (``transient=False`` — a poison, never retried),
``delay`` sleeps ``delay_s`` (slow/hung dispatch), ``corrupt`` flips
seeded bytes in a byte-filter site.

Activation: programmatic (``install(plan)`` / the :func:`inject` context
manager — what the tests use) or
env-gated for whole-process chaos: ``REPRO_FAULTS`` holds the plan JSON
(or ``@/path/to/plan.json``), read once at first use.  With no plan
installed every hook is a single ``None`` check — the production hot path
stays unperturbed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import random
import threading
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np

from .reliability import TransientError

__all__ = [
    "InjectedFault", "TransientInjectedFault", "FaultRule", "FaultPlan",
    "FaultInjector", "install", "uninstall", "current", "inject",
    "fire", "filter_bytes", "active_for", "SITES",
]

SITES = ("endpoint.dispatch", "cache.compile", "artifact.load",
         "mesh.replica", "http.request")


class InjectedFault(RuntimeError):
    """A deliberately injected, non-retryable fault (a poison)."""


class TransientInjectedFault(InjectedFault, TransientError):
    """A deliberately injected fault the retry layer may retry."""


@dataclasses.dataclass(frozen=True)
class FaultRule:
    """One deterministic fault source.

    * ``site``   — where the rule applies (see module table).
    * ``kind``   — ``error`` (raise), ``delay`` (sleep ``delay_s``),
      ``corrupt`` (flip ``corrupt_bytes`` seeded bytes; byte-filter sites).
    * ``match``  — substring filter on the hook's ``name`` ('' = all).
    * ``poison`` — fire only when the dispatched batch contains this exact
      value (the poison-row sentinel); None = unconditional.
    * ``first`` / ``every`` / ``count`` — fire on eligible events
      ``first, first+every, first+2*every, ...`` at most ``count`` times
      (None = forever).
    * ``p``      — fire probability per otherwise-eligible event (seeded).
    * ``transient`` — error kind raises the retryable fault class.
    """

    site: str
    kind: str = "error"
    match: str = ""
    poison: Optional[float] = None
    first: int = 0
    every: int = 1
    count: Optional[int] = None
    p: float = 1.0
    delay_s: float = 0.0
    transient: bool = True
    corrupt_bytes: int = 8
    message: str = ""

    def __post_init__(self):
        if self.kind not in ("error", "delay", "corrupt"):
            raise ValueError(f"unknown fault kind '{self.kind}'")
        if self.first < 0 or self.every < 1:
            raise ValueError("first must be >= 0 and every >= 1")
        if self.count is not None and self.count < 1:
            raise ValueError("count must be >= 1 (or None)")
        if not 0.0 < self.p <= 1.0:
            raise ValueError("p must be in (0, 1]")
        if self.delay_s < 0:
            raise ValueError("delay_s must be >= 0")
        if self.corrupt_bytes < 1:
            raise ValueError("corrupt_bytes must be >= 1")

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


class FaultPlan:
    """A seeded, serializable list of fault rules."""

    def __init__(self, rules: Sequence[FaultRule], seed: int = 0):
        self.rules = tuple(rules)
        self.seed = int(seed)
        for r in self.rules:
            if not isinstance(r, FaultRule):
                raise TypeError(f"rules must be FaultRule, got {type(r)}")

    def to_dict(self) -> Dict[str, Any]:
        return {"seed": self.seed, "rules": [r.to_dict() for r in self.rules]}

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FaultPlan":
        return cls([FaultRule(**r) for r in d.get("rules", [])],
                   seed=d.get("seed", 0))

    @classmethod
    def from_json(cls, spec: str) -> "FaultPlan":
        """Parse a plan from JSON text, ``@path``, or a plan-file path."""
        if spec.startswith("@"):
            with open(spec[1:]) as f:
                spec = f.read()
        elif not spec.lstrip().startswith(("{", "[")) and os.path.exists(spec):
            with open(spec) as f:
                spec = f.read()
        try:
            return cls.from_dict(json.loads(spec))
        except json.JSONDecodeError as e:
            raise ValueError(
                f"fault plan spec is neither JSON nor a readable plan file: "
                f"{spec[:80]!r} ({e})") from None


class _RuleState:
    __slots__ = ("eligible", "fired", "rng")

    def __init__(self, seed: int, idx: int):
        self.eligible = 0  # eligible events seen (site+match+poison hit)
        self.fired = 0
        self.rng = random.Random((seed * 1000003 + idx) & 0xFFFFFFFF)


class FaultInjector:
    """Executes a :class:`FaultPlan` at the serving stack's fault sites."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._lock = threading.Lock()
        self._state = [_RuleState(plan.seed, i)
                       for i in range(len(plan.rules))]
        self._sites = {r.site for r in plan.rules}

    def active_for(self, site: str) -> bool:
        return site in self._sites

    def _eligible(self, rule: FaultRule, name: str, batch) -> bool:
        if rule.match and rule.match not in name:
            return False
        if rule.poison is not None:
            if batch is None:
                return False
            b = np.asarray(batch)
            if np.isnan(rule.poison):
                if not np.isnan(b).any():
                    return False
            elif not (b == rule.poison).any():
                return False
        return True

    def _should_fire(self, rule: FaultRule, st: _RuleState) -> bool:
        """Counter/probability gate; must be called under the lock."""
        i = st.eligible
        st.eligible += 1
        if i < rule.first or (i - rule.first) % rule.every != 0:
            return False
        if rule.count is not None and st.fired >= rule.count:
            return False
        if rule.p < 1.0 and st.rng.random() >= rule.p:
            return False
        st.fired += 1
        return True

    def fire(self, site: str, name: str = "", batch=None,
             sleep=time.sleep) -> None:
        """Run every matching rule at ``site``; may sleep and/or raise.

        Delay rules sleep first (a slow dispatch may *then* fail), then at
        most one error rule raises.
        """
        raise_exc: Optional[BaseException] = None
        for rule, st in zip(self.plan.rules, self._state):
            if rule.site != site or rule.kind == "corrupt":
                continue
            if not self._eligible(rule, name, batch):
                continue
            with self._lock:
                fires = self._should_fire(rule, st)
            if not fires:
                continue
            if rule.kind == "delay":
                sleep(rule.delay_s)
            elif raise_exc is None:
                msg = rule.message or (f"injected fault at {site}"
                                       + (f" ({name})" if name else ""))
                cls = TransientInjectedFault if rule.transient else InjectedFault
                raise_exc = cls(msg)
        if raise_exc is not None:
            raise raise_exc

    def filter_bytes(self, site: str, data: bytes, name: str = "") -> bytes:
        """Apply ``corrupt`` rules at a byte-filter site (archive load):
        flips ``corrupt_bytes`` deterministically-seeded bytes."""
        for rule, st in zip(self.plan.rules, self._state):
            if rule.site != site or rule.kind != "corrupt":
                continue
            if not self._eligible(rule, name, None):
                continue
            with self._lock:
                fires = self._should_fire(rule, st)
            if not fires or not data:
                continue
            buf = bytearray(data)
            for _ in range(rule.corrupt_bytes):
                pos = st.rng.randrange(len(buf))
                buf[pos] ^= 0xFF
            data = bytes(buf)
        return data

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "seed": self.plan.seed,
                "rules": [
                    {"site": r.site, "kind": r.kind, "match": r.match,
                     "eligible": st.eligible, "fired": st.fired}
                    for r, st in zip(self.plan.rules, self._state)
                ],
                "fired_total": sum(st.fired for st in self._state),
            }


# ---------------------------------------------------------------------------
# process-global installation (programmatic or REPRO_FAULTS env gate)
# ---------------------------------------------------------------------------
_GLOBAL_LOCK = threading.Lock()
_INJECTOR: Optional[FaultInjector] = None
_ENV_CHECKED = False


def install(plan: "FaultPlan | FaultInjector") -> FaultInjector:
    """Install ``plan`` as the process-wide injector (replacing any)."""
    global _INJECTOR, _ENV_CHECKED
    inj = plan if isinstance(plan, FaultInjector) else FaultInjector(plan)
    with _GLOBAL_LOCK:
        _INJECTOR = inj
        _ENV_CHECKED = True  # explicit install wins over the env gate
    return inj


def uninstall() -> None:
    global _INJECTOR
    with _GLOBAL_LOCK:
        _INJECTOR = None


def current() -> Optional[FaultInjector]:
    """The installed injector, consulting ``REPRO_FAULTS`` once."""
    global _INJECTOR, _ENV_CHECKED
    if _INJECTOR is not None:
        return _INJECTOR
    if not _ENV_CHECKED:
        with _GLOBAL_LOCK:
            if not _ENV_CHECKED:
                _ENV_CHECKED = True
                spec = os.environ.get("REPRO_FAULTS")
                if spec:
                    _INJECTOR = FaultInjector(FaultPlan.from_json(spec))
    return _INJECTOR


@contextlib.contextmanager
def inject(plan: FaultPlan):
    """Scoped installation: ``with faults.inject(plan) as inj: ...``."""
    inj = install(plan)
    try:
        yield inj
    finally:
        uninstall()


def active_for(site: str) -> bool:
    inj = current()
    return inj is not None and inj.active_for(site)


def fire(site: str, name: str = "", batch=None, sleep=time.sleep) -> None:
    """Module-level hook: one ``None`` check when no plan is installed."""
    inj = current()
    if inj is not None:
        inj.fire(site, name=name, batch=batch, sleep=sleep)


def filter_bytes(site: str, data: bytes, name: str = "") -> bytes:
    inj = current()
    return data if inj is None else inj.filter_bytes(site, data, name=name)
