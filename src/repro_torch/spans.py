"""Named spans of the LM forward: where a request's host and card time go.

The forward opens a span around each of its layers (:data:`NAMES`).  Off
(the default), :func:`span` returns one shared object whose ``with`` does
nothing: no allocation, no profiler call, no clock read.  On
(:func:`enable`), each span records a :class:`Span`: its name, the index of
the span it opened inside (-1 at the top), and its start and end in
Unix-epoch nanoseconds, the clock ``torch.profiler`` puts its host and card
events on, so the records lie beside a trace's kernels.  A span opens no
profiler range: the records alone are read.

A forward's spans follow its ``lm.forward`` span in the records, each
naming its enclosing span's index, so one request's spans are taken
together by following the parents up to that forward.  :func:`take`
returns the records and clears them.  The records are kept in memory, for
one thread's forwards at a time.
"""

from __future__ import annotations

import time
from array import array
from typing import Dict, List, NamedTuple

__all__ = ["Span", "NAMES", "span", "enable", "disable", "take"]

# each span of the forward, outermost first
NAMES = ("lm.forward",  # the whole forward: embedding, layers, head
         "lm.embed",    # token embedding, with a vision prefix's projection
         "lm.block",    # one layer of the stack
         "lm.norm",     # a norm (the blocks' and the final one)
         "lm.attn",     # a block's attention, projections included
         "lm.rope",     # the rotary embedding of queries and keys
         "lm.mlp",      # a block's MLP
         "lm.gate",     # the MLP's activation and gating multiply
         "lm.logits",   # the final norm and the logits
         "lm.mamba",    # a Mamba2 mixer: projections, conv, scan, gated norm
         "lm.ssd",      # the mixer's SSD chunk scan
         "lm.shared")   # a zamba2 shared-block call: concat, norms,
                        # attention, adapter MLP and the call's linear


class Span(NamedTuple):
    name: str
    parent: int  # index of the enclosing span in the records, -1 if none
    start_ns: int
    end_ns: int


class _Off:
    """What :func:`span` returns while spans are off."""
    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, typ, value, tb) -> None:
        return None


class _Recorder:
    """What :func:`span` returns while spans are on: one object a name,
    shared (spans nest, so the open ones are a stack)."""
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> None:
        _starts.append(time.time_ns())
        _parents.append(_open[-1] if _open else -1)
        _open.append(len(_names))
        _names.append(self.name)
        _ends.append(0)

    def __exit__(self, typ, value, tb) -> None:
        _ends[_open.pop()] = time.time_ns()


_OFF = _Off()
_recorders: Dict[str, _Recorder] = {}
_on = False
# the records, one entry each a span, in the order they opened: kept in
# arrays of integers, so recording makes no object the garbage collector
# tracks (a list a record made a vqa request's dispatch wait on
# collections of the whole heap)
_names: List[str] = []
_parents = array("q")
_starts = array("q")
_ends = array("q")
_open: List[int] = []  # indices of the spans open now, innermost last


def span(name: str):
    """A context manager around one part of the forward."""
    if not _on:
        return _OFF
    rec = _recorders.get(name)
    if rec is None:
        rec = _recorders[name] = _Recorder(name)
    return rec


def enable() -> None:
    """Spans on: every span from here on is recorded."""
    global _on
    _on = True


def disable() -> None:
    """Spans off; what was recorded stays until :func:`take`."""
    global _on
    _on = False


def take() -> List[Span]:
    """The spans recorded since the last call, in the order they opened;
    clears them.  Called outside any span."""
    if _open:
        raise RuntimeError(f"take() inside {len(_open)} open span(s)")
    out = [Span(*r) for r in zip(_names, _parents, _starts, _ends)]
    _names.clear()
    for a in (_parents, _starts, _ends):
        del a[:]
    return out
