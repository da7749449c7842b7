"""Frozen operation and byte counts, one module a model family: the
forward's floating-point operations of one request (``request_flops``)
and the work of each attention kernel call it makes
(``attention_calls``), from the configuration file's sizes alone.  They
import nothing of the port, so a change to the program cannot move the
yardstick."""


def causal_pairs(s: int, window=None) -> int:
    """The (query, key) pairs causal attention over ``s`` positions needs:
    query i sees keys max(0, i - window + 1)..i."""
    if window is None or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window
