"""Per-phase wall-clock accounting (``--timings``).

The reference has no profiling of any kind (SURVEY §5); this is the
framework's observability layer: each pipeline phase (distances, ML
Newton, NJ, WLS, clean, the fused native node alignment, device DP,
merge) accumulates wall time into a process-global table that the CLI
dumps to stderr on request.  Zero overhead when disabled (the context
manager short-circuits).
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager

_acc: dict = {}
_calls: dict = {}
_enabled = False
# the level scheduler runs align phases on a thread pool; the accumulator
# read-modify-writes need a lock or concurrent phases lose updates
_lock = threading.Lock()


def enable(flag: bool = True) -> None:
    global _enabled
    _enabled = flag
    _acc.clear()
    _calls.clear()
    _counters.clear()


@contextmanager
def phase(name: str):
    if not _enabled:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        with _lock:
            _acc[name] = _acc.get(name, 0.0) + (time.perf_counter() - t0)
            _calls[name] = _calls.get(name, 0) + 1


_counters: dict = {}


def count(name: str, n: int = 1) -> None:
    """Accumulate an event counter (reported with --timings); used by the
    device tiers to surface silent-fallback statistics (pairs that left
    the Pallas path and why)."""
    if not _enabled:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def counters() -> dict:
    return dict(_counters)


def enabled() -> bool:
    return _enabled


def recorded() -> tuple:
    """(phase seconds, phase calls, counters) so far, for ``merge`` in
    another process (first_tree.py)."""
    with _lock:
        return dict(_acc), dict(_calls), dict(_counters)


def merge(rec: tuple, suffix: str) -> None:
    """Add another process's ``recorded()`` to this process's table, each
    phase and counter under its name with ``suffix`` added."""
    acc, calls, ctrs = rec
    with _lock:
        for name, t in acc.items():
            name, n = name + suffix, calls[name]
            _acc[name] = _acc.get(name, 0.0) + t
            _calls[name] = _calls.get(name, 0) + n
        for name, n in ctrs.items():
            _counters[name + suffix] = _counters.get(name + suffix, 0) + n


def report(stream) -> None:
    if not _acc and not _counters:
        return
    total = sum(_acc.values())
    print("timings (wall seconds, accounted phases only):", file=stream)
    for name, t in sorted(_acc.items(), key=lambda kv: -kv[1]):
        print("  %-12s %8.4f s  (%6.1f%%, %d calls)"
              % (name, t, 100.0 * t / total if total else 0.0, _calls[name]),
              file=stream)
    print("  %-12s %8.4f s" % ("total", total), file=stream)
    if _counters:
        print("counters:", file=stream)
        for name, n in sorted(_counters.items()):
            print("  %-24s %d" % (name, n), file=stream)
