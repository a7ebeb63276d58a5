"""Spans and counters of the program's phases, on the host clock.

The recorder is off by default.  Off, :func:`span` returns one shared
no-op context after a single flag check, and :func:`count`, :func:`add`
and :func:`correlate` return at once: nothing is kept and no
``torch.profiler.record_function`` is entered.  :func:`timed` always reads
the clock (the train loops' ``Data:`` / ``Time:`` meters and the service's
dispatch latency take their readings from it) and records only when on.

On (:func:`enable` / :func:`disable`, or ``with recording():``):

* each span keeps its name, its start and end (``time.perf_counter()``
  seconds), its parent (the innermost span open on the same thread), its
  thread, a correlation id (``cid``: the train loop's iteration, or the
  service's request id; a span without one takes its parent's, else the
  thread's :func:`correlate`), its attributes and its counts;
* every span also enters ``torch.profiler.record_function(name)``, so any
  ``torch.profiler`` trace shows the phases over the kernels;
* :func:`count` adds to the innermost open span of the calling thread (or
  to the thread's counts outside any span);
* on a CUDA machine the synchronizing CUDA calls are counted as ``sync``:
  ``torch.cuda.set_sync_debug_mode("warn")`` makes each one raise a
  warning in the calling thread (the autograd engine replays the
  backward's in the thread that called it), which the recorder takes
  into the counter instead of printing; :func:`disable` restores the
  previous mode.  The mode sees the blocking copies and reads
  (``.item()``, ``.cpu()``, a host tensor's blocking ``.to(device)``,
  ``torch.tensor(..., device=)``), not ``torch.cuda.synchronize()``.

Records stay in memory in per-thread lists until :func:`drain` hands them
out; nothing is written to disk.  :func:`summary` gives each name's count,
total and self seconds (self: the duration less what its child spans
cover) and counts.

This module imports the standard library alone (torch when the recorder is
turned on), so the loader's worker processes stay light.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
import warnings
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional

SYNC = "sync"
_SYNC_TEXT = "synchronizing CUDA operation"

_on = False
_lock = threading.Lock()
_local = threading.local()
_threads: List["_ThreadState"] = []
_ids = itertools.count(1)
_record_function = None
_sync: Optional[Dict] = None    # what enable() changed to count syncs
_prev_show = warnings.showwarning


@dataclass
class Record:
    """One finished span."""
    name: str
    t0: float
    t1: float
    id: int
    parent: Optional[int]
    thread: int
    cid: Any
    attrs: Dict[str, Any]
    counts: Dict[str, int]

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


@dataclass
class Recording:
    """What :func:`drain` hands out: the finished spans, and the counts
    made outside any span, by counter."""
    records: List[Record]
    loose: Dict[str, int] = field(default_factory=dict)

    def totals(self) -> Dict[str, int]:
        """Every count, inside spans and outside, by counter."""
        out = dict(self.loose)
        for r in self.records:
            for k, n in r.counts.items():
                out[k] = out.get(k, 0) + n
        return out


class _ThreadState:
    def __init__(self):
        self.thread = threading.current_thread()
        self.records: List[Record] = []
        self.stack: List["_Span"] = []
        self.loose: Dict[str, int] = {}
        self.cid: Any = None


def _state() -> _ThreadState:
    st = getattr(_local, "st", None)
    if st is None:
        st = _local.st = _ThreadState()
        with _lock:
            _threads.append(st)
    return st


class _Noop:
    """The shared context of a span while the recorder is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Clock:
    """:func:`timed` while the recorder is off: the two clock reads."""
    __slots__ = ("t0", "t1")

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter()
        return False

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


class _Span(_Clock):
    __slots__ = ("name", "cid", "attrs", "counts", "id", "parent", "_st",
                 "_rf")

    def __init__(self, name: str, cid: Any, attrs: Dict[str, Any]):
        self.name, self.cid, self.attrs = name, cid, attrs
        self.counts: Dict[str, int] = {}

    def __enter__(self):
        st = self._st = _state()
        parent = st.stack[-1] if st.stack else None
        self.parent = parent.id if parent is not None else None
        if self.cid is None:
            self.cid = parent.cid if parent is not None else st.cid
        self.id = next(_ids)
        self._rf = _record_function(self.name)
        self._rf.__enter__()
        st.stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter()
        st = self._st
        st.stack.pop()
        self._rf.__exit__(*exc)
        st.records.append(Record(self.name, self.t0, self.t1, self.id,
                                 self.parent, st.thread.ident, self.cid,
                                 self.attrs, self.counts))
        return False


def enabled() -> bool:
    return _on


def span(name: str, cid: Any = None, **attrs):
    """A context that records the phase ``name`` while the recorder is on;
    the shared no-op context while it is off."""
    if not _on:
        return _NOOP
    return _Span(name, cid, attrs)


def timed(name: str, cid: Any = None, **attrs):
    """A context whose ``t0``, ``t1`` and ``seconds`` are its clock reads,
    on or off; it records the span ``name`` while the recorder is on."""
    if not _on:
        return _Clock()
    return _Span(name, cid, attrs)


def add(name: str, t0: float, t1: float, cid: Any = None,
        **attrs) -> None:
    """Record a span from clock reads made elsewhere (a request's wait in
    the queue: from its submit on one thread to its pickup on another).
    It has no parent and no ``record_function``."""
    if not _on:
        return
    st = _state()
    st.records.append(Record(name, t0, t1, next(_ids), None,
                             st.thread.ident, cid, attrs, {}))


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of the innermost span open on this
    thread (of the thread's counts outside any span if none is)."""
    if not _on:
        return
    st = _state()
    counts = st.stack[-1].counts if st.stack else st.loose
    counts[name] = counts.get(name, 0) + n


def correlate(cid: Any) -> None:
    """The correlation id of this thread's spans that open outside any
    other span and name none (the train loop's iteration)."""
    if not _on:
        return
    _state().cid = cid


def _show_warning(message, category, filename, lineno, file=None,
                  line=None):
    if _SYNC_TEXT in str(message):
        count(SYNC)
        return
    _prev_show(message, category, filename, lineno, file, line)


def _sync_debug():
    """``torch.cuda`` where a CUDA card can be asked for its sync debug
    mode, else None."""
    import torch
    return torch.cuda if torch.cuda.is_available() else None


def counting_syncs() -> bool:
    """Whether the recorder counts synchronizing CUDA calls (on, with a
    CUDA card)."""
    return _sync is not None


def enable() -> None:
    """Turn the recorder on (a no-op if it is on)."""
    global _on, _record_function, _sync, _prev_show
    with _lock:
        if _on:
            return
        import torch
        _record_function = torch.profiler.record_function
        cuda = _sync_debug()
        if cuda is not None:
            prev = cuda.get_sync_debug_mode()
            with warnings.catch_warnings():
                # the mode's own notice that it is a prototype
                warnings.simplefilter("ignore")
                cuda.set_sync_debug_mode("warn")
            warnings.filterwarnings("always", message=".*" + _SYNC_TEXT)
            _sync = {"cuda": cuda, "mode": prev,
                     "filter": warnings.filters[0]}
            _prev_show = warnings.showwarning
            warnings.showwarning = _show_warning
        _on = True


def disable() -> None:
    """Turn the recorder off and restore the sync debug mode it found; the
    records made stay until :func:`drain`."""
    global _on, _sync
    with _lock:
        if not _on:
            return
        _on = False
        if _sync is not None:
            _sync["cuda"].set_sync_debug_mode(_sync["mode"])
            if warnings.showwarning is _show_warning:
                warnings.showwarning = _prev_show
            with contextlib.suppress(ValueError):
                warnings.filters.remove(_sync["filter"])
            getattr(warnings, "_filters_mutated", lambda: None)()
            _sync = None


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """The recorder on inside the block; as it was found after it."""
    was_on = _on
    enable()
    try:
        yield
    finally:
        if not was_on:
            disable()


def drain() -> Recording:
    """Hand out and forget every thread's finished spans and loose counts
    (the spans still open stay with their threads)."""
    out = Recording([], {})
    with _lock:
        for st in list(_threads):
            n = len(st.records)
            out.records.extend(st.records[:n])
            del st.records[:n]
            loose, st.loose = st.loose, {}
            for k, v in loose.items():
                out.loose[k] = out.loose.get(k, 0) + v
            if not st.thread.is_alive() and not st.stack:
                _threads.remove(st)
    out.records.sort(key=lambda r: r.t0)
    return out


def descendants(records: List[Record]) -> Dict[int, List[Record]]:
    """Each record's id -> its child records."""
    kids: Dict[int, List[Record]] = {}
    for r in records:
        if r.parent is not None:
            kids.setdefault(r.parent, []).append(r)
    return kids


def self_seconds(record: Record, children: List[Record]) -> float:
    """``record``'s duration less the part of it that ``children`` cover
    (the union of their intervals, clipped to the record's)."""
    covered, end = 0.0, record.t0
    for c in sorted(children, key=lambda c: c.t0):
        s, e = max(c.t0, end), min(c.t1, record.t1)
        if e > s:
            covered += e - s
            end = e
    return record.seconds - covered


def inclusive_counts(record: Record, kids: Dict[int, List[Record]]
                     ) -> Dict[str, int]:
    """``record``'s counts with those of every span below it."""
    out = dict(record.counts)
    for c in kids.get(record.id, ()):
        for k, n in inclusive_counts(c, kids).items():
            out[k] = out.get(k, 0) + n
    return out


def summary(records: List[Record]) -> Dict[str, Dict[str, Any]]:
    """Per span name: ``count``, ``total_s``, ``self_s`` and ``counts``
    (each counter over the name's spans and every span below them)."""
    kids = descendants(records)
    out: Dict[str, Dict[str, Any]] = {}
    for r in records:
        s = out.setdefault(r.name, {"count": 0, "total_s": 0.0,
                                    "self_s": 0.0, "counts": {}})
        s["count"] += 1
        s["total_s"] += r.seconds
        s["self_s"] += self_seconds(r, kids.get(r.id, []))
        for k, n in inclusive_counts(r, kids).items():
            s["counts"][k] = s["counts"].get(k, 0) + n
    return out
