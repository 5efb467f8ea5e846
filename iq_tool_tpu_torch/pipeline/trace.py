"""Spans: what the program's threads do, and when, kept in memory as the
program runs.

    with trace.span("engine.step", block, run):
        ...

A span always lands in the record, a ring of the newest ``CAPACITY``
spans (so a long run's memory stays flat), as a ``Span``: its name, the
``StreamEngine.run`` call's serial (``run``), the block's index
(``block``; None for what belongs to no block), the thread's name and
its start and end in ns.  ``run`` and ``block`` together name the block
whose spans they are.  When a torch.profiler is on, a span also opens a
``torch.profiler.record_function`` of its name; with none on it costs
two clock reads and a flag read, not the profiler range's ~13 us.

Start and end are on the profiler's host clock (kineto stamps its
events with the wall clock, ``time.time_ns``), taken as the monotonic
``perf_counter_ns`` plus one offset read when a run starts: durations
stay monotonic, and a reader can lay a thread's spans against a device
trace even where the profiler did not record that thread.

``record()`` gives the record to readers (the CLI's end summary, the
benchmark's readers).  ``observe`` lets a caller see each span of the
current thread open and close (``GraphedStep.capture`` builds its stage
map from the chain's spans with it).

The stage record: each kernel wrapper (``ops/kernels.py``) calls
``note`` with the CUDA symbol it launches (the name the profiler
prints, ``dc_kernel``, ``banded_kernel``, ...), which counts it under
the innermost ``stage_span`` open on its thread (the span the chain
opens for each of its ``chain.*`` stages), a dict increment an eager
launch; a plain span leaves the stage as it is.  ``launches()`` reads
the counts; ``GraphedStep.capture`` keeps what its capture noted,
{stage: {symbol: launches}}, and publishes it (``stage_kernels()``, the
newest capture's).  A graph's replay runs no Python and notes nothing.

The stage map: ``GraphedStep.capture`` also publishes its map of the
graph's device nodes, [(stage, nodes)] in capture order, and the graph's
node count (``stage_map()``, the newest capture's).  A replay runs the
nodes of a one-stream capture in that order, so a reader of a device
trace can give each replay's k-th event to the map's k-th node, also
where two stages launch the same kernel, as torch's ops do.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time

import torch
import torch.autograd.profiler as _profiler

CAPACITY = 65536

Span = collections.namedtuple("Span", "name run block thread start_ns end_ns")

_record: collections.deque = collections.deque(maxlen=CAPACITY)
_serials = itertools.count(1)
_run = 0
_offset_ns = time.time_ns() - time.perf_counter_ns()


_launches: dict = {}        # (stage, symbol) -> launches noted
_launches_lock = threading.Lock()
_captured: dict | None = None       # the newest capture's stage kernels
_map: tuple | None = None           # the newest capture's (stage map, graph nodes)


class _Local(threading.local):
    hook = None             # observe's hook on this thread
    stage = None            # the innermost stage span open on this thread


_local = _Local()


def new_run() -> int:
    """A new run's serial (it becomes the default ``run`` of a span), with
    the clock offset read again."""
    global _run, _offset_ns
    _offset_ns = time.time_ns() - time.perf_counter_ns()
    _run = next(_serials)
    return _run


def now_ns() -> int:
    """Now, on the record's clock."""
    return time.perf_counter_ns() + _offset_ns


def add(name: str, start_ns: int, end_ns: int, run: int, block: int | None,
        thread: str | None = None) -> None:
    """Record a span timed elsewhere: one that starts on one thread and
    ends on another has ``thread`` None."""
    _record.append((name, run, block, thread, start_ns, end_ns))


def record() -> list:
    """The record as ``Span``s, oldest first."""
    return [Span._make(s) for s in list(_record)]


def note(symbol: str) -> None:
    """Count a launch of the kernel ``symbol`` under the innermost stage
    span open on this thread (None outside every one)."""
    key = (_local.stage, symbol)
    with _launches_lock:
        _launches[key] = _launches.get(key, 0) + 1


def launches() -> dict:
    """{(stage, symbol): launches} noted so far."""
    with _launches_lock:
        return dict(_launches)


def stage_launches(before: dict, after: dict) -> dict:
    """{stage: {symbol: launches}} noted between two ``launches()``
    readings."""
    out: dict = {}
    for (stage, symbol), n in after.items():
        d = n - before.get((stage, symbol), 0)
        if d:
            out.setdefault(stage, {})[symbol] = d
    return out


def publish_stage_kernels(stage_kernels: dict) -> None:
    """Make ``stage_kernels`` the newest capture's (``GraphedStep.capture``)."""
    global _captured
    _captured = {stage: dict(k) for stage, k in stage_kernels.items()}


def stage_kernels() -> dict | None:
    """The newest graph capture's {stage: {symbol: launches}}: the kernels
    each ``chain.*`` stage of a replay launches; None before any capture."""
    return None if _captured is None else {st: dict(k) for st, k in _captured.items()}


def publish_stage_map(stages: list | None, nodes: int = 0) -> None:
    """Make ``stages`` ([(stage, device nodes)] in capture order) and the
    graph's ``nodes`` the newest capture's map (``GraphedStep.capture``);
    None where the capture's launches are not one stream's."""
    global _map
    _map = None if stages is None else ([(st, int(n)) for st, n in stages], int(nodes))


def stage_map() -> tuple | None:
    """The newest graph capture's stage map, ([(stage, device nodes)] in
    capture order, the graph's device nodes): a replay's k-th device
    event is the map's k-th node where the two counts agree.  None before
    any capture and after a sharded step's capture of several graphs."""
    return None if _map is None else (list(_map[0]), _map[1])


@contextlib.contextmanager
def observe(hook):
    """While open, ``hook(name, opening)`` runs as each span of this thread
    opens (True) and closes (False)."""
    before = _local.hook
    _local.hook = hook
    try:
        yield
    finally:
        _local.hook = before


class span:
    """A context manager: the span ``name`` of ``block`` in ``run`` (the
    current run's serial by default).  ``block`` may be set while it is
    open."""

    __slots__ = ("name", "block", "run", "_t0", "_range", "_hook")

    def __init__(self, name: str, block: int | None = None, run: int | None = None):
        self.name, self.block = name, block
        self.run = _run if run is None else run

    def __enter__(self):
        self._hook = _local.hook
        if self._hook is not None:
            self._hook(self.name, True)
        self._range = None
        if _profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        # read after the range's own stamp: no Python call lies between
        # the two, so no other thread takes the interpreter in between
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
        _record.append((self.name, self.run, self.block, threading.current_thread().name,
                        self._t0 + _offset_ns, t1 + _offset_ns))
        if self._hook is not None:
            self._hook(self.name, False)
        return False


class stage_span(span):
    """A span that is a stage of the chain's step (``chain.*``): the
    launches noted while it is the innermost stage open on its thread
    count under its name."""

    __slots__ = ("_outer",)

    def __enter__(self):
        self._outer, _local.stage = _local.stage, self.name
        return span.__enter__(self)

    def __exit__(self, *exc) -> bool:
        _local.stage = self._outer
        return span.__exit__(self, *exc)
