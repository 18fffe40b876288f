"""Spans and build counters: where a cube's time goes, on the host's clock
and, on a CUDA device, on the card's.

:func:`span` marks one step. It always enters
``torch.profiler.record_function(name)``, so a profiler shows the step as
a user annotation (on the card also as a ``gpu_user_annotation`` over its
kernels), on the device trace's own clock. Inside an open :func:`cube`
the span is also recorded: its id, its parent's, its host start and end
in seconds from the cube's start, its attributes and, on a CUDA device
inside a lap (:meth:`Recorder.lap`), a pair of timing events on the
current stream. The events are read only after the lap's own device
synchronisation: the recorder adds no synchronisation, ``.item()`` or
``.cpu()`` of its own. Off the card, and outside the laps, a span's
device seconds are None.

:func:`build_span` marks a step that builds something once per process (a
kernel library, a process group's connection, a transform's plan). Its
host seconds also go to the process-wide :data:`BUILDS`, open cube or
not, so a build span inside a measured cube means something was built
again.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import threading
import time

import torch
from torch.profiler import record_function


class BuildRegistry:
    """The process's build spans by name: ``count``, the builds (one
    nested in a build of the same name counts with it), and ``host_s``,
    their host seconds less those of the builds nested in them, so that
    the names' seconds add up to the process's time spent building."""

    def __init__(self):
        self._lock = threading.Lock()
        self._builds: dict = {}

    def add(self, name: str, host_s: float, counted: bool) -> None:
        with self._lock:
            entry = self._builds.setdefault(name, {"count": 0, "host_s": 0.0})
            entry["count"] += int(counted)
            entry["host_s"] += host_s

    def snapshot(self) -> dict:
        """``{name: {"count", "host_s"}}``, a copy."""
        with self._lock:
            return {k: dict(v) for k, v in self._builds.items()}


BUILDS = BuildRegistry()


class _Build:
    """An open build span: its name, the build it is nested in, and the
    host seconds of the builds nested in it."""

    __slots__ = ("name", "parent", "child_s")

    def __init__(self, name, parent):
        self.name, self.parent, self.child_s = name, parent, 0.0

    def inside(self, name: str) -> bool:
        b = self.parent
        while b is not None:
            if b.name == name:
                return True
            b = b.parent
        return False


_CUBE: contextvars.ContextVar = contextvars.ContextVar("p3d_cube",
                                                       default=None)
_BUILD: contextvars.ContextVar = contextvars.ContextVar("p3d_build",
                                                        default=None)


class Recorder:
    """The spans of one cube on ``device`` (see :func:`cube`)."""

    def __init__(self, timings: dict, device):
        self.timings = timings
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.t0 = time.perf_counter()
        self.spans: list = []
        self._open: list = []  # ids of the open spans, innermost last
        self._pending: list = []  # (row, start event, end event)
        self._laps = 0  # laps open

    def _now(self) -> float:
        return time.perf_counter() - self.t0

    @contextlib.contextmanager
    def _record(self, name: str, attrs: dict, build: bool, closing=None):
        row = {"id": len(self.spans),
               "parent": self._open[-1] if self._open else None,
               "name": name, "build": build, "host_start_s": self._now(),
               "host_end_s": None, "device_s": None, "attrs": attrs}
        self.spans.append(row)
        self._open.append(row["id"])
        events = None
        if self.cuda and self._laps:
            stream = torch.cuda.current_stream(self.device)
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record(stream)
        try:
            yield row
        finally:
            if events is not None:
                events[1].record(stream)
                self._pending.append((row, *events))
            if closing is not None:
                closing()
            row["host_end_s"] = self._now()
            self._open.pop()

    def _sync(self) -> None:
        """The lap's device synchronisation; then every event recorded
        before it is complete and is read."""
        if not self.cuda:
            return
        torch.cuda.synchronize(self.device)
        for row, start, end in self._pending:
            row["device_s"] = start.elapsed_time(end) / 1e3
        self._pending.clear()

    @contextlib.contextmanager
    def lap(self, name: str, key: str):
        """The span ``name`` over one lap of ``timings``: on exit the
        device is synchronised (the lap's own synchronisation, which
        reads the events recorded so far) and ``timings[key]`` gets the
        span's host seconds. Laps follow each other, so each times the
        work issued since the last one ended."""
        with record_function(name):
            self._laps += 1
            try:
                with self._record(name, {}, False, closing=self._sync) as row:
                    yield
            finally:
                self._laps -= 1
            self.timings[key] = row["host_end_s"] - row["host_start_s"]


class _NoRecorder:
    """:class:`Recorder`'s laps where no ``timings`` were asked for: the
    profiler's ranges alone, no synchronisation."""

    @staticmethod
    def lap(name: str, key: str):
        return record_function(name)


@contextlib.contextmanager
def cube(timings: dict | None, device):
    """Open the current cube on ``device`` for the block: the spans inside
    it, from any module, are recorded. On a normal exit ``timings`` gains
    ``spans`` (a list of plain dicts: ``id``, ``parent``, ``name``,
    ``build``, ``host_start_s``, ``host_end_s``, ``device_s``, ``attrs``)
    and ``process`` (:data:`BUILDS`' snapshot). With ``timings`` None
    nothing is recorded and the laps do not synchronise; the block gets
    an object whose ``lap`` is a profiler range."""
    if timings is None:
        yield _NoRecorder
        return
    rec = Recorder(timings, device)
    token = _CUBE.set(rec)
    try:
        yield rec
    finally:
        _CUBE.reset(token)
    timings["spans"] = rec.spans
    timings["process"] = BUILDS.snapshot()


@contextlib.contextmanager
def _range(name: str, attrs: dict, build: bool):
    rec = _CUBE.get()
    with record_function(name):
        if rec is None:
            yield
        else:
            with rec._record(name, attrs, build):
                yield


def span(name: str, **attrs):
    """One step named ``name``: a profiler range, and a span of the open
    cube, if any, with ``attrs`` (plain numbers, strings and lists)."""
    return _range(name, attrs, False)


@contextlib.contextmanager
def build_span(name: str, **attrs):
    """A build step: :func:`span`, and its host seconds in
    :data:`BUILDS`."""
    parent = _BUILD.get()
    b = _Build(name, parent)
    token = _BUILD.set(b)
    t0 = time.perf_counter()
    try:
        with _range(name, attrs, True):
            yield
    finally:
        _BUILD.reset(token)
        host_s = time.perf_counter() - t0
        if parent is not None:
            parent.child_s += host_s
        BUILDS.add(name, host_s - b.child_s, not b.inside(name))


def builds(name: str):
    """Decorator: each call of the function is the build span ``name``
    with ``what`` the function's name (under a cache: each miss)."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with build_span(name, what=fn.__name__):
                return fn(*args, **kwargs)
        return wrapper
    return deco
