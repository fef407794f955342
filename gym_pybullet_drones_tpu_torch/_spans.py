"""The port's spans: named intervals of the host's wall clock,
``time.time_ns()``, the clock torch.profiler stamps the Chrome trace's
events with, so a span lines up with the device operations it launched.
A leaf module, so the kernels' launchers and builders and the package's own
import can record spans without importing ``runtime/``;
``runtime/profiling.py`` exports it. Two kinds:

* ``span(name)``, around work the port repeats (a kernel's launcher). It
  records only while a ``torch.profiler`` records in this thread, into a
  bounded ring that ``spans(start_ns, end_ns)`` reads, and opens a
  ``record_function`` annotation of the same name, so the span shows in the
  exported trace too. Otherwise it returns one shared object that does
  nothing: no annotation, no record, no object of its own.
* ``setup_span(name)``, around a phase a process runs once (an import, a
  kernel's build and load). Always on, kept for the whole process;
  ``setup_spans()`` reads them.

Neither synchronizes the device or launches work on it.
"""

import collections
import time

import torch

# Spans recorded while a profiler records; the oldest go first.
SPAN_RING = 1 << 16
_SPANS = collections.deque(maxlen=SPAN_RING)
_SETUP_SPANS = []
_recording = torch.autograd._profiler_enabled


class _Off:
    """The span of a thread no profiler records (``OFF``, shared): enters and
    leaves doing nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


OFF = _Off()


class _Span:
    """Stamps ``time.time_ns()`` on entry and on exit and appends
    ``(name, t0_ns, t1_ns)`` to ``sink``; an exception passes through."""

    __slots__ = ("name", "sink", "t0")

    def __init__(self, name, sink):
        self.name, self.sink = name, sink

    def __enter__(self):
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.sink.append((self.name, self.t0, time.time_ns()))
        return False


class _Annotated(_Span):
    """A ``_Span`` inside a ``record_function`` annotation of its name, whose
    own cost falls outside the stamps."""

    __slots__ = ("annotation",)

    def __enter__(self):
        self.annotation = torch.profiler.record_function(self.name)
        self.annotation.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        return self.annotation.__exit__(*exc)


def span(name: str):
    """A context manager around repeated work: records ``name`` while a
    ``torch.profiler`` records in this thread (``profiling.trace``, the
    benchmark's traced part), else the shared no-op ``OFF``."""
    return _Annotated(name, _SPANS) if _recording() else OFF


def setup_span(name: str):
    """A context manager around a set-up phase, recorded always."""
    return _Span(name, _SETUP_SPANS)


def spans(start_ns: int, end_ns: int):
    """The spans recorded that began and ended inside ``[start_ns, end_ns]``,
    as ``(name, t0_ns, t1_ns)``, oldest first."""
    return [s for s in list(_SPANS) if start_ns <= s[1] and s[2] <= end_ns]


def setup_spans():
    """Every set-up span of the process, ``(name, t0_ns, t1_ns)``, in the
    order they ended."""
    return list(_SETUP_SPANS)
