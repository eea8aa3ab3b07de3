"""Spans for the serving and pull planes: the ``span`` / ``event`` /
``wrap`` surface of ``demodel_tpu.utils.trace``.

A span times one operation on the monotonic clock; spans nest through a
``contextvars`` ambient parent so :func:`event` lands on the innermost
open one. Each finished span observes its duration into
``stage_duration_seconds{span=<name>}`` and adds it to
``trace_span_seconds_total{span=<name>}`` (counted in
``trace_spans_total``), as the JAX plane does, so the ``/metrics``
scrape shows where serving and pull time goes (``serve.prefill``,
``window-read``, ``budget-wait``, ``place``) and the pull tuner reads
the budget-wait share of wall time as a rate.
"""

from __future__ import annotations

import contextvars
import time
from typing import Any, Callable

from demodel_tpu_torch.utils.metrics import HUB, labeled

_current: contextvars.ContextVar["Span | None"] = contextvars.ContextVar(
    "demodel_torch_span", default=None)


class Span:
    """One timed operation; use as ``with trace.span("name", k=v):``."""

    __slots__ = ("name", "attrs", "events", "dur", "_t0", "_token")

    def __init__(self, name: str, attrs: dict[str, Any]) -> None:
        self.name = name
        self.attrs = attrs
        self.events: list[tuple[float, str, dict[str, Any]]] = []
        self.dur: float | None = None
        self._t0 = time.perf_counter()
        self._token: contextvars.Token["Span | None"] | None = None

    def set_attr(self, key: str, value: Any) -> None:
        self.attrs[key] = value

    def event(self, name: str, **attrs: Any) -> None:
        """Timestamped point event, offset seconds from span start."""
        self.events.append(
            (round(time.perf_counter() - self._t0, 6), name, attrs))

    def __enter__(self) -> "Span":
        self._token = _current.set(self)
        return self

    def __exit__(self, exc_type: type[BaseException] | None,
                 exc: BaseException | None, tb: object) -> None:
        if self._token is not None:
            _current.reset(self._token)
            self._token = None
        self.dur = time.perf_counter() - self._t0
        HUB.observe(labeled("stage_duration_seconds", span=self.name),
                    self.dur)
        HUB.inc(labeled("trace_spans_total", span=self.name))
        HUB.inc(labeled("trace_span_seconds_total", span=self.name),
                self.dur)


class _NoopSpan:
    """A span that records nothing: the placeholder for an attribute
    that holds a span only while its owner runs."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc: object) -> None:
        return None

    def set_attr(self, key: str, value: Any) -> None:
        return None

    def event(self, name: str, **attrs: Any) -> None:
        return None


NOOP = _NoopSpan()


def span(name: str, **attrs: Any) -> Span:
    """Start a span under the ambient parent."""
    return Span(name, attrs)


def event(name: str, **attrs: Any) -> None:
    """Attach a point event to the ambient span (no-op without one)."""
    cur = _current.get()
    if cur is not None:
        cur.event(name, **attrs)


def wrap(fn: Callable[..., Any]) -> Callable[..., Any]:
    """``fn`` run in the ambient context captured now, for a call that
    will run on another thread (``contextvars`` does not cross
    ``threading``): spans opened there nest under the caller's. Wrap
    once per job — one context cannot be entered by two threads."""
    ctx = contextvars.copy_context()

    def run(*a: Any, **kw: Any) -> Any:
        return ctx.run(fn, *a, **kw)

    return run
