"""Profiling zones and frame marks (counterpart of
``zrenderer_tpu/profiling/ztracy.py``), over torch.profiler and NVTX.

The reference's API: ``zone``/``zone_n``/``zone_nc`` return a context with
``.end()`` and ``.elapsed()``; ``frame_mark`` marks a frame; ``trace``
captures a whole-program trace.  A zone is a
``torch.profiler.record_function`` span, which a running profiler
records on the host timeline, and, once the process has initialized
CUDA, an NVTX range as well.  A frame mark closes the previous frame's
span and opens the next one, so the zones of a frame nest inside it (the
Renderer marks a frame after its render zone has closed).  ``trace``
runs ``torch.profiler.profile`` (CPU activity, and CUDA activity when a
card is there) and writes a Chrome trace JSON under its folder.

Zones are off until ``enable()``, ``trace`` or ``ZRENDERER_TRACE=1`` (as
the reference reads it) turns them on; an off
zone calls no profiler function and a frame mark only counts.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

_enabled = os.environ.get("ZRENDERER_TRACE", "0") not in ("0", "", "false")
_frame_index = 0
_frame_span = None  # the open frame span between two marks


def enable(value: bool = True) -> None:
    global _enabled
    _enabled = value


def is_enabled() -> bool:
    return _enabled


def _nvtx() -> bool:
    """NVTX ranges only in a process that uses CUDA: a CPU-only torch has
    no NVTX functions."""
    return torch.cuda.is_initialized()


class _Span:
    """One record_function span, plus an NVTX range under CUDA."""

    __slots__ = ("_rf", "_nvtx")

    def __init__(self, name: str, args: str | None = None):
        self._rf = torch.profiler.record_function(name, args)
        self._rf.__enter__()
        self._nvtx = _nvtx()
        if self._nvtx:
            torch.cuda.nvtx.range_push(name)

    def close(self) -> None:
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        self._rf.__exit__(None, None, None)


class _Zone:
    """Zone context: ``with zone(...)`` or ``z = zone(...); z.end()``."""

    __slots__ = ("_span", "_t0", "name")

    def __init__(self, name: str, active: bool):
        self.name = name
        self._span = _Span(name) if active and _enabled else None
        self._t0 = time.perf_counter()

    def end(self) -> None:
        if self._span is not None:
            self._span.close()
            self._span = None

    def elapsed(self) -> float:
        """Seconds on the host clock since the zone opened."""
        return time.perf_counter() - self._t0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.end()
        return False


def zone(name: str = "zone", active: bool = True) -> _Zone:
    return _Zone(name, active)


def zone_n(name: str, active: bool = True) -> _Zone:
    return _Zone(name, active)


def zone_nc(name: str, color: int = 0, active: bool = True) -> _Zone:
    """``color`` is accepted for the API's sake: neither record_function
    nor torch's NVTX binding takes one."""
    return _Zone(name, active)


def _close_frame() -> None:
    global _frame_span
    if _frame_span is not None:
        _frame_span.close()
        _frame_span = None


def frame_mark(name: str | None = None) -> None:
    """Count a frame; while zones are on, close the previous frame's span
    and open the next one (named ``name`` or "frame", the frame's index as
    its argument)."""
    global _frame_index, _frame_span
    _frame_index += 1
    _close_frame()
    if _enabled:
        _frame_span = _Span(name or "frame", str(_frame_index))


def frame_index() -> int:
    return _frame_index


class Capture:
    """What ``trace`` captured: ``profile`` (the torch.profiler object)
    and, once the block has ended, ``path`` (the Chrome trace JSON)."""

    def __init__(self, profile):
        self.profile = profile
        self.path = None


@contextlib.contextmanager
def trace(log_dir: str):
    """``with ztracy.trace(log_dir) as capture:`` records the block under
    torch.profiler with zones on, then writes ``capture.path``, a Chrome
    trace JSON in ``log_dir`` (made if missing).  The last open frame span
    closes first; a CUDA process is synchronized before the profiler
    stops, so that every kernel of the block is in the trace."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    was = _enabled
    enable(True)
    capture = Capture(profile(activities=activities))
    try:
        with capture.profile:
            try:
                yield capture
            finally:
                _close_frame()
                if torch.cuda.is_initialized():
                    torch.cuda.synchronize()
    finally:
        enable(was)
    os.makedirs(log_dir, exist_ok=True)
    capture.path = os.path.join(
        log_dir, f"ztracy_{os.getpid()}_{_frame_index}.trace.json")
    capture.profile.export_chrome_trace(capture.path)
