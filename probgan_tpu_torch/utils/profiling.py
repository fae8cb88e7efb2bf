"""Tracing hooks: every engine task runs inside a named
``torch.profiler.record_function`` range, which shows on the host and device
timelines of a ``torch.profiler.profile`` trace and costs nothing measurable
when no profiler is active."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def task_trace(name: str):
    """Annotate a task region on the profiler timeline."""
    with torch.profiler.record_function(f"probgan/{name}"):
        yield
