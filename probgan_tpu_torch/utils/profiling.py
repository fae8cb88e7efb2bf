"""Tracing hooks: every engine task runs inside a named
``torch.profiler.record_function`` range, which shows on the host and device
timelines of a ``torch.profiler.profile`` trace and costs nothing measurable
when no profiler is active. The CLI's ``--profile_dir`` wraps a whole task
in ``maybe_profile``, which writes a Chrome trace into that directory."""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def task_trace(name: str):
    """Annotate a task region on the profiler timeline."""
    with torch.profiler.record_function(f"probgan/{name}"):
        yield


@contextlib.contextmanager
def maybe_profile(profile_dir: str | None):
    """Capture a ``torch.profiler`` trace of the enclosed task into
    ``profile_dir`` (a Chrome trace, ``probgan_trace_<time>.json``) when set.

    The trace is optional: a profiler that cannot start, or a trace that
    cannot be written, prints a warning and the task completes without it."""
    if not profile_dir:
        yield
        return
    try:
        os.makedirs(profile_dir, exist_ok=True)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.__enter__()
    except Exception as e:  # noqa: BLE001 - profiling must never kill a task
        print(f"Warning: profiler unavailable ({e}); continuing without trace")
        yield
        return
    try:
        yield
    finally:
        try:
            prof.__exit__(None, None, None)
            path = os.path.join(profile_dir, f"probgan_trace_{time.time_ns()}.json")
            prof.export_chrome_trace(path)
            print(f"Profiler trace saved to: {path}")
        except Exception as e:  # noqa: BLE001
            print(f"Warning: profiler trace capture failed ({e})")
