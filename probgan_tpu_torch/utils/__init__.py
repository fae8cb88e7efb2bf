"""Shared utilities: profiler annotations."""
