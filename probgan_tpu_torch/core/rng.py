"""Explicit RNG policy over ``torch.Generator``.

Same per-task counter semantics as the JAX package's ``RngStream``: the i-th
draw for task "t" comes from a generator seeded by (seed, crc32(t), i), so it
is the same no matter which other tasks drew before it. The bits differ from
``jax.random``'s (threefry): a test that compares the two packages makes its
inputs with numpy and hands the same arrays to both.

RNG decision: the port does not reproduce threefry bits. The reference's
noise-dependent goldens (``predict_tails.json`` and the generator half of
``score_triplets.json``) are therefore met only when a test feeds the port
the JAX package's noise as a numpy array. With its own stream the port is
deterministic per (seed, task, draw index) and independent of the order in
which tasks are called, and differs from those goldens by the noise only.
"""

from __future__ import annotations

import hashlib
import zlib

import torch


def keyed_generator(seed: int, key: int) -> torch.Generator:
    """A fresh CPU generator for draw ``key`` of ``seed``: the trainers' form
    of the JAX package's ``fold_in(key(seed), key)``, with other bits."""
    digest = hashlib.blake2b(f"{int(seed)}:fold:{int(key)}".encode(), digest_size=8).digest()
    gen = torch.Generator()
    gen.manual_seed(int.from_bytes(digest, "little") & 0x7FFFFFFFFFFFFFFF)
    return gen


class RngStream:
    """A task-keyed counter stream: ``generator(task, i)`` is seeded from a
    hash of (seed, crc32(task), i)."""

    def __init__(self, seed: int = 0):
        self._seed = int(seed)
        self._counters: dict[str, int] = {}

    def next_generator(self, task: str = "") -> torch.Generator:
        """A fresh CPU generator for the next draw of ``task`` (draw on the
        CPU, then move: the bits do not depend on the target device)."""
        i = self._counters.get(task, 0)
        self._counters[task] = i + 1
        tag = zlib.crc32(task.encode()) & 0x7FFFFFFF if task else 0
        digest = hashlib.blake2b(
            f"{self._seed}:{tag}:{i}".encode(), digest_size=8
        ).digest()
        gen = torch.Generator()
        gen.manual_seed(int.from_bytes(digest, "little") & 0x7FFFFFFFFFFFFFFF)
        return gen

    def normal(self, task: str, shape) -> torch.Tensor:
        """The next standard-normal fp32 draw of ``task``, on the CPU."""
        return torch.randn(tuple(shape), generator=self.next_generator(task))

    def counter(self, task: str = "") -> int:
        return self._counters.get(task, 0)
