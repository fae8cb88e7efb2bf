"""The KG trainer's data helpers, in numpy.

The port of ``probgan_tpu/native/__init__.py`` without its C extension: both
functions are the JAX package's numpy fallbacks (the path it takes under
``PROBGAN_NO_NATIVE=1``), value for value. The C loader
(``native/triplet_loader.c``) is not ported: ``parse_triplets`` gives the same
array either way, and the C ``sample_negatives`` (xorshift128+) is another
stream than numpy's already in the JAX package. So this module's negatives
equal the JAX trainer's under ``PROBGAN_NO_NATIVE=1`` and differ from its C
path's, as the two JAX paths differ from each other.
"""

from __future__ import annotations

import numpy as np


def native_available() -> bool:
    """Whether the C triplet loader is in use: never in the port, which is
    the JAX package's ``PROBGAN_NO_NATIVE=1`` path."""
    return False


def parse_triplets(path: str) -> np.ndarray:
    """Parse a triplet text file ('h r t' per line, integer ids) into an
    int32 [n, 3] array. Raises ValueError on a token that is not an int."""
    return np.loadtxt(path, dtype=np.int32, ndmin=2).reshape(-1, 3)


def sample_negatives(n: int, num_entities: int, seed: int) -> np.ndarray:
    """n uniform entity ids in [0, num_entities), int32, from numpy's PCG64
    seeded with ``seed``: deterministic per seed."""
    return np.random.default_rng(seed).integers(0, num_entities, size=n, dtype=np.int32)
