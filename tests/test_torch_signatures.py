"""The port's public image functions take the JAX package's parameters: the
same names, in the same order, with the same defaults, so that a call written
for one package binds the same way in the other (a positional call too).

The differences the port keeps are listed in ``KEPT`` (ROADMAP.md §C lists
them as allowed); the test holds that the functions differ in exactly those.
Also ``native.native_available``, which the JAX package's tests call.
"""

import inspect

import jax
import jax.numpy as jnp
import pytest
import torch

from probgan_tpu import native as jnative
from probgan_tpu.engine import image as jimage
from probgan_tpu.engine import train as jtrain
from probgan_tpu.models import pro_gan as jpg
from probgan_tpu_torch import native as tnative
from probgan_tpu_torch.engine import image as timage
from probgan_tpu_torch.engine import train as ttrain
from probgan_tpu_torch.models import pro_gan as tpg

PAIRS = {
    "generator_features": (tpg.generator_features, jpg.generator_features),
    "generator_rgb": (tpg.generator_rgb, jpg.generator_rgb),
    "generator_apply": (tpg.generator_apply, jpg.generator_apply),
    "discriminator_apply": (tpg.discriminator_apply, jpg.discriminator_apply),
    "generate_fn": (timage.generate_fn, jimage.generate_fn),
    "score_fn": (timage.score_fn, jimage.score_fn),
    "latent_walk_fn": (timage.latent_walk_fn, jimage.latent_walk_fn),
    "ImageGANEngine.__init__": (timage.ImageGANEngine.__init__, jimage.ImageGANEngine.__init__),
    "progan_train_step": (ttrain.progan_train_step, jtrain.progan_train_step),
    "progan_train_step_accum": (ttrain.progan_train_step_accum,
                                jtrain.progan_train_step_accum),
}

# (function, parameter) -> (the port's default, the JAX package's default).
KEPT = {
    # packed=None resolves the gate from the input's device (packed_default)
    ("generate_fn", "packed"): (None, False),
    ("score_fn", "packed"): (None, False),
    ("latent_walk_fn", "packed"): (None, False),
}


def _default(value):
    """A default in terms both packages share: dtypes by name, precisions by
    their member name."""
    if value is jnp.float32 or value is torch.float32:
        return "float32"
    if value is jnp.bfloat16 or value is torch.bfloat16:
        return "bfloat16"
    if isinstance(value, (jax.lax.Precision, tpg.Precision)):
        return f"Precision.{value.name}"
    return value


def _params(fn):
    return inspect.signature(fn).parameters


@pytest.mark.parametrize("name", list(PAIRS))
def test_parameters_match_the_jax_package(name):
    port, ref = (_params(f) for f in PAIRS[name])
    assert list(port) == list(ref)
    for p in port:
        assert port[p].kind == ref[p].kind, p
        got, want = _default(port[p].default), _default(ref[p].default)
        assert (got, want) == KEPT.get((name, p), (want, want)), (p, got, want)


def test_kept_differences_are_exactly_the_listed_ones():
    seen = {}
    for name, (port, ref) in PAIRS.items():
        ps, rs = _params(port), _params(ref)
        for p in ps.keys() & rs.keys():
            got, want = _default(ps[p].default), _default(rs[p].default)
            if got != want:
                seen[(name, p)] = (got, want)
    assert seen == KEPT


def test_native_available_is_the_no_native_path():
    """The port has no C loader: its helpers are the JAX package's
    PROBGAN_NO_NATIVE=1 path, so ``native_available`` is False."""
    assert tnative.native_available() is False
    assert list(_params(tnative.native_available)) == list(_params(jnative.native_available))
