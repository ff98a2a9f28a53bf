"""Unsigned-coordinate helpers: positions/counts as uint32 bit patterns.

Device coordinate space is 32-bit. Arrays keep their int32 dtype (one
integer word for queues, scatters and sorts), but absolute positions and absolute character counts are
interpreted as *unsigned* bit patterns, which carries one run to
n < 2^32 - 2^26 (the reference is uint64 end-to-end, include.hpp:25; a
~3 GB BWT — BASELINE config 5 — needs n ~ 3e9 > 2^31, the old cap).

Why bit patterns work (pinned by tests/test_coords.py):
* additions/subtractions/multiplications wrap mod 2^32 — two's complement
  patterns match unsigned arithmetic exactly;
* block/word/bit derivations use ``lax.shift_right_logical`` and masks,
  which act on the pattern;
* XLA converts between s32/u32 by reinterpretation (modular), so
  ``astype(jnp.uint32)`` is a free bitcast;
* scatters/gathers with mode="drop" drop indices past the END but WRAP
  negative ones Python-style — a negative (= would-be huge unsigned)
  index must be zero-masked, logically shifted to a positive block/word
  coordinate, or sign-flipped into a second array half first (see
  traverse._dif_scatter's (lo, hi) split for > 2^31-entry vectors).

What does NOT work on raw patterns — and what these helpers are for:
ordered comparisons, sorts, min/max scans. Compare/sort/scan the uint32
view instead.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def pat32(x: int) -> int:
    """Python int -> the int32 two's-complement pattern of x mod 2^32
    (jnp.int32(pat32(n)) never overflows; the device sees the unsigned
    value n)."""
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x >= (1 << 31) else x


def unpat(x) -> int:
    """Host int32/int scalar -> the unsigned Python int it encodes."""
    return int(np.uint64(np.int64(int(x)) & np.int64(0xFFFFFFFF)))


def asu32(x):
    """Reinterpret an int32 array (or Python int scalar) as uint32
    (modular convert)."""
    return jnp.asarray(x).astype(jnp.uint32)


def ult(a, b):
    """Unsigned a < b on int32 bit patterns."""
    return asu32(a) < asu32(b)


def ule(a, b):
    return asu32(a) <= asu32(b)


def ugt(a, b):
    return asu32(a) > asu32(b)


def uge(a, b):
    return asu32(a) >= asu32(b)


def umin(a, b):
    """Unsigned elementwise min on int32 patterns, returned as int32."""
    return jnp.minimum(asu32(a), asu32(b)).astype(jnp.int32)


def umax(a, b):
    """Unsigned elementwise max on int32 patterns, returned as int32."""
    return jnp.maximum(asu32(a), asu32(b)).astype(jnp.int32)


def ucummin_rev(x):
    """Unsigned reverse cumulative min on int32 patterns (int32 out)."""
    return jax.lax.cummin(asu32(x), reverse=True).astype(jnp.int32)


def usort(x):
    """Unsigned ascending sort of int32 patterns (int32 out)."""
    return jax.lax.sort(asu32(x), is_stable=False).astype(jnp.int32)


def udiv(a, d: int):
    """Unsigned a // d on int32 patterns (d a positive Python int < 2^31).

    Needed wherever a position past 2^31 picks an owner shard
    (parallel/frontier.py's merged-position routing): signed division on
    the negative pattern would route to shard 0."""
    return (asu32(a) // jnp.uint32(d)).astype(jnp.int32)


def uclip(x, lo, hi):
    """Unsigned clamp of int32 patterns to [lo, hi] (int32 arrays or
    scalars; int32 out)."""
    return jnp.clip(asu32(x), asu32(jnp.asarray(lo, jnp.int32)),
                    asu32(jnp.asarray(hi, jnp.int32))).astype(jnp.int32)
