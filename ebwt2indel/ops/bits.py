"""Device-side bit packing for host transfers.

Flag vectors live as uint8 on device; downloading them raw costs 8x the
necessary bytes. Pack to bits on device, unpack
with numpy on host.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def device_packbits(arr) -> jnp.ndarray:
    """(n,) bool/uint8 -> (ceil(n/8),) uint8, little-endian bit order."""
    n = arr.shape[0]
    pad = (-n) % 8
    a = arr.astype(jnp.uint8)
    if pad:
        a = jnp.concatenate([a, jnp.zeros(pad, jnp.uint8)])
    weights = (jnp.uint8(1) << jnp.arange(8, dtype=jnp.uint8))[None, :]
    return (a.reshape(-1, 8) * weights).sum(axis=1, dtype=jnp.uint8)


def host_unpackbits(packed: np.ndarray, n: int) -> np.ndarray:
    """Inverse of device_packbits; returns (n,) uint8 in {0,1}."""
    return np.unpackbits(np.asarray(packed), bitorder="little")[:n]


# ---------------------------------------------------------------------------
# rank-ready packed bitvector (layout consumed by ops.rank.bv_rank1 / bv_get)
# ---------------------------------------------------------------------------


import jax as _jax


@_jax.jit
def bv_build(bits_u8) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Device 0/1 uint8 vector -> (words (nb*4,) uint32 FLAT, counts (nb,)
    int32) for ops.rank.bv_rank1 — the device-side rank structure over the
    document array (the reference scans its vector<bool> DA sequentially,
    ebwt2InDel.cpp:1431-1432).

    Everything here is deliberately 1-D: flat u32 arrays lay out densely
    on any backend, and word/block extraction uses strided slices, which
    XLA fuses."""
    n = bits_u8.shape[0]
    nb = -(-n // 128)
    pad = nb * 128 - n
    a = bits_u8.astype(jnp.uint8)
    if pad:
        a = jnp.concatenate([a, jnp.zeros(pad, jnp.uint8)])
    words = jnp.zeros(nb * 4, jnp.uint32)
    for j in range(32):
        words = words + (a[j::32].astype(jnp.uint32) << jnp.uint32(j))
    pc = _jax.lax.population_count(words).astype(jnp.int32)
    per_block = pc[0::4] + pc[1::4] + pc[2::4] + pc[3::4]
    counts = jnp.cumsum(per_block) - per_block
    return words, counts


@_jax.jit
def bv_counts(words) -> jnp.ndarray:
    """Per-block cumulative rank counts for an existing (nb*4,) uint32
    word array in the bv_build layout (used when flags arrive already
    bit-packed — the huge-n TraversalResult.packed path)."""
    pc = _jax.lax.population_count(words).astype(jnp.int32)
    per_block = pc[0::4] + pc[1::4] + pc[2::4] + pc[3::4]
    return jnp.cumsum(per_block) - per_block
