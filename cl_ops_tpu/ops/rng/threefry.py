"""Threefry-2x32 counter-based PRNG, implemented natively in jnp.

This is the framework's flagship generator, replacing the reference's
per-stream stateful generators (`src/cl_ops/rng/clo_rng.c:60-68`) with a
counter-based design: value = threefry(key, (stream, counter)). Counter-based
generation is the data-parallel choice — no state round trips through memory,
any (stream, draw) coordinate is computable independently, so generation
parallelizes perfectly over vector lanes and over device meshes.

Algorithm: Threefry-2x32 with 20 rounds, as specified in Salmon et al.,
"Parallel Random Numbers: As Easy as 1, 2, 3" (SC'11). Verified against the
Random123 known-answer tests. This is the same algorithm JAX's default PRNG
uses, implemented here standalone so it can also be inlined into Pallas
kernels (pure u32 add/xor/rotate — plain integer ops).
"""

from __future__ import annotations

import jax.numpy as jnp

# Rotation schedule for Threefry-2x32 (Salmon et al., Table 2).
_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA  # key-schedule parity constant


def _rotl32(x, r: int):
    return (x << r) | (x >> (32 - r))


def threefry2x32(key0, key1, x0, x1):
    """20-round Threefry-2x32 block cipher.

    All inputs/outputs are uint32 arrays (broadcastable). Returns (y0, y1).
    """
    k0 = jnp.asarray(key0, jnp.uint32)
    k1 = jnp.asarray(key1, jnp.uint32)
    x0 = jnp.asarray(x0, jnp.uint32)
    x1 = jnp.asarray(x1, jnp.uint32)
    k2 = k0 ^ k1 ^ jnp.uint32(_PARITY)

    x0 = x0 + k0
    x1 = x1 + k1

    # Key injection schedule: after every 4 rounds, inject (ka, kb + round/4).
    schedule = ((k1, k2), (k2, k0), (k0, k1), (k1, k2), (k2, k0))
    for block, (ka, kb) in enumerate(schedule):
        rots = _ROTATIONS[:4] if block % 2 == 0 else _ROTATIONS[4:]
        for r in rots:
            x0 = x0 + x1
            x1 = _rotl32(x1, r)
            x1 = x1 ^ x0
        x0 = x0 + ka
        x1 = x1 + kb + jnp.uint32(block + 1)
    return x0, x1


def key_from_seed(seed: int) -> tuple[int, int]:
    """Derive a (k0, k1) u32 key pair from a 64-bit integer seed."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return (seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF


def random_bits(seed: int, stream_ids, counters):
    """Draw one u32 per (stream, counter) coordinate.

    `stream_ids` and `counters` are broadcastable uint32 arrays. Each distinct
    (seed, stream, counter) triple yields an independent uniform u32 — the
    counter-based analog of the reference's `clo_rng_next(states, index)`
    (`src/cl_ops/rng/clo_rng_api.cl:33-40`).
    """
    k0, k1 = key_from_seed(seed)
    y0, _ = threefry2x32(jnp.uint32(k0), jnp.uint32(k1),
                         jnp.asarray(stream_ids, jnp.uint32),
                         jnp.asarray(counters, jnp.uint32))
    return y0


def random_bits_2x(seed: int, stream_ids, counters):
    """Like random_bits but returns both 32-bit output words (y0, y1)."""
    k0, k1 = key_from_seed(seed)
    return threefry2x32(jnp.uint32(k0), jnp.uint32(k1),
                        jnp.asarray(stream_ids, jnp.uint32),
                        jnp.asarray(counters, jnp.uint32))
