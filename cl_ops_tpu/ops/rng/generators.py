"""Per-stream stateful generators with reference parity.

Re-expresses the six generators of the reference registry
(`src/cl_ops/rng/clo_rng.c:60-68`: lcg, xorshift64, xorshift128, mwc64x,
parkmiller, tauslcg) as *vectorized functional steps*: where the reference
advances `states[index]` in place inside a kernel
(e.g. `src/cl_ops/rng/clo_rng_lcg.cl:43-59`), each generator here is a pure
function `step(states) -> (new_states, u32 draws)` over the whole stream
array at once — one fused elementwise pass under jit instead of
per-work-item scalar code. The integer recurrences are reproduced exactly, so per-stream output
sequences are bit-identical to the reference generators given equal states.

State layouts (per stream), mirroring each clo_statetype:
  lcg         u64 scalar    (clo_rng_lcg.cl:30)
  xorshift64  u64 scalar    (clo_rng_xorshift64.cl:28)
  xorshift128 u32[4]        (clo_rng_xorshift128.cl:30)
  mwc64x      u32[2]        (clo_rng_mwc64x.cl:28)
  parkmiller  i32 scalar    (clo_rng_parkmiller.cl:30)
  tauslcg     u32[4]        (clo_rng_tauslcg.cl:33)
  threefry    u32[2]        (stream id, draw counter) — counter-based, new

64-bit state generators require `jax.config.update("jax_enable_x64", True)`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from cl_ops_tpu.core.errors import BadDtypeError
from cl_ops_tpu.core.registry import Registry
from cl_ops_tpu.ops.rng import threefry as tf3


@dataclasses.dataclass(frozen=True)
class GeneratorDef:
    """One generator: state layout + seed conversion + step function.

    The analog of the reference's `CloRngInfo` registry entry
    (`src/cl_ops/rng/clo_rng.c:49-68`): {name, kernel source, seed size}.
    """

    name: str
    state_dtype: np.dtype
    state_words: int  # trailing state dim per stream; 0 => scalar state
    # seed_from_u64(seeds_u64[n]) -> states array of state_shape(n)
    seed_from_u64: Callable[[jnp.ndarray], jnp.ndarray]
    # step(states) -> (new_states, u32 draws[n])
    step: Callable[[jnp.ndarray], tuple[jnp.ndarray, jnp.ndarray]]
    # optional batch(states, draws) -> (new_states, u32[draws, n]); only
    # counter-based generators can produce all draws in one fused pass
    # (stateful recurrences are inherently sequential)
    batch: Callable | None = None

    def state_shape(self, n_streams: int) -> tuple[int, ...]:
        if self.state_words == 0:
            return (n_streams,)
        return (n_streams, self.state_words)

    @property
    def seed_bytes(self) -> int:
        """Per-stream state size in bytes (parity: clo_rng_get_size)."""
        return max(self.state_words, 1) * np.dtype(self.state_dtype).itemsize


generators: Registry[GeneratorDef] = Registry("rng generator")


def _require_x64():
    if not jnp.uint64 or jnp.asarray(0, jnp.uint64).dtype != np.uint64:
        raise BadDtypeError(
            "this generator needs 64-bit state; enable x64 via "
            "jax.config.update('jax_enable_x64', True)")


def _u32(x):
    return jnp.asarray(x, jnp.uint32)


# --- lcg: Knuth/Java 48-bit LCG (clo_rng_lcg.cl:43-59) ----------------------

def _lcg_step(states):
    s = (states * jnp.uint64(0x5DEECE66D) + jnp.uint64(0xB)) & jnp.uint64(
        (1 << 48) - 1)
    return s, (s >> jnp.uint64(16)).astype(jnp.uint32)


def _identity_u64_seed(seeds):
    _require_x64()
    return jnp.asarray(seeds, jnp.uint64)


generators.register("lcg")(lambda: GeneratorDef(
    "lcg", np.dtype(np.uint64), 0, _identity_u64_seed, _lcg_step))


# --- xorshift64 (clo_rng_xorshift64.cl:43-63) -------------------------------

def _xs64_step(states):
    s = states
    s = s ^ (s << jnp.uint64(21))
    s = s ^ (s >> jnp.uint64(35))
    s = s ^ (s << jnp.uint64(4))
    return s, s.astype(jnp.uint32)  # low 32 bits, like convert_uint


generators.register("xorshift64")(lambda: GeneratorDef(
    "xorshift64", np.dtype(np.uint64), 0, _identity_u64_seed, _xs64_step))


# --- xorshift128 (clo_rng_xorshift128.cl:42-59) -----------------------------

def _xs128_seed(seeds):
    s = jnp.asarray(seeds, jnp.uint64)
    # clo_ulong2statetype: (s, s>>16, s>>32, s>>46) each masked to 32 bits
    # (clo_rng_xorshift128.cl:32)
    parts = [s, s >> jnp.uint64(16), s >> jnp.uint64(32), s >> jnp.uint64(46)]
    return jnp.stack([p.astype(jnp.uint32) for p in parts], axis=-1)


def _xs128_step(states):
    x, y, z, w = (states[..., 0], states[..., 1], states[..., 2],
                  states[..., 3])
    t = x ^ (x << jnp.uint32(11))
    w_new = w ^ (w >> jnp.uint32(19)) ^ (t ^ (t >> jnp.uint32(8)))
    new = jnp.stack([y, z, w, w_new], axis=-1)
    return new, w_new


generators.register("xorshift128")(lambda: GeneratorDef(
    "xorshift128", np.dtype(np.uint32), 4, _xs128_seed, _xs128_step))


# --- mwc64x: Thomas' multiply-with-carry (clo_rng_mwc64x.cl:42-62) ----------

_MWC_A = 4294883355


def _mwc_seed(seeds):
    s = jnp.asarray(seeds, jnp.uint64)
    # as_uint2(ulong) on a little-endian device: x = low word, c = high word.
    return jnp.stack([s.astype(jnp.uint32),
                      (s >> jnp.uint64(32)).astype(jnp.uint32)], axis=-1)


def _mwc_step(states):
    x, c = states[..., 0], states[..., 1]
    res = x ^ c
    hi = ((x.astype(jnp.uint64) * jnp.uint64(_MWC_A)) >> jnp.uint64(32)
          ).astype(jnp.uint32)
    x_new = x * jnp.uint32(_MWC_A) + c  # wrapping u32 mul-add
    c_new = hi + (x_new < c).astype(jnp.uint32)
    return jnp.stack([x_new, c_new], axis=-1), res


generators.register("mwc64x")(lambda: GeneratorDef(
    "mwc64x", np.dtype(np.uint32), 2, _mwc_seed, _mwc_step))


# --- parkmiller: minimal standard (clo_rng_parkmiller.cl:43-59) -------------

def _pm_seed(seeds):
    s = jnp.asarray(seeds, jnp.uint64)
    return s.astype(jnp.uint32).astype(jnp.int32)  # as_int of low 32 bits


def _pm_step(states):
    s64 = states.astype(jnp.int64) * jnp.int64(16807)
    # lax.rem = C truncated modulo, matching OpenCL's % on negative states
    # (jnp's % is floored and diverges there).
    s = jax.lax.rem(s64, jnp.int64(2147483647)).astype(jnp.int32)
    # Return shifts a bit into the sign position (clo_rng_parkmiller.cl:57).
    return s, (s.astype(jnp.uint32) << jnp.uint32(1))


generators.register("parkmiller")(lambda: GeneratorDef(
    "parkmiller", np.dtype(np.int32), 0, _pm_seed, _pm_step))


# --- tauslcg: combined Tausworthe + LCG, GPU Gems 3 ch.37 with sub-stream
# skipping (clo_rng_tauslcg.cl:51-100) ---------------------------------------

def _taus_step(z, s1, s2, s3, m):
    b = ((z << jnp.uint32(s1)) ^ z) >> jnp.uint32(s2)
    return ((z & jnp.uint32(m)) << jnp.uint32(s3)) ^ b


def _tauslcg_seed(seeds):
    s = jnp.asarray(seeds, jnp.uint64)
    lo = s.astype(jnp.uint32)
    hi = (s >> jnp.uint64(32)).astype(jnp.uint32)
    # as_uint4((ulong2)(seed, seed)) little-endian -> (lo, hi, lo, hi)
    return jnp.stack([lo, hi, lo, hi], axis=-1)


def _tauslcg_step(states):
    x, y, z, w = (states[..., 0], states[..., 1], states[..., 2],
                  states[..., 3])
    nx = _taus_step(y, 13, 19, 12, 4294967294)
    ny = _taus_step(z, 2, 25, 4, 4294967288)
    nz = _taus_step(w, 3, 11, 17, 4294967294)
    nw = jnp.uint32(1664525) * x + jnp.uint32(1013904223)
    new = jnp.stack([nx, ny, nz, nw], axis=-1)
    return new, nx


generators.register("tauslcg")(lambda: GeneratorDef(
    "tauslcg", np.dtype(np.uint32), 4, _tauslcg_seed, _tauslcg_step))


# --- threefry: counter-based flagship (new; see threefry.py) ----------------

def _threefry_seed(seeds):
    s = jnp.asarray(seeds, jnp.uint64)
    # State = (stream word, counter). The stream word folds in the full seed.
    lo = s.astype(jnp.uint32)
    hi = (s >> jnp.uint64(32)).astype(jnp.uint32)
    return jnp.stack([lo ^ hi, jnp.zeros_like(lo)], axis=-1)


def _threefry_step(states):
    stream, counter = states[..., 0], states[..., 1]
    val = tf3.random_bits(0, stream, counter)
    new = jnp.stack([stream, counter + jnp.uint32(1)], axis=-1)
    return new, val


def _threefry_batch(states, draws: int):
    """All draws at once: counter-based = no sequential dependency.

    vals[d, s] = threefry(stream_s, counter_s + d) — one fused elementwise
    pass over the whole (draws, streams) grid, where stateful generators need a
    lax.scan of `draws` dependent steps.
    """
    stream, counter = states[..., 0], states[..., 1]
    d = jax.lax.broadcasted_iota(jnp.uint32, (draws, stream.shape[0]), 0)
    vals = tf3.random_bits(0, stream[None, :], counter[None, :] + d)
    new = jnp.stack([stream, counter + jnp.uint32(draws)], axis=-1)
    return new, vals


generators.register("threefry")(lambda: GeneratorDef(
    "threefry", np.dtype(np.uint32), 2, _threefry_seed, _threefry_step,
    batch=_threefry_batch))


def generator_names() -> list[str]:
    return generators.names()


def get_generator(name: str) -> GeneratorDef:
    return generators.get(name)()
