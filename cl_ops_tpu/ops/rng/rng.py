"""RNG objects: seeding strategies, stream state, and the draw API.

JAX re-expression of the reference's CloRNG class
(`src/cl_ops/rng/clo_rng.c:262-446`). The reference object owns a device
seed/state buffer and *provides kernel source* that clients compile into their
own programs; here the Rng object owns a jnp state array and provides jitted
draw functions. The four seeding strategies map one-to-one
(`src/cl_ops/rng/clo_rng.in.h:78-92`):

  DEV_GID   — state[i] = ulong2state(hash(i + main_seed)), computed on device
              (ref: clo_rng_init kernel, clo_rng_init.cl:46-60)
  HOST_MT   — host Mersenne-Twister fills the raw state words
              (ref: GLib GRand fill, clo_rng.c:168-234; here numpy MT19937 —
              same strategy, different host MT seeding, so not bit-equal)
  EXT_DEV   — caller passes an existing device state array (validated)
  EXT_HOST  — caller passes a host array, copied to device

Draw API parity (`src/cl_ops/rng/clo_rng_api.cl:33-105`): `next_int(n)` is a
modulo-range draw; vector widths 2/4/8 stride the state array by the number of
work-items exactly like GID2/GID4/GID8 (`clo_rng_workitem.cl:24-32`), so a
state buffer of w*g streams serves g work-items drawing w values each.
"""

from __future__ import annotations

import enum
import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from cl_ops_tpu.core.errors import BadArgsError
from cl_ops_tpu.ops.rng.generators import GeneratorDef, get_generator
from cl_ops_tpu.ops.rng.hashes import apply_hash


class SeedType(enum.Enum):
    """Parity with CloRngSeedType (clo_rng.in.h:78-92)."""

    DEV_GID = "dev_gid"
    HOST_MT = "host_mt"
    EXT_DEV = "ext_dev"
    EXT_HOST = "ext_host"


class Rng:
    """A named generator plus its stream state array.

    Functional-core: `states` is an immutable jnp array; draw methods return
    (values, new_states) and `self.states` is rebound — the JAX-idiomatic
    version of the reference's in-place `states[index]` update.
    """

    def __init__(self, gen: GeneratorDef, states: jnp.ndarray):
        self._gen = gen
        self.states = states

    # -- introspection (parity: clo_rng_get_size / get_device_seeds) --------
    @property
    def name(self) -> str:
        return self._gen.name

    @property
    def num_streams(self) -> int:
        return int(self.states.shape[0])

    @property
    def seed_bytes(self) -> int:
        """Per-stream state size in bytes (clo_rng_get_size, clo_rng.c:456)."""
        return self._gen.seed_bytes

    def get_source(self):
        """The generator's step function — the clo_rng_get_source analog.

        The reference hands clients OpenCL C source to compile into their
        own programs (`clo_rng.c:431-446`); the JAX equivalent of
        "source you can embed" is the traced step callable: inline it into
        your own jitted function or Pallas kernel alongside `get_device_seeds`.
        """
        return self._gen.step

    def get_device_seeds(self):
        """The live state array (clo_rng_get_device_seeds parity)."""
        return self.states

    # -- draws ---------------------------------------------------------------
    def next_raw(self) -> jnp.ndarray:
        """Advance every stream once; return u32 draws, shape (num_streams,)."""
        new_states, vals = _jit_step(self._gen)(self.states)
        self.states = new_states
        return vals

    def next_int(self, n: int, width: int = 1) -> jnp.ndarray:
        """Draw integers in [0, n) (clo_rng_next_int{,2,4,8}).

        With width w, the num_streams = w*g states are viewed as w stripes of
        g streams (GID striding, clo_rng_workitem.cl:24-32); returns shape
        (w, g) — row k holds work-item draws from stripe k. width=1 returns
        shape (num_streams,).
        """
        if width not in (1, 2, 4, 8):
            raise BadArgsError(f"width must be 1/2/4/8, got {width}")
        if self.num_streams % width:
            raise BadArgsError(
                f"num_streams {self.num_streams} not divisible by width {width}")
        vals = self.next_raw() % jnp.uint32(n)
        if width == 1:
            return vals
        return vals.reshape(width, self.num_streams // width)

    def generate(self, draws_per_stream: int) -> jnp.ndarray:
        """Batch generation: (draws_per_stream, num_streams) u32 matrix.

        The analog of the reference bench's per-run kernel loop
        (`src/benchmarks/clo_rng_bench.c:302-324`), expressed as one
        lax.scan so states stay on-chip across iterations.
        """
        new_states, vals = _jit_generate(self._gen, draws_per_stream)(
            self.states)
        self.states = new_states
        return vals


@functools.cache
def _jit_step(gen: GeneratorDef):
    return jax.jit(gen.step)


@functools.cache
def _jit_generate(gen: GeneratorDef, draws: int):
    if gen.batch is not None:
        return jax.jit(functools.partial(gen.batch, draws=draws))

    def run(states):
        def body(s, _):
            new_s, v = gen.step(s)
            return new_s, v
        return jax.lax.scan(body, states, length=draws)
    return jax.jit(run)


def rng_new(
    name: str,
    seed_type: SeedType | str = SeedType.DEV_GID,
    num_streams: int = 0,
    main_seed: int = 0,
    hash_name: Optional[str] = None,
    ext_states=None,
) -> Rng:
    """Create an Rng — the analog of clo_rng_new (clo_rng.c:262-380).

    Args:
      name: generator name (lcg, xorshift64, xorshift128, mwc64x, parkmiller,
        tauslcg, threefry).
      seed_type: one of SeedType (or its string value).
      num_streams: number of independent streams (ref: seeds_count).
      main_seed: base seed (DEV_GID: added to stream id; HOST_MT: MT seed).
      hash_name: for DEV_GID — None (identity), "knuth", or "xs1"
        (clo_rng_init.cl:27-38 predefined hashes).
      ext_states: for EXT_DEV/EXT_HOST — caller-provided state array with
        shape gen.state_shape(num_streams) (validated like clo_rng.c:247-258).
    """
    gen = get_generator(name)
    if isinstance(seed_type, str):
        seed_type = SeedType(seed_type)

    if seed_type in (SeedType.EXT_DEV, SeedType.EXT_HOST):
        if ext_states is None:
            raise BadArgsError(f"{seed_type.value} seeding needs ext_states")
        want_shape = gen.state_shape(
            num_streams or int(np.shape(ext_states)[0]))
        got = jnp.asarray(ext_states, gen.state_dtype)
        if tuple(got.shape) != want_shape:
            raise BadArgsError(
                f"ext_states shape {tuple(got.shape)} != expected {want_shape}"
                f" for generator {name!r}")
        states = got if seed_type == SeedType.EXT_DEV else jax.device_put(got)
        return Rng(gen, states)

    if num_streams <= 0:
        raise BadArgsError("num_streams must be positive")

    if seed_type == SeedType.DEV_GID:
        # seed = gid + main_seed, hashed, then converted to state layout —
        # all on device (ref init kernel clo_rng_init.cl:46-60).
        gids = jnp.arange(num_streams, dtype=jnp.uint64)
        seeds = apply_hash(hash_name, gids + jnp.uint64(main_seed & (2**64 - 1)))
        states = jax.jit(gen.seed_from_u64)(seeds)
        return Rng(gen, states)

    # HOST_MT: fill the raw state words from a host Mersenne Twister.
    words = max(gen.state_words, 1)
    word_bytes = gen.state_dtype.itemsize
    mt = np.random.RandomState(np.uint32(main_seed & 0xFFFFFFFF))
    raw = mt.randint(0, 2**32, size=num_streams * words * word_bytes // 4,
                     dtype=np.uint32)
    host = raw.view(gen.state_dtype).reshape(gen.state_shape(num_streams))
    return Rng(gen, jax.device_put(jnp.asarray(host)))
