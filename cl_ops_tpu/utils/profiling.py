"""Tracing / profiling helpers.

Parity with the reference's event-profiling discipline (SURVEY.md §5): the
reference names every enqueued kernel event (`ccl_event_set_name`, e.g.
`clo_scan_blelloch.c:158,183,193`) and aggregates per-kernel durations with
`ccl_prof` (`clo_sort_bench.c:201-208`). The JAX analogs:

  * `named(name)` — `jax.named_scope` context so kernels show up labeled in
    XLA/jax.profiler traces (the event-naming discipline);
  * `trace(logdir)` — context manager around `jax.profiler` producing a
    TensorBoard-loadable trace (the ccl_prof aggregation analog);
  * `timed(fn)` — wall-clock helper with a device sync, for quick numbers
    without a full trace.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator

import jax


def named(name: str):
    """Label the enclosed ops in profiler traces (event-name parity)."""
    return jax.named_scope(name)


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """Capture a jax.profiler trace of the enclosed block."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def timed(label: str, results: dict | None = None) -> Iterator[None]:
    """Wall-clock the enclosed block (with a final device barrier)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        try:
            jax.effects_barrier()
        except Exception:
            pass
        dt = time.perf_counter() - t0
        if results is not None:
            results[label] = dt
        else:
            print(f"[{label}] {dt * 1e3:.2f} ms")
