"""Exactness witnesses for the deferred (serving-form) operators.

The jit-traceable serving forms — `check="defer"` on the distributed
join/aggregate, `defer_overflow=True` on the single-chip join — trade the
per-call host sync of the planning forms for trailing WITNESS outputs:
per-chip `dropped` row counters and overflow flags. The result is exact iff
every witness is zero/False; ignoring them is the one remaining
silent-wrongness avenue. `verify_deferred` makes
checking them one call — blocking, so keep it OUT of the steady-state
serving loop: verify once per plan (after capacity planning, after a
data-distribution shift, or on a sampled cadence), not per request.
"""

from __future__ import annotations

import numpy as np

from cl_ops_tpu.core.errors import CloOpsError, ErrorCode


class DeferredOverflowError(CloOpsError):
    """A deferred serving-form result is NOT exact (witnesses fired)."""

    def __init__(self, message: str):
        super().__init__(message, ErrorCode.OUT_OF_RESOURCES)


def verify_deferred(*witnesses, op_name: str = "deferred op") -> None:
    """Assert that a serving-form result is exact (all witnesses clear).

    Args:
      *witnesses: any mix of the trailing outputs the deferred forms
        return — `dropped` row counters (int scalars/arrays, zero means
        no loss), overflow flags (bool scalars/arrays, False means no
        overflow), or tuples/lists of those (pass `out[-1]` directly).
      op_name: label for the error message.

    Raises:
      DeferredOverflowError naming the first witness that fired, with
      the dropped-row total / flag count — the caller should re-plan
      (check="replan" on representative data, or larger capacities) and
      re-serve.

    Blocks on device->host reads; see the module docstring for cadence.
    """
    flat: list = []

    def _flatten(w):
        if isinstance(w, (tuple, list)):
            for x in w:
                _flatten(x)
        else:
            flat.append(w)

    _flatten(witnesses)
    if not flat:
        raise ValueError("verify_deferred needs at least one witness")
    for i, w in enumerate(flat):
        a = np.asarray(w)
        if a.dtype == np.bool_:
            fired = int(a.sum())
            if fired:
                raise DeferredOverflowError(
                    f"{op_name}: overflow flag witness #{i} fired on "
                    f"{fired} entr{'y' if fired == 1 else 'ies'} — the "
                    "deferred result is not exact; re-plan capacities "
                    "(check='replan') and re-run")
        else:
            dropped = int(a.sum())
            if dropped:
                raise DeferredOverflowError(
                    f"{op_name}: dropped-row witness #{i} reports "
                    f"{dropped} dropped rows — the deferred result is "
                    "not exact; re-plan capacities (check='replan') "
                    "and re-run")
