"""Numerical-health guards (SURVEY.md §5.2).

The reference is single-threaded with no sanitizers; its closest bug
class (aliased Iteration copies) is structurally impossible here
(pure pytrees).  What replaces it on the device: NaN/Inf containment.  This
module wraps user function bundles so every evaluation is checked with
``jax.experimental.checkify`` — use during model development, drop for
production runs (checks cost a pass per evaluation).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
from jax.experimental import checkify

from ..core.driver import Functions


def _guard(fn: Callable, name: str) -> Callable:
    def wrapped(x):
        out = fn(x)
        checkify.check(jnp.all(jnp.isfinite(out)),
                       f"non-finite values from {name}(x)")
        return out

    return wrapped


def guarded_functions(fns: Functions) -> Functions:
    """Wrap a Functions bundle with finite-value checks.

    Run the solve under ``checkify.checkify`` to surface the first
    failing evaluation:

    >>> gfns = guarded_functions(fns)
    >>> err, res = checkify.checkify(
    ...     lambda x0: run_chunk(init_carry(gfns, x0, dims, opts, dtype),
    ...                          gfns, dims, opts, tols, chunk))(x0)
    >>> err.throw()   # raises with the failing function's name
    """
    return Functions(res=_guard(fns.res, "residuals"),
                     jac_res=_guard(fns.jac_res, "jac_residuals"),
                     cons=_guard(fns.cons, "constraints"),
                     jac_cons=_guard(fns.jac_cons, "jac_constraints"))


def first_nonfinite_report(model) -> str | None:
    """Host-side sanity check of a solved model: returns a description
    of any non-finite piece of the solution state, else None."""
    import numpy as np
    s = np.asarray(model.sol)
    if not np.all(np.isfinite(s)):
        return f"solution contains non-finite entries at {np.where(~np.isfinite(s))[0]}"
    if not np.isfinite(model.obj_value):
        return "objective value is non-finite"
    return None
