"""Mixed-problem scenario batches: many instances of MANY problem
families solved on one device/mesh.

The BASELINE "multi-host scenario batch" config mixes instances of
different HS problems.  Different families have different (n, m, q, l)
— under jit those are static — so the jit-friendly decomposition is
*bucketing*: lanes are grouped by family, each family's batch runs as
one vmapped (optionally mesh-sharded) solve, and families execute
back-to-back.  No shape padding, no trajectory perturbation: every
lane follows exactly the trajectory its single-instance solve would.

For the Hock–Schittkowski suite, :func:`hs_scenario_batch` builds the
per-family inputs directly from enlsip_tpu.problems.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.driver import Functions
from ..core.types import Dims, Options
from .batch import solve_batched
from .sharding import solve_batched_sharded


class FamilySpec(NamedTuple):
    fns: Functions
    dims: Dims
    x0_batch: jax.Array  # (B_f, n_f)
    fstar: float | None = None


def solve_suite_batched(families: dict, opts: Options, tols_fn,
                        mesh=None, dtype=jnp.float32) -> dict:
    """Solve every family's batch; returns {name: BatchResult}.

    ``tols_fn(dtype) -> Tols``;  ``mesh`` shards each family's batch
    axis when given."""
    out = {}
    for name, spec in families.items():
        tols = tols_fn(dtype)
        if mesh is not None:
            out[name] = solve_batched_sharded(
                spec.fns, spec.x0_batch, spec.dims, opts, tols, mesh=mesh,
                dtype=dtype)
        else:
            out[name] = solve_batched(spec.fns, spec.x0_batch, spec.dims,
                                      opts, tols, dtype=dtype)
    return out


def hs_scenario_batch(names, per_family: int, seed: int = 0,
                      scale: float = 0.1) -> dict:
    """Build FamilySpecs for HS problems: ``per_family`` perturbed
    starting points each."""
    import enlsip_tpu as et
    from ..models.model import build_constraint_functions, total_nb_constraints
    from ..problems import get_problem

    rng = np.random.default_rng(seed)
    families = {}
    for name in names:
        kw, fstar = get_problem(name)
        model = et.CnlsModel(**kw)
        cons, jac_cons = build_constraint_functions(model)
        fns = Functions(
            res=model.residuals,
            jac_res=model.jacobian_residuals or jax.jacfwd(model.residuals),
            cons=cons, jac_cons=jac_cons)
        dims = Dims(n=model.nb_parameters, m=model.nb_residuals,
                    q=model.nb_eqcons, l=total_nb_constraints(model))
        x0 = np.asarray(model.starting_point, dtype=float)
        starts = x0[None, :] + scale * (1.0 + np.abs(x0))[None, :] * \
            rng.normal(size=(per_family, dims.n))
        families[name] = FamilySpec(fns=fns, dims=dims,
                                    x0_batch=jnp.asarray(starts),
                                    fstar=fstar)
    return families
