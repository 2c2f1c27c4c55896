"""ENLSIP-JAX: a constrained nonlinear least-squares framework in JAX.

A from-scratch JAX/XLA implementation of the Lindström–Wedin ENLSIP
method (active-set Gauss–Newton with null-space QR subproblem solves,
subspace-minimization and Newton fallbacks, and a penalty-weighted
merit-function line search) with the capabilities of the Julia
reference UncertainLab/Enlsip.jl, re-designed for accelerators:
fixed-shape masked working sets inside a single jitted while-loop, AD
Jacobians and Hessians, vmap batching across instances, and mesh
sharding across devices.  The package keeps its historical import name
``enlsip_tpu``; it runs on the CPU and on NVIDIA GPUs.
"""

# Matmul precision note: accelerator matmuls may run f32 inputs in a
# reduced precision by default (TF32 on NVIDIA GPUs); the solver's
# factorization chains (CPQR panels, J@Q1, triangular solves) lose ~3
# decimal digits under that and drop HS-suite optimum matches at f32.
# Rather than mutating the PROCESS-global
# jax_default_matmul_precision at import time (which would silently
# change every other JAX computation in the user's process), every
# solve entry point scopes the precision to itself via
# Options.matmul_precision (default "float32"; see
# core.types.matmul_precision_scope).

from .core.driver import Functions, SolveResult, solve as core_solve
from .core.types import Dims, Options, Tols
from .models.model import (CnlsModel, ExecutionInfo,
                           bounds_constraints_values, constraints_values,
                           convert_exit_code, dict_status_codes,
                           equality_constraints_values,
                           inequality_constraints_values,
                           nb_equality_constraints, nb_inequality_constraints,
                           nb_lower_bounds, nb_upper_bounds, print_cnls_model,
                           solution, solve, status, sum_sq_residuals,
                           total_nb_constraints)

__version__ = "0.1.0"

__all__ = [
    "CnlsModel", "ExecutionInfo", "solve", "status", "solution",
    "sum_sq_residuals", "constraints_values", "equality_constraints_values",
    "inequality_constraints_values", "bounds_constraints_values",
    "total_nb_constraints", "nb_equality_constraints",
    "nb_inequality_constraints", "nb_lower_bounds", "nb_upper_bounds",
    "print_cnls_model", "dict_status_codes", "convert_exit_code",
    "Dims", "Options", "Tols", "Functions", "SolveResult", "core_solve",
    "__version__",
]
