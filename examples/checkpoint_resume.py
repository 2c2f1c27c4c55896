"""Checkpoint / resume: save a mid-solve carry, reload, continue.

The solver state is ONE fixed-shape pytree (core.types.Carry), so
checkpointing — even of a mesh-sharded million-lane batch — is a flat
save of its leaves (utils/checkpoint.py; the reference has no
checkpointing, SURVEY §5.4).  Continuation is bit-identical: the loop
body only reads the carry.

Run: python examples/checkpoint_resume.py
"""

import os
import sys
import tempfile
from functools import partial

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import jax
import jax.numpy as jnp
import numpy as np

from enlsip_tpu.utils import enable_compile_cache  # noqa: E402

enable_compile_cache()

import enlsip_tpu as et
from enlsip_tpu.core.driver import Functions, init_carry, iterate_body
from enlsip_tpu.core.types import Dims, Options, Tols
from enlsip_tpu.models.model import build_constraint_functions
from enlsip_tpu.utils import load_carry, save_carry


def main():
    model = et.CnlsModel(
        residuals=lambda x: jnp.array(
            [x[0] - x[1], (x[0] + x[1] - 10.0) / 3.0, x[2] - 5.0]),
        nb_parameters=3, nb_residuals=3,
        starting_point=np.array([-5.0, 5.0, 0.0]),
        ineq_constraints=lambda x: jnp.array(
            [48.0 - x[0] ** 2 - x[1] ** 2 - x[2] ** 2]),
        nb_ineqcons=1,
        x_low=np.array([-4.5, -4.5, -5.0]),
        x_upp=np.array([4.5, 4.5, 5.0]))
    cons, jac_cons = build_constraint_functions(model)
    fns = Functions(res=model.residuals,
                    jac_res=jax.jacfwd(model.residuals),
                    cons=cons, jac_cons=jac_cons)
    dims = Dims(n=3, m=3, q=0, l=7)
    dtype = jnp.float32
    rel = float(np.sqrt(jnp.finfo(dtype).eps))
    tols = Tols(*(jnp.asarray(v, dtype)
                  for v in (1e-10, rel, rel, rel, rel)))
    step = jax.jit(partial(iterate_body, fns=fns, dims=dims,
                           opts=Options(), tols=tols))

    carry = init_carry(fns, jnp.asarray(model.starting_point, dtype),
                       dims, Options(), dtype)
    for _ in range(3):
        carry = step(carry)
    print(f"after 3 iterations: x = {np.asarray(carry.x)}")

    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "state.npz")
        save_carry(path, carry)
        print(f"checkpointed to {path} "
              f"({os.path.getsize(path) / 1024:.1f} KiB)")
        resumed = load_carry(path, like=carry)

    while int(resumed.exit_code) == 0:
        resumed = step(resumed)
    print(f"resumed -> exit {int(resumed.exit_code)}, "
          f"x = {np.asarray(resumed.x)}, "
          f"f = {float(jnp.dot(resumed.rx, resumed.rx)):.7f}")
    assert int(resumed.exit_code) > 0
    assert abs(float(jnp.dot(resumed.rx, resumed.rx)) - 0.9535289) < 1e-4


if __name__ == "__main__":
    main()
