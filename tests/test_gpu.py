"""On a GPU: the float32 real engine against the complex128 reference at
the reference's shapes, with each XLA solver. Skipped without a GPU; run
with ``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import reference_impl as ref
from hydra_pspec_tpu.models import rgibbs
from hydra_pspec_tpu.ops import cplx
from hydra_pspec_tpu.utils import synthetic

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("solver", ["chol", "recinv"])
@pytest.mark.parametrize("flagged", [False, True])
def test_gpu_solve_matches_reference(gpu, solver, flagged):
    p = synthetic.make_problem(2, seed=9, flagged=flagged)
    nbl, ntimes, nfreqs = p.vis.shape
    rng = np.random.default_rng(4)
    oa, ob = ((rng.standard_normal(p.vis.shape)
               + 1j * rng.standard_normal(p.vis.shape)) / np.sqrt(2)
              for _ in range(2))
    f_op = ref.fourier_operator(nfreqs)
    with jax.default_device(gpu):
        ops = rgibbs.stack_chain_operators([
            rgibbs.build_chain_operators(p.vis[i], p.w, p.fgmodes, p.ninv)
            for i in range(nbl)])
        ps = jnp.broadcast_to(jnp.asarray(p.ps_true, jnp.float32),
                              (nbl, nfreqs))
        sig, amps, _ = jax.jit(rgibbs.gcr_solve, static_argnames="solver")(
            ops, ps, cplx.from_numpy(oa @ f_op), cplx.from_numpy(ob),
            solver=solver)
        assert sig.re.devices() == {gpu}
    mats = ref.build_matrices(
        p.w, ref.covariance_from_pspec(p.ps_true / nfreqs**2, f_op),
        p.ninv, p.fgmodes)
    for i in range(nbl):
        want = ref.gcr_solve_direct(mats, p.fgmodes, p.vis[i] * p.w,
                                    oa[i], ob[i])
        for got, w in zip((cplx.to_numpy(sig)[i], cplx.to_numpy(amps)[i]),
                          want):
            assert np.linalg.norm(got - w) / np.linalg.norm(w) < 1e-3
