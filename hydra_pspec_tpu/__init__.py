"""hydra_pspec_tpu — 21cm delay power spectrum inference in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of
HydraRadio/hydra-pspec (the reference): per-baseline Gibbs
sampling of the EoR delay power spectrum jointly with a linear foreground
model under RFI flagging, plus the LSSA / OQE / DPSS estimators.

Design (not a port):
  * The sampler state is the bandpower vector ``ps``; the frequency-frequency
    covariance, its square root and inverse are *analytic* transforms
    ``S = F^H diag(ps/n^2) F`` (reference recomputes them with
    ``scipy.linalg.sqrtm`` / ``np.linalg.pinv`` every iteration,
    hydra_pspec/pspec.py:359-372).
  * The Gaussian constrained realization is a single Hermitian
    positive-definite system factored once per iteration and solved for all
    ``Ntimes`` right-hand sides with one batched Cholesky + multi-RHS solve
    (reference: per-time preconditioned CG in a ``multiprocess.Pool``,
    pspec.py:228,287).
  * Baselines and chains are batch axes handled by ``vmap`` and sharded over
    a ``jax.sharding.Mesh`` (reference: MPI scatter, run-hydra-pspec.py:483).
  * RNG is counter-based ``jax.random`` keys folded over
    (chain, iteration) — no fork-seed arithmetic (pspec.py:186-197).
"""

from . import ops, models, parallel, utils

__version__ = "0.1.0"

# Convenience re-exports mirroring the reference's public API surface
# (hydra_pspec/__init__.py re-exports dpss, lssa, oqe, pspec, utils).
from .models import gibbs, gcr, lssa, oqe, dpss  # noqa: E402
from .models.gibbs import gibbs_sample_with_fg, gibbs_step_fgmodes  # noqa: E402
from .ops.invgamma import sample_S, inversion_sample_invgamma, sprior  # noqa: E402
from .ops.fourier import fourier_operator, naive_pspec  # noqa: E402
