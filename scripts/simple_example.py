"""Minimal programmatic usage example — the working counterpart of the
reference's stale scripts/simple_example.py (it unpacks 4 of the 7 values
gibbs_sample_with_fg returns, scripts/simple_example.py:59-71 there).

Runs a single-baseline Gibbs chain on a seeded problem at the reference's
shapes (hydra_pspec_tpu/utils/synthetic.py) through the library API (no
CLI, no MPI/mesh) and prints summary statistics.

    JAX_PLATFORMS=cpu python scripts/simple_example.py
"""
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from hydra_pspec_tpu.models.gibbs import gibbs_sample_with_fg
from hydra_pspec_tpu.utils import synthetic

# --- one baseline: visibilities, flags, noise model, FG basis, prior -----
p = synthetic.make_problem(1, seed=7123689)
d = p.vis[0]
ntimes, nfreqs = d.shape
print(f"Ntimes={ntimes} Nfreqs={nfreqs}")
Ninv = np.diag(p.ninv)
S_initial = np.eye(nfreqs)
# bandpower prior: the +-3 bins around delay 0 restricted to [0.1, 2]
# (shape (2, Ndelays): [0] = upper bound, [1] = lower; 0 = unconstrained)
ps_prior = p.prior

# --- run the Gibbs sampler ----------------------------------------------
signal_cr, signal_S, signal_ps, fg_amps, chisq, ln_post, write_time = \
    gibbs_sample_with_fg(
        d, p.w, S_initial, p.fgmodes, Ninv, ps_prior,
        Niter=100, seed=7123689, verbose=False,
    )

print(f"signal_cr {signal_cr.shape}  signal_ps {signal_ps.shape}  "
      f"fg_amps {fg_amps.shape}")
print(f"chi^2 (post burn-in) = {chisq[30:].mean():.4f}  (want ~1)")
print(f"median recovered/true (EoR bins) = "
      f"{synthetic.recovery_ratio(signal_ps[30:], p.ps_true):.3f}"
      f"  (want ~1)")
