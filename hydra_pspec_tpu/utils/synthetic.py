"""Seeded problems drawn from the sampler's own model, at the reference's
shapes.

The reference's ``test_data`` (203 times x 120 channels, 12 foreground
modes, a 7-bin prior window [0.1, 2] around delay 0) is not shipped with
this repository, so benchmarks, smoke runs and tests draw their problem
here from a seed. Each baseline's visibilities are

    d_t = s_t + fgmodes @ a_t + n_t,

with an EoR signal whose centered delay transform ``F s_t`` has the known
bandpowers ``ps_true`` (the sampler's ``ps`` convention: ``E|F s_t|^2``),
bright foregrounds on the Legendre modes the CLI falls back to
(``cli.run.legendre_fgmodes``), and white noise of known inverse variance
``ninv``. Because the data follow the model, mean chi^2 after burn-in is 1
and the posterior bandpowers recover ``ps_true`` on EoR-dominated bins.
"""
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np

NTIMES, NFREQS, NMODES = 203, 120, 12
N_PRIOR_BINS = 3                   # half-width: 7 bins around delay 0
PRIOR_LO, PRIOR_HI = 0.1, 2.0
NOISE_SIGMA = 10.0                 # the CLI's fallback noise level
# RFI flags of the flagged validation case
FLAGGED_CHANNELS = (12, 30, 31, 32, 33, 77, 78, 79, 100)
EDGE_SNR = 10.0                    # ps_true / noise power at the band edge
FG_AMPLITUDE = 1e3                 # first mode, in units of NOISE_SIGMA


@dataclass(frozen=True)
class Problem:
    vis: np.ndarray          # (Nbl, Ntimes, Nfreqs) complex128, noisy
    signal: np.ndarray       # (Nbl, Ntimes, Nfreqs) EoR part of ``vis``
    noise: np.ndarray        # (Nbl, Ntimes, Nfreqs) noise part of ``vis``
    w: np.ndarray            # (Nfreqs,) 1 = keep
    fgmodes: np.ndarray      # (Nfreqs, Nmodes)
    ninv: np.ndarray         # (Nfreqs,) inverse noise variance
    ps_true: np.ndarray      # (Nfreqs,) true bandpowers
    prior: np.ndarray        # (2, Nfreqs) [upper, lower] bounds, 0 = free

    @property
    def flags(self) -> np.ndarray:
        """(Ntimes, Nfreqs) bool, True = flagged (the same every time)."""
        return np.broadcast_to(self.w == 0, self.vis.shape[1:])

    def jobs(self, out_root: Optional[Path] = None):
        """One :class:`runner.BaselineJob` per baseline, antpair (0, i+1),
        started from the identity covariance as the CLI does."""
        from ..runner import BaselineJob

        nfreqs = self.vis.shape[-1]
        return [
            BaselineJob(
                antpair=(0, i + 1), d=self.vis[i], w=self.w,
                fgmodes=self.fgmodes, S_initial=np.eye(nfreqs),
                Ninv=self.ninv,
                out_dir=None if out_root is None
                else Path(out_root) / f"0-{i + 1}",
            )
            for i in range(self.vis.shape[0])
        ]

    def write_uvh5(self, path) -> Path:
        """Write the visibilities (and flags) as a ``.uvh5`` file that the
        CLI reads with ``--Nfgmodes`` set to this problem's mode count and
        the prior flags below; its default noise matches ``ninv``."""
        from .uvh5 import write_uvh5

        nbl, _, nfreqs = self.vis.shape
        pairs = [(0, i + 1) for i in range(nbl)]
        write_uvh5(
            path, dict(zip(pairs, self.vis)),
            freqs_hz=1e8 + np.arange(nfreqs) * 1e5,
            flags_by_baseline=dict.fromkeys(pairs, np.array(self.flags)),
        )
        return Path(path)

    def cli_args(self):
        """CLI flags that describe this problem's model and prior."""
        return [
            "--Nfgmodes", str(self.fgmodes.shape[1]),
            "--n_ps_prior_bins", str(N_PRIOR_BINS),
            "--ps_prior_lo", str(PRIOR_LO), "--ps_prior_hi", str(PRIOR_HI),
        ]


def true_bandpowers(nfreqs: int, sigma: float = NOISE_SIGMA) -> np.ndarray:
    """A falling delay spectrum, ``EDGE_SNR`` times the per-bin noise power
    ``nfreqs * sigma**2`` at the band edge, inside the prior window's
    bounds on its bins."""
    k = np.arange(nfreqs) - nfreqs // 2
    k0 = nfreqs / 8.0
    shape = (1.0 + (nfreqs / 2 / k0) ** 2) / (1.0 + (k / k0) ** 2)
    ps = EDGE_SNR * nfreqs * sigma**2 * shape
    ps[np.abs(k) <= N_PRIOR_BINS] = 1.0
    return ps


def prior_window(nfreqs: int) -> np.ndarray:
    """The reference prior: bins within ``N_PRIOR_BINS`` of delay 0
    bounded to [PRIOR_LO, PRIOR_HI] (cli.run.build_prior's layout)."""
    prior = np.zeros((2, nfreqs))
    sl = slice(nfreqs // 2 - N_PRIOR_BINS, nfreqs // 2 + N_PRIOR_BINS + 1)
    prior[0, sl] = PRIOR_HI
    prior[1, sl] = PRIOR_LO
    return prior


def make_problem(nbaselines: int = 1, *, seed: int = 0,
                 ntimes: int = NTIMES, nfreqs: int = NFREQS,
                 nmodes: int = NMODES, flagged: bool = False) -> Problem:
    """Draw ``nbaselines`` independent baselines from the model. The
    same arguments give the same arrays."""
    from ..cli.run import legendre_fgmodes

    rng = np.random.default_rng(seed)

    def crandn(*shape):
        return (rng.standard_normal(shape)
                + 1j * rng.standard_normal(shape)) / np.sqrt(2)

    ps_true = true_bandpowers(nfreqs)
    fgmodes = legendre_fgmodes(nfreqs, nmodes)
    i = np.arange(nfreqs) - nfreqs // 2
    f_op = np.exp(-2j * np.pi * np.outer(i, i) / nfreqs)
    shape = (nbaselines, ntimes, nfreqs)
    # s_t = F^H sk_t / n with sk_t ~ CN(0, diag(ps_true))
    sk = crandn(*shape) * np.sqrt(ps_true)
    signal = sk @ f_op.conj() / nfreqs
    amp_scale = FG_AMPLITUDE * NOISE_SIGMA / (1.0 + np.arange(nmodes))
    fg = (crandn(nbaselines, ntimes, nmodes) * amp_scale) @ fgmodes.T
    noise = crandn(*shape) * NOISE_SIGMA
    w = np.ones(nfreqs)
    if flagged:
        w[[c for c in FLAGGED_CHANNELS if c < nfreqs]] = 0.0
    return Problem(
        vis=signal + fg + noise, signal=signal, noise=noise, w=w,
        fgmodes=fgmodes,
        ninv=np.full(nfreqs, NOISE_SIGMA**-2), ps_true=ps_true,
        prior=prior_window(nfreqs),
    )


def recovery_ratio(ps_samples: np.ndarray, ps_true: np.ndarray) -> float:
    """Median over the EoR-dominated delay bins (the outer two thirds of
    the band, away from the prior window and the foreground modes) of
    posterior-mean bandpower over ``ps_true``. ``ps_samples``:
    (..., Niter, Nfreqs) post-burn-in draws; leading axes (baselines) are
    averaged."""
    nfreqs = ps_true.shape[-1]
    post = np.asarray(ps_samples).reshape(-1, nfreqs).mean(axis=0)
    edge = np.r_[0:nfreqs // 3, nfreqs - nfreqs // 3:nfreqs]
    return float(np.median(post[edge] / ps_true[edge]))
