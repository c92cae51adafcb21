"""Real-pair estimator tier: on-device twins of LSSA/OQE/DPSS built on
ops/cplx (no complex dtypes anywhere in the traced program), pinned
against the complex x64 implementations at f64 precision and verified
complex-free by jaxpr inspection.

VERDICT r2 item 6: the reference estimators are CPU-only
(hydra_pspec/lssa.py:95, oqe.py:130, dpss.py:7); these run on the device.
"""
import jax
import jax.numpy as jnp
import numpy as np

from hydra_pspec_tpu.models import dpss, lssa, oqe
from hydra_pspec_tpu.ops import cplx
from hydra_pspec_tpu.ops.cplx import C

RNG = np.random.default_rng(5)


def crandn(*shape):
    return (RNG.standard_normal(shape)
            + 1j * RNG.standard_normal(shape)) / np.sqrt(2)


def cpair(z, dtype=jnp.float64):
    z = np.asarray(z)
    return C(jnp.asarray(z.real, dtype), jnp.asarray(z.imag, dtype))


def tonp(c: C):
    return np.asarray(c.re) + 1j * np.asarray(c.im)


def assert_complex_free(fn, *args):
    """The whole traced program must contain no complex avals — it runs
    in float32 real arithmetic only."""
    jaxpr = jax.make_jaxpr(fn)(*args)
    for eqn in jaxpr.jaxpr.eqns:
        for v in list(eqn.invars) + list(eqn.outvars):
            dt = getattr(getattr(v, "aval", None), "dtype", None)
            assert dt is None or not jnp.issubdtype(dt, jnp.complexfloating), (
                eqn.primitive, dt)


def hermitian(n, scale=1.0):
    a = crandn(n, n)
    m = a @ a.conj().T + scale * np.eye(n)
    return m


class TestLssaRP:
    def test_matches_complex_tier(self):
        n = 24
        d = crandn(n) * 3.0
        freqs = 100.0 + np.arange(n) * 0.1  # MHz
        invcov = np.linalg.inv(hermitian(n))
        taper = np.blackman(n)

        tau, a_re, a_im = lssa.lssa_fit_modes(
            jnp.asarray(d), jnp.asarray(freqs), jnp.asarray(invcov),
            fit_amp_phase=False, taper=jnp.asarray(taper))
        tau2, b_re, b_im = lssa.lssa_fit_modes_rp(
            cpair(d), freqs, cpair(invcov), fit_amp_phase=False,
            taper=jnp.asarray(taper, jnp.float64))
        np.testing.assert_allclose(np.asarray(tau2), np.asarray(tau),
                                   rtol=1e-12)
        np.testing.assert_allclose(np.asarray(b_re), np.asarray(a_re),
                                   rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(np.asarray(b_im), np.asarray(a_im),
                                   rtol=1e-9, atol=1e-12)

    def test_amp_phase_and_complex_free(self):
        n = 16
        d = crandn(n)
        freqs = 100.0 + np.arange(n) * 0.1
        invcov = np.linalg.inv(hermitian(n))

        tau, amp, ph = lssa.lssa_fit_modes(
            jnp.asarray(d), jnp.asarray(freqs), jnp.asarray(invcov))
        _, amp2, ph2 = lssa.lssa_fit_modes_rp(
            cpair(d), freqs, cpair(invcov))
        np.testing.assert_allclose(np.asarray(amp2), np.asarray(amp),
                                   rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(np.asarray(ph2), np.asarray(ph),
                                   rtol=1e-9, atol=1e-9)
        assert_complex_free(
            lambda dd, ic: lssa.lssa_fit_modes_rp(dd, freqs, ic),
            cpair(d), cpair(invcov))


class TestOqeRP:
    def setup_method(self, _):
        self.s = 12
        self.R = np.linalg.inv(hermitian(self.s))
        self.Cn = hermitian(self.s, 0.5)
        self.V = crandn(6, self.s) * 2.0

    def test_qhat_all(self):
        ref = oqe.qhat_all(jnp.asarray(self.V), jnp.asarray(self.R))
        got = oqe.qhat_all_rp(cpair(self.V), cpair(self.R))
        np.testing.assert_allclose(tonp(got), np.asarray(ref),
                                   rtol=1e-9, atol=1e-9)
        assert_complex_free(oqe.qhat_all_rp, cpair(self.V), cpair(self.R))

    def test_qhat_h_and_bias(self):
        v1, v2 = cpair(self.V[0::2]), cpair(self.V[1::2])
        ref = oqe.qhat_h_all(jnp.asarray(self.V[0::2]),
                             jnp.asarray(self.V[1::2]), jnp.asarray(self.R))
        got = oqe.qhat_h_all_rp(v1, v2, cpair(self.R))
        np.testing.assert_allclose(tonp(got), np.asarray(ref),
                                   rtol=1e-9, atol=1e-9)
        bref = oqe.bias(jnp.asarray(self.R), jnp.asarray(self.Cn))
        bgot = oqe.bias_rp(cpair(self.R), cpair(self.Cn))
        np.testing.assert_allclose(tonp(bgot), np.asarray(bref),
                                   rtol=1e-9, atol=1e-9)
        assert_complex_free(oqe.qhat_h_all_rp, v1, v2, cpair(self.R))

    def test_fisher_and_normalizations(self):
        Fref = oqe.F(jnp.asarray(self.R))
        Fgot = oqe.F_rp(cpair(self.R))
        np.testing.assert_allclose(tonp(Fgot), np.asarray(Fref),
                                   rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(
            tonp(oqe.M_Finv_rp(Fgot)), np.asarray(oqe.M_Finv(Fref)),
            rtol=1e-7, atol=1e-9)
        np.testing.assert_allclose(
            tonp(oqe.M_opt_rp(Fgot)), np.asarray(oqe.M_opt(Fref)),
            rtol=1e-7, atol=1e-9)
        np.testing.assert_allclose(
            tonp(oqe.M_Fhalf_rp(Fgot)), np.asarray(oqe.M_Fhalf(Fref)),
            rtol=1e-6, atol=1e-8)
        assert_complex_free(oqe.F_rp, cpair(self.R))
        assert_complex_free(oqe.M_opt_rp, Fgot)
        assert_complex_free(oqe.M_Fhalf_rp, Fgot)

    def test_error_bars_and_getqs(self):
        Cs = hermitian(self.s, 0.2)
        nref = oqe.Sig_QEN(jnp.asarray(self.R), jnp.asarray(self.Cn), 0.7)
        ngot = oqe.Sig_QEN_rp(cpair(self.R), cpair(self.Cn), 0.7)
        np.testing.assert_allclose(tonp(ngot), np.asarray(nref),
                                   rtol=1e-8, atol=1e-9)
        sref = oqe.Sig_QESN(jnp.asarray(self.R), jnp.asarray(self.Cn),
                            jnp.asarray(Cs), 0.7)
        sgot = oqe.Sig_QESN_rp(cpair(self.R), cpair(self.Cn), cpair(Cs), 0.7)
        np.testing.assert_allclose(tonp(sgot), np.asarray(sref),
                                   rtol=1e-8, atol=1e-9)
        qs, Fm, MB, MA = oqe.getqs(jnp.asarray(self.V), jnp.asarray(self.R))
        qs2, Fm2, MB2, MA2 = oqe.getqs_rp(cpair(self.V), cpair(self.R))
        np.testing.assert_allclose(tonp(qs2), np.asarray(qs),
                                   rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(tonp(MA2), np.asarray(MA),
                                   rtol=1e-7, atol=1e-9)


class TestDpssRP:
    def test_matches_complex_tier(self):
        n, nm = 32, 6
        d = crandn(n) * 5.0
        w = np.ones(n)
        w[7] = 0.0
        freqs = np.linspace(100e6, 120e6, n)
        cov = hermitian(n)

        modes_ref, amps_ref = dpss.dpss_fit_modes(
            jnp.asarray(d), w, freqs, jnp.asarray(cov), nmodes=nm)
        modes_got, amps_got = dpss.dpss_fit_modes_rp(
            cpair(d), w, freqs, cpair(cov), nmodes=nm)
        np.testing.assert_allclose(np.asarray(modes_got),
                                   np.asarray(modes_ref), rtol=1e-12)
        np.testing.assert_allclose(np.asarray(amps_got),
                                   np.asarray(amps_ref),
                                   rtol=1e-6, atol=1e-9)

    def test_complex_free(self):
        n, nm = 16, 3
        d = cpair(crandn(n))
        cov = cpair(hermitian(n))
        w = np.ones(n)
        freqs = np.linspace(100e6, 120e6, n)
        assert_complex_free(
            lambda dd, cc: dpss.dpss_fit_modes_rp(dd, w, freqs, cc,
                                                  nmodes=nm)[1],
            d, cov)


def test_rp_tier_runs_in_float32():
    """The production dtype path (float32 on the device)."""
    n = 16
    d = cpair(crandn(n), jnp.float32)
    invcov = cpair(np.linalg.inv(hermitian(n)), jnp.float32)
    freqs = (100.0 + np.arange(n) * 0.1).astype(np.float32)
    tau, amp, ph = lssa.lssa_fit_modes_rp(d, freqs, invcov)
    assert amp.dtype == jnp.float32 and np.isfinite(np.asarray(amp)).all()
    R = cpair(np.linalg.inv(hermitian(n)), jnp.float32)
    q = oqe.qhat_all_rp(cpair(crandn(4, n), jnp.float32), R)
    assert q.re.dtype == jnp.float32
    assert np.isfinite(tonp(q)).all()
