"""The seeded problem generator (hydra_pspec_tpu/utils/synthetic.py) that
the smoke run, the benchmark and the end-to-end tests share."""
import numpy as np
import pytest

from hydra_pspec_tpu.utils import synthetic

SMALL = dict(ntimes=64, nfreqs=32, nmodes=4)


def test_same_seed_same_problem():
    a = synthetic.make_problem(2, seed=3, **SMALL)
    b = synthetic.make_problem(2, seed=3, **SMALL)
    c = synthetic.make_problem(2, seed=4, **SMALL)
    for f in ("vis", "signal", "w", "fgmodes", "ninv", "ps_true", "prior"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert not np.allclose(a.vis, c.vis)
    assert a.vis.shape == (2, 64, 32) and a.fgmodes.shape == (32, 4)


def test_reference_shapes_and_prior():
    p = synthetic.make_problem(1, seed=0, flagged=True)
    assert p.vis.shape == (1, 203, 120) and p.fgmodes.shape == (120, 12)
    assert sorted(np.flatnonzero(p.w == 0)) == list(synthetic.FLAGGED_CHANNELS)
    window = np.flatnonzero(p.prior[0] > 0)
    assert list(window) == list(range(57, 64))            # 7 bins at 60
    assert np.all(p.prior[1, window] == synthetic.PRIOR_LO)
    assert np.all(p.prior[0, window] == synthetic.PRIOR_HI)
    # the truth is inside the prior where the prior bounds it
    assert np.all((p.ps_true[window] >= synthetic.PRIOR_LO)
                  & (p.ps_true[window] <= synthetic.PRIOR_HI))


def test_signal_has_the_true_spectrum():
    """E|F s_t|^2 = ps_true: the realized delay power over many times and
    baselines matches within its sampling error."""
    p = synthetic.make_problem(8, seed=1, **SMALL)
    sk = np.fft.fftshift(np.fft.fft(np.fft.ifftshift(p.signal, axes=-1),
                                    axis=-1), axes=-1)
    ratio = (np.abs(sk) ** 2).mean(axis=(0, 1)) / p.ps_true
    assert abs(np.median(ratio) - 1) < 0.05      # 512 draws per bin


def test_uvh5_roundtrip(tmp_path):
    from hydra_pspec_tpu.utils.uvh5 import read_uvh5

    p = synthetic.make_problem(3, seed=2, flagged=True, **SMALL)
    bls, freqs = read_uvh5(p.write_uvh5(tmp_path / "v.uvh5"))
    assert [b.antpair for b in bls] == [(0, 1), (0, 2), (0, 3)]
    for i, b in enumerate(bls):
        np.testing.assert_allclose(b.vis, p.vis[i], rtol=1e-6)
        np.testing.assert_array_equal(b.flags, p.flags)


@pytest.mark.parametrize("flagged", [False, True])
def test_short_run_recovers_truth(flagged):
    """A short real-engine run on the seeded problem: chi^2 ~ 1 on the
    unflagged channels and the posterior recovers ps_true on the
    EoR-dominated bins."""
    from hydra_pspec_tpu.runner import run_baselines

    p = synthetic.make_problem(2, seed=5, flagged=flagged, ntimes=96,
                               nfreqs=48, nmodes=6)
    res, timings = run_baselines(p.jobs(), p.prior, 120, seed=1,
                                 engine="real", write_niter=60,
                                 use_mesh=False)
    assert timings["engine"] == "real"
    keep = p.w.astype(bool)
    chi = np.mean([r.chisq[40:][..., keep].mean() for r in res])
    assert abs(chi - 1.0) < 0.03, chi
    ratio = synthetic.recovery_ratio(
        np.stack([r.signal_ps[40:] for r in res]), p.ps_true)
    assert 0.9 < ratio < 1.1, ratio
