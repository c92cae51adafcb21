"""End-to-end acceptance through the CLI on a seeded problem drawn from the
sampler's own model (hydra_pspec_tpu/utils/synthetic.py) — the automated
form of the reference's validation procedure (test_data/README.md:36-49):
run the CLI on a ``.uvh5`` file and require chi^2 ~ 1 after burn-in and the
posterior-mean delay power spectrum to recover the known spectrum on the
EoR-dominated bins.

The shapes are cut from the reference's 203 x 120 x 12 to keep the CPU run
short; chip_smoke.py runs the full shapes on the GPU.
"""
import json

import numpy as np
import pytest

from hydra_pspec_tpu.utils import synthetic

SHAPE = dict(ntimes=128, nfreqs=48, nmodes=6)
NITER, NBURN = 160, 60
CHI2_TOL = 0.03          # ~3 sd of one 128 x 48 noise realisation's mean
RATIO_BAND = (0.9, 1.1)


def _run_cli(tmp_path, *extra, niter=NITER, flagged=False):
    from hydra_pspec_tpu.cli.run import main

    p = synthetic.make_problem(1, seed=2024, flagged=flagged, **SHAPE)
    fp = p.write_uvh5(tmp_path / "vis.uvh5")
    rc = main([str(fp), "--out_dir", str(tmp_path), "--dirname", "res",
               "--Niter", str(niter), "--write_Niter", str(niter // 2),
               "--seed", "7123689", "--clobber", *p.cli_args(), *extra])
    assert rc == 0
    return p, tmp_path / "res"


def _check_recovery(p, res):
    dps = np.load(res / "0-1" / "dps-eor.npy")
    chisq = np.load(res / "0-1" / "chisq.npy")
    assert dps.shape == (NITER, p.vis.shape[-1])
    assert np.isfinite(dps).all()
    keep = p.w.astype(bool)
    # chi^2 per unflagged channel ~ 1 after burn-in (reference soft
    # assertion, pspec.py:447-458)
    chi_mean = chisq[NBURN:][..., keep].mean()
    assert abs(chi_mean - 1.0) < CHI2_TOL, chi_mean
    ratio = synthetic.recovery_ratio(dps[NBURN:], p.ps_true)
    assert RATIO_BAND[0] < ratio < RATIO_BAND[1], ratio
    return dps


def test_cli_end_to_end_recovers_truth(tmp_path):
    """The CPU default (x64, complex parity engine) through the CLI."""
    p, res = _run_cli(tmp_path)
    _check_recovery(p, res)
    timings = json.loads((res / "timings.json").read_text())
    assert timings["engine"] == "complex"
    # provenance artifacts in the reference schema
    for name in ("timings.json", "resources.json", "args.json", "git.json"):
        assert (res / name).exists()


def test_cli_end_to_end_real_engine_recovers_truth(tmp_path):
    """The float32 real engine — the GPU's path — on RFI-flagged data
    (in-painting), through the full CLI."""
    p, res = _run_cli(tmp_path, "--engine", "real", "--solver", "chol",
                      flagged=True)
    dps = _check_recovery(p, res)
    assert dps.dtype == np.float32
    cr = np.load(res / "0-1" / "gcr-eor.npy")
    assert np.abs(cr[-1][:, p.w == 0]).min() > 0   # flagged cells in-painted


def test_map_estimate_cli(tmp_path):
    p, res = _run_cli(tmp_path, "--map_estimate", niter=4)
    cr = np.load(tmp_path / "res-map-estimate" / "0-1" / "gcr-eor.npy")
    assert cr.shape == (1,) + p.vis.shape[1:]
    assert np.isfinite(cr).all()


@pytest.mark.parametrize("backend, want", [("cpu", True), ("gpu", False)])
def test_precision_auto_resolves_by_backend(monkeypatch, backend, want):
    """precision='auto' is x64 on the CPU (parity) and x32 on the GPU, so a
    reference YAML config (which has no precision key) runs the float32
    real engine on a GPU host."""
    import jax

    from hydra_pspec_tpu.cli.run import setup_precision
    from hydra_pspec_tpu.utils.config import RunConfig

    assert RunConfig().precision == "auto"
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    setup_precision(RunConfig())
    assert (("jax_enable_x64", True) in calls) == want
