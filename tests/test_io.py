"""IO round-trips: uvh5 writer/reader, config parsing, prep scripts, and
the multi-baseline CLI path on fabricated data."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from hydra_pspec_tpu.utils import uvh5 as uv
from hydra_pspec_tpu.utils.config import RunConfig

RNG = np.random.default_rng(91)


def crandn(*shape):
    return (RNG.standard_normal(shape) + 1j * RNG.standard_normal(shape)) / np.sqrt(2)


def test_uvh5_roundtrip(tmp_path):
    ntimes, nfreqs = 7, 12
    freqs = 100e6 + 1e5 * np.arange(nfreqs)
    pairs = {(0, 1): crandn(ntimes, nfreqs), (1, 3): crandn(ntimes, nfreqs)}
    flags = {(0, 1): np.zeros((ntimes, nfreqs), bool)}
    flags[(0, 1)][:, 4] = True
    fp = tmp_path / "t.uvh5"
    uv.write_uvh5(fp, pairs, freqs, flags_by_baseline=flags)

    bls, fout = uv.read_uvh5(fp)
    assert [b.antpair for b in bls] == [(0, 1), (1, 3)]
    np.testing.assert_allclose(fout, freqs)
    np.testing.assert_allclose(bls[0].vis, pairs[(0, 1)], atol=1e-12)
    assert bls[0].flags[:, 4].all()
    assert not bls[1].flags.any()


def test_uvh5_conjugation(tmp_path):
    """Baselines stored as (hi, lo) must be conjugated to (lo, hi) like
    pyuvdata's conjugate_bls (the bundled files store (1, 0))."""
    import h5py

    ntimes, nfreqs = 5, 8
    freqs = 1e8 + 1e5 * np.arange(nfreqs)
    d = crandn(ntimes, nfreqs)
    fp = tmp_path / "c.uvh5"
    uv.write_uvh5(fp, {(2, 7): d}, freqs)
    # swap the antenna arrays on disk to store it as (7, 2)
    with h5py.File(fp, "r+") as f:
        a1 = f["Header/ant_1_array"][:]
        a2 = f["Header/ant_2_array"][:]
        del f["Header/ant_1_array"], f["Header/ant_2_array"]
        f["Header/ant_1_array"] = a2
        f["Header/ant_2_array"] = a1
    bls, _ = uv.read_uvh5(fp)
    assert bls[0].antpair == (2, 7)
    np.testing.assert_allclose(bls[0].vis, np.conj(d), atol=1e-12)


def test_pseudo_stokes_formation(tmp_path):
    ntimes, nfreqs = 4, 6
    freqs = 1e8 + 1e5 * np.arange(nfreqs)
    d = crandn(ntimes, nfreqs)
    fp = tmp_path / "p.uvh5"
    uv.write_uvh5(fp, {(0, 1): d}, freqs, pols=("xx", "yy"))
    bls, _ = uv.read_uvh5(fp)
    # pI = xx + yy = 2 d (writer replicates across pols)
    np.testing.assert_allclose(bls[0].vis, 2 * d, atol=1e-12)


def test_filter_freqs_matches_reference_semantics():
    freqs = np.linspace(100, 120, 21)
    np.testing.assert_allclose(
        uv.filter_freqs("105-110", freqs), freqs[(freqs >= 105) & (freqs <= 110)]
    )
    out = uv.filter_freqs("104.9,119.2", freqs)
    np.testing.assert_allclose(out, [105.0, 119.0])


def test_config_rejects_unknown_keys(tmp_path):
    cfg_file = tmp_path / "c.yaml"
    cfg_file.write_text("Niter: 5\nbogus_key: 1\n")
    with pytest.raises(ValueError, match="bogus_key"):
        RunConfig.from_yaml(cfg_file)


def test_scaling_fabricator_and_multibaseline_cli(tmp_path):
    """Fabricate 3 identical baselines, run the CLI on them, and use the
    identical-results property as the correctness oracle (the reference's
    scaling-fixture methodology, scaling_tests_README.md:53-58), on the
    seeded baseline the fabricator draws without the reference's data."""
    env_root = tmp_path / "sd"
    subprocess.run(
        [sys.executable, "scripts/make_scaling_data.py", "--n", "3",
         "--out", str(env_root)],
        check=True, cwd=Path(__file__).resolve().parent.parent,
    )
    from hydra_pspec_tpu.cli.run import main

    rc = main([
        str(env_root / "vis.uvh5"),
        "--noise_cov", str(env_root / "aux"), "--noise_cov_file", "noise-cov.npy",
        "--fgmodes", str(env_root / "aux"), "--fgmodes_file", "fgmodes.npy",
        "--sigcov0", str(env_root / "aux"), "--sigcov0_file", "eor-cov.npy",
        "--noise", str(env_root / "aux"), "--noise_file", "noise.npy",
        "--Niter", "4", "--Nfgmodes", "12", "--seed", "7123689",
        "--ps_prior_lo", "0.1", "--ps_prior_hi", "2.0",
        "--out_dir", str(tmp_path / "out"), "--dirname", "res", "--clobber",
    ])
    assert rc == 0
    res = tmp_path / "out" / "res"
    dps = [np.load(res / f"0-{i+1}" / "dps-eor.npy") for i in range(3)]
    assert dps[0].shape == (4, 120)
    for d in dps:
        assert np.isfinite(d).all()
    # identical data, different chain keys -> statistically compatible but
    # not identical chains; check they are all in the same ballpark
    means = np.stack([d.mean(axis=0) for d in dps])
    spread = means.std(axis=0) / np.maximum(means.mean(axis=0), 1e-30)
    assert np.median(spread) < 1.0


def test_form_pseudo_stokes_function():
    xx, yy = crandn(3, 4), crandn(3, 4)
    out = uv.form_pseudo_stokes(xx, yy, convention=0.5)
    np.testing.assert_allclose(out, 0.5 * (xx + yy), atol=1e-15)
