"""CLI artifact coverage: rhat.json persistence, true per-baseline write
times in timings.json (reference run-hydra-pspec.py:554-581), the
--profile_dir tracing hook (SURVEY §5.1), and prep-script metadata parity
(reference scripts/calc-vis-cov-matrices.py:225-231)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

from test_multihost import _write_inputs

REPO = Path(__file__).resolve().parents[1]


def _run_cli(fp, out_dir, *extra):
    from hydra_pspec_tpu.cli.run import main

    argv = [
        str(fp),
        "--out_dir", str(out_dir),
        "--dirname", "res",
        "--Niter", "6",
        "--write_Niter", "3",
        "--seed", "7",
        "--Nfgmodes", "2",
        *extra,
    ]
    assert main(argv) == 0
    return out_dir / "res"


def test_rhat_json_written_and_consistent(tmp_path):
    fp, bl_strs = _write_inputs(tmp_path)
    res = _run_cli(fp, tmp_path / "out", "--nchains", "2")
    rj = json.loads((res / "rhat.json").read_text())
    assert set(rj) == {bl.replace("-", "_") for bl in bl_strs}
    for bl, rec in rj.items():
        assert set(rec) == {"max", "median", "per_bin"}
        assert len(rec["per_bin"]) == 16  # nfreqs of the fixture
        assert np.isfinite(rec["max"]) and rec["max"] >= rec["median"]
        # rhat.json must agree with a recomputation from the sample files
        from hydra_pspec_tpu.runner import gelman_rubin

        chains = np.stack([
            np.load(res / bl.replace("_", "-") / f"chain-{c}" / "dps-eor.npy")
            for c in range(2)
        ])
        expect = gelman_rubin(chains)
        np.testing.assert_allclose(rec["per_bin"], expect, atol=1e-5)


def test_per_baseline_write_times_in_timings(tmp_path):
    fp, bl_strs = _write_inputs(tmp_path)
    res = _run_cli(fp, tmp_path / "out")
    tj = json.loads((res / "timings.json").read_text())
    wd = tj["write_data"]
    assert len(wd) == 1  # one entry per rank (reference schema)
    entry = wd[0]
    assert entry["rank"] == 0
    assert entry["ant_pairs"] == [bl.replace("-", "_") for bl in bl_strs]
    wt = entry["write_times"]
    assert len(wt) == len(bl_strs)
    # true per-baseline times: positive, finite, and NOT the even split of
    # the aggregate that r3 wrote (they are independently measured, so an
    # exact three-way tie is a measurement impossibility)
    assert all(np.isfinite(t) and t > 0 for t in wt)
    assert len(set(wt)) > 1


def test_profile_dir_captures_trace(tmp_path):
    fp, _ = _write_inputs(tmp_path)
    prof = tmp_path / "trace"
    _run_cli(fp, tmp_path / "out", "--profile_dir", str(prof))
    # jax.profiler writes plugins/profile/<ts>/*.trace.json.gz etc.
    produced = list(prof.rglob("*"))
    assert any(p.is_file() for p in produced), produced


def test_prep_metadata_reference_keys(tmp_path):
    fp, bl_strs = _write_inputs(tmp_path)
    out = tmp_path / "prep"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, str(REPO / "scripts" / "calc_vis_cov_matrices.py"),
         str(fp), "--out-dir", str(out), "--eig"],
        env=env, capture_output=True, text=True, timeout=180,
    )
    assert r.returncode == 0, r.stderr
    meta = np.load(out / "metadata-dict.npy", allow_pickle=True).item()
    # exact reference key set (calc-vis-cov-matrices.py:225-231)
    assert set(meta) == {"git", "args", "freqs", "lsts", "uvws", "bls"}
    assert meta["freqs"].shape == (16,)
    assert meta["uvws"].shape == (len(bl_strs), 3)
    assert [tuple(b) for b in meta["bls"]] == [
        tuple(int(x) for x in bl.split("-")) for bl in bl_strs
    ]
    # per-baseline covariance + eigenmode outputs still land
    for bl in bl_strs:
        assert list((out / bl).glob("cov-*.npy"))
        assert list((out / bl).glob("evecs-*.npy"))
