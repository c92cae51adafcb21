"""Fabricate an N-baseline scaling dataset — the reference's scaling
fixture (set_up_scaling_data.py:19-34: N identical baselines so identical
per-baseline results are the correctness oracle) as a multi-baseline uvh5
plus the per-baseline aux directory layout the driver consumes.

The baseline is the reference's bundled simulation when ``--data`` names
its test_data directory, else one drawn from a seed at the same shapes
(hydra_pspec_tpu/utils/synthetic.py): noiseless visibilities in the uvh5,
the noise draw, its covariance, the foreground modes and the true signal
covariance as the aux files.

Usage:
    python scripts/make_scaling_data.py --n 16 --out scaling-data/
    python -m hydra_pspec_tpu.cli.run scaling-data/vis.uvh5 \
        --noise_cov scaling-data/aux --noise_cov_file noise-cov.npy \
        --fgmodes scaling-data/aux --fgmodes_file fgmodes.npy \
        --sigcov0 scaling-data/aux --sigcov0_file eor-cov.npy \
        --noise scaling-data/aux --noise_file noise.npy \
        --Niter 4 --Nfgmodes 12 --seed 7123689 --out_dir out/
"""
import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _reference_baseline(td):
    from hydra_pspec_tpu.utils.uvh5 import read_uvh5

    bls, freqs = read_uvh5(td / "vis-eor-fgs.uvh5")
    aux = {name: np.load(td / "0-1" / name) for name in
           ("noise.npy", "noise-cov.npy", "fgmodes.npy", "eor-cov.npy")}
    return bls[0].vis, freqs, bls[0].times, aux


def _seeded_baseline(seed):
    from hydra_pspec_tpu.utils import synthetic

    p = synthetic.make_problem(1, seed=seed)
    nfreqs = p.vis.shape[-1]
    i = np.arange(nfreqs) - nfreqs // 2
    f_op = np.exp(-2j * np.pi * np.outer(i, i) / nfreqs)
    aux = {
        "noise.npy": p.noise[0],
        "noise-cov.npy": np.diag(1.0 / p.ninv),
        "fgmodes.npy": p.fgmodes,
        "eor-cov.npy": f_op.conj().T @ np.diag(p.ps_true / nfreqs**2) @ f_op,
    }
    return p.vis[0] - p.noise[0], 1e8 + np.arange(nfreqs) * 1e5, None, aux


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--data", default=None,
                   help="the reference's test_data directory (default: "
                        "a seeded baseline at its shapes)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--n", type=int, default=8, help="number of baselines")
    p.add_argument("--out", default="./scaling-data")
    args = p.parse_args()

    from hydra_pspec_tpu.utils.uvh5 import write_uvh5

    if args.data:
        vis, freqs, times, aux = _reference_baseline(Path(args.data))
    else:
        vis, freqs, times, aux = _seeded_baseline(args.seed)
    out = Path(args.out)
    (out / "aux").mkdir(parents=True, exist_ok=True)
    pairs = {(0, i + 1): vis.copy() for i in range(args.n)}
    write_uvh5(out / "vis.uvh5", pairs, freqs, times=times)
    for i in range(args.n):
        d = out / "aux" / f"0-{i + 1}"
        d.mkdir(exist_ok=True)
        for name, arr in aux.items():
            np.save(d / name, arr)
    print(f"wrote {args.n} baselines to {out}/vis.uvh5 + aux dirs")


if __name__ == "__main__":
    main()
