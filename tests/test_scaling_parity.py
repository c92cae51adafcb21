"""Scaling-study parity: the ``timings.json`` files that a 1-process and a
2-process CLI run write on a seeded ``.uvh5`` carry the schema the
reference's scaling plotter reads (scripts/scaling_tests/plot_speed_up.py
there, :62-69; written by run-hydra-pspec.py:570-581), and the speed-up it
derives from them — the rank-1 timer over the rank-n timer — is defined."""
import json

import numpy as np

from hydra_pspec_tpu.utils import synthetic
from test_multihost import run_two_procs

TIMERS = {"load_data", "scatter", "process", "barrier", "total"}


def test_timings_drive_the_speedup_study(tmp_path):
    from hydra_pspec_tpu.cli.run import main

    p = synthetic.make_problem(4, seed=5, ntimes=16, nfreqs=24, nmodes=3)
    fp = p.write_uvh5(tmp_path / "vis.uvh5")

    def argv(out):
        return [str(fp), "--out_dir", str(out), "--dirname", "res",
                "--Niter", "4", "--write_Niter", "2", "--seed", "7",
                *p.cli_args()]

    runs = tmp_path / "runs"
    assert main(argv(runs / "n1")) == 0
    run_two_procs(argv(runs / "n2"))

    combined = [json.loads((runs / n / "res" / "timings.json").read_text())
                for n in ("n1", "n2")]
    assert [c["num_ranks"] for c in combined] == [1, 2]
    bls = {f"0_{i + 1}" for i in range(4)}
    for c in combined:
        assert c["num_baselines"] == 4
        assert set(c["rank_0_timers"]) == TIMERS
        assert all(np.isfinite(v) and v >= 0
                   for v in c["rank_0_timers"].values())
        assert [e["rank"] for e in c["write_data"]] == list(
            range(c["num_ranks"]))
        written = [bl for e in c["write_data"] for bl in e["ant_pairs"]]
        assert sorted(written) == sorted(bls)
        assert all(len(e["ant_pairs"]) == len(e["write_times"])
                   for e in c["write_data"])
    for timer in ("process", "total"):
        t1, t2 = (c["rank_0_timers"][timer] for c in combined)
        assert t1 > 0 and t2 > 0 and np.isfinite(t1 / t2)
