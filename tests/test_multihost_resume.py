"""Kill-and-resume under two jax.distributed CPU processes on the float32
real engine: a run stopped at iteration 2 and resumed to 4 must produce
complete outputs bit-identical to an uninterrupted 4-iteration two-process
run (per-process checkpoints, chunk keys folded from the global iteration
offset)."""
import numpy as np

from test_multihost import _argv, _write_inputs, run_two_procs

FILES = ("dps-eor.npy", "ln-post.npy", "gcr-eor.npy", "chisq.npy")


def test_two_process_resume_matches_uninterrupted(tmp_path):
    fp, bl_strs = _write_inputs(tmp_path)

    full_out = tmp_path / "full"
    run_two_procs(_argv(fp, full_out, niter=4, engine="real"))

    part_out = tmp_path / "part"
    run_two_procs(_argv(fp, part_out, niter=2, engine="real"))
    for pid in range(2):
        assert (part_out / "res" / f"checkpoint-p{pid}.npz").exists()
    run_two_procs(_argv(fp, part_out, niter=4, engine="real", resume=True))

    for bl in bl_strs:
        for name in FILES:
            a = np.load(part_out / "res" / bl / name)
            b = np.load(full_out / "res" / bl / name)
            assert a.shape == b.shape == (4,) + b.shape[1:], (bl, name)
            np.testing.assert_array_equal(a, b, err_msg=f"{bl}/{name}")
