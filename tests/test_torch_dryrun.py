"""The port's multi-rank dry run (`parallel/dryrun.py`), the counterpart of
`__graft_entry__.dryrun_multichip`, on gloo CPU ranks.

`python -m open_vins_tpu_torch.parallel.dryrun 2 --device cpu --small`
(two ranks, the ensemble at the graft problem's sizes, the sharded update
at the large map's D = 1434, the distributed BA on 8 landmarks) must pass
and print the three "OK" lines and the host-bound caveat that
`dryrun_multichip` prints.  The equivalent of the reference's 8-device run
(`MULTICHIP_r05.json`: 8 virtual CPU devices at the operating point) runs 8
ranks at the operating point and is marked slow (about two minutes on 8
cores).  `dryrun.build_problem` must have the graft problem's sizes.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _dryrun(*args, timeout):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run(
        [sys.executable, "-m", "open_vins_tpu_torch.parallel.dryrun", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout)


def _assert_ok(out, n):
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.splitlines()
    assert any(f"ensemble over {n} ranks OK" in line for line in lines)
    assert any("host-bound" in line and "not a hardware scaling" in line
               for line in lines)
    assert any("sharded-covariance EKF update OK (D = 1434" in line
               for line in lines)
    assert any(f"distributed Schur BA OK; {n} ranks" in line
               for line in lines)


def test_dryrun_two_ranks_cpu():
    _assert_ok(_dryrun("2", "--device", "cpu", "--small", "--reps", "1",
                       timeout=300), 2)


@pytest.mark.slow
def test_dryrun_eight_ranks_operating_point():
    _assert_ok(_dryrun("8", "--device", "cpu", timeout=1200), 8)


def test_build_problem_has_graft_sizes():
    """`dryrun.build_problem`'s defaults are `__graft_entry__._build_problem`'s:
    5 clones, MSCKF only, <= 8 MSCKF features, rk4, two Gauss-Newton runs,
    12 points per frame, a 64-row table, 1 s at 10 Hz (the JAX simulator's
    staging is not run here: it costs a jit of tens of seconds)."""
    from open_vins_tpu_torch.parallel import dryrun

    cfg, opts, state, table, run = dryrun.build_problem(device="cpu")
    assert (cfg.max_clones, cfg.max_slam, cfg.max_msckf_in_update,
            cfg.integration) == (5, 0, 8, "rk4")
    assert opts.max_runs == 2
    assert state.cov.shape == (cfg.state_dim, cfg.state_dim) == (84, 84)
    assert table.ids.shape == (64,)
    assert run.frames.ids.shape == (9, 1, 12)
    assert run.frames.win.t.shape == (9, 11)
