"""How reproducible one filter step is in f32, against the port's gap.

    python tests/torch_step_spread.py [--problem graft|slam|wide] [--frames N]

For every frame, both packages step from the same JAX state and table.  The
script prints, per frame, the number of MSCKF features, the port's
covariance gap to the jitted JAX step, and the gap between the jitted and
the eager (`jax.disable_jit`) JAX step on the same inputs, each relative to
max|P_ij| and to the row-sum norm ‖P‖∞ of the jitted JAX covariance, and
the same two gaps in the state values (the largest over the pose, velocity,
biases, clones, calibration and landmark positions).  The
eager-vs-jit gap is the reference's own f32 reproducibility: a parity
tolerance tighter than it cannot be met by any implementation.

`graft` is `__graft_entry__._build_problem()` (5 clones, 12 points, 9
frames); `slam` is `torch_port_helpers.slam_problem()` (5 clones, 4 SLAM
slots, ACI², on the staged frames below); `wide` is the staged reference-width run of
`open_vins_tpu_torch/data/msckf_sim20_seed0.npz` (11 clones, 200 points),
reported from frame 10 on, where the window is full.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from open_vins_tpu.models import manager as jman  # noqa: E402
from open_vins_tpu_torch.models import manager as tman  # noqa: E402
from open_vins_tpu_torch.models import runner as trun  # noqa: E402
from torch_port_helpers import (STATE_VALUE_FIELDS,  # noqa: E402
                                fixture_problem, graft_problem,
                                jax_frames_to_port, jax_state_to_port,
                                jax_table_to_port, slam_problem)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--problem", choices=("graft", "slam", "wide"),
                    default="graft")
    ap.add_argument("--frames", type=int, default=9)
    args = ap.parse_args()
    pb, first = {"graft": (graft_problem, 0), "slam": (slam_problem, 0),
                 "wide": (fixture_problem, 10)}[args.problem]
    pb = pb()
    jc, jt = pb.cfg_jax, pb.tri_jax
    step = jax.jit(lambda s, tb, f: jman.step_frame(s, tb, jc, jt, f))
    frames_t = jax_frames_to_port(pb.frames)
    state, table = pb.state, pb.table
    for k in range(args.frames):
        fr = jax.tree_util.tree_map(lambda a: a[k], pb.frames)
        post = step(state, table, fr)
        if k >= first:
            with jax.disable_jit():
                eager = jman.step_frame(state, table, jc, jt, fr)
            port = tman.step_frame(
                jax_state_to_port(state), jax_table_to_port(table),
                pb.cfg_port, pb.tri_port, trun.frame_at(frames_t, k))
            cov = np.asarray(post[0].cov)
            norms = {"max": np.abs(cov).max(),
                     "inf": np.abs(cov).sum(1).max()}
            gap_port = np.abs(port[0].cov.numpy() - cov).max()
            gap_eager = np.abs(np.asarray(eager[0].cov) - cov).max()

            def value_gap(st):
                return max(float(np.abs(np.asarray(getattr(st, f))
                                        - np.asarray(getattr(post[0], f)))
                                 .max())
                           for f in STATE_VALUE_FIELDS + ("slam_p",))
            print(json.dumps({
                "frame": k, "n_msckf_jax": int(post[2].n_msckf),
                "n_msckf_port": int(port[2].n_msckf),
                "n_slam_jax": int(post[2].n_slam),
                "n_slam_port": int(port[2].n_slam),
                **{f"port_gap_rel_{n}": float(gap_port / v)
                   for n, v in norms.items()},
                **{f"jax_eager_gap_rel_{n}": float(gap_eager / v)
                   for n, v in norms.items()},
                "port_value_gap": value_gap(port[0]),
                "jax_eager_value_gap": value_gap(eager[0]),
            }), flush=True)
        state, table = post[0], post[1]


if __name__ == "__main__":
    main()
