"""The port's vmapped MSCKF-only step against JAX's `jax.vmap` of
`manager.step_frame`.

tests/test_torch_ensemble.py holds the batched MSCKF-only step against the
port's own single-stream steps, and the batched SLAM step against JAX's
vmapped step.  This file closes the last pair: B = 4 streams (seeds 0-3)
at the graft problem's sizes, MSCKF only (`max_slam=0`, rk4; 5 clones, 12
points, a 10 Hz camera for 1 s, <= 8 MSCKF features), every frame stepped
by `jax.jit(jax.vmap(jman.step_frame))` and by the port's
`runner.ensemble_step` (`manager.step_frame` under `torch.func.vmap`) from
the same JAX state.  Each stream is held at the step-parity tolerances of
the ground rules (ROADMAP.md): values within 1e-4, bookkeeping exact, the
covariance within 1e-5·‖P‖∞, the diagnostics' counts and the table exactly
(pixels within 1e-5).  Against max|P_ij| the gap reaches 3.2e-5 on the
frame of the first MSCKF update with the window full, where JAX's own
jitted vmapped step and its eager single step differ by up to 7.4e-5
(measured on the CPU); the port's vmapped step is there within 1e-6·‖P‖∞
of its own single-stream step (tests/test_torch_ensemble.py (a)), so the
batching adds nothing to the gap.
"""

import jax
import pytest
import torch
import torch.utils._pytree as pytree

from open_vins_tpu.models import manager as jman
from open_vins_tpu_torch.models import runner as trun
from torch_port_helpers import (assert_state_close, assert_table_equal,
                                ensemble_problem, jax_frames_to_port,
                                jax_state_to_port, jax_table_to_port)

SEEDS = (0, 1, 2, 3)
N_FRAMES = 9
DIAG_FIELDS = ("n_msckf", "n_tracks", "n_slam", "n_slam_used")


@pytest.fixture(scope="module")
def steps():
    """[(k, JAX post, port post)] for every frame, both from JAX's state."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    pb = ensemble_problem(0, "rk4", seeds=SEEDS)
    jstep = jax.jit(jax.vmap(lambda s, tb, f: jman.step_frame(
        s, tb, pb.cfg_jax, pb.tri_jax, f)))
    tstep = trun.ensemble_step(pb.cfg_port, pb.tri_port)
    frames_t = jax_frames_to_port(pb.frames)
    state, table = pb.state, pb.table
    cases = []
    for k in range(N_FRAMES):
        post_j = jstep(state, table, jax.tree_util.tree_map(
            lambda a: a[:, k], pb.frames))
        post_t = tstep(jax_state_to_port(state), jax_table_to_port(table),
                       pytree.tree_map(lambda a: a[:, k], frames_t))
        cases.append((k, post_j, post_t))
        state, table = post_j[0], post_j[1]
    torch.set_num_threads(n)
    return cases


@pytest.mark.parametrize("b", range(len(SEEDS)))
def test_vmapped_msckf_step_matches_jax_vmap(steps, b):
    for k, post_j, post_t in steps:
        where = f"frame {k} stream {b}"
        st_j, tb_j, d_j = jax.tree_util.tree_map(lambda a: a[b], post_j)
        st_t, tb_t, d_t = trun.record_at(post_t, b)
        for f in DIAG_FIELDS:
            assert int(getattr(d_t, f)) == int(getattr(d_j, f)), \
                f"{where} {f}"
        assert_state_close(st_t, st_j, atol=1e-4, cov_rel=1e-5, where=where,
                           cov_norm="inf")
        assert_table_equal(tb_t, tb_j, where=where)


def test_msckf_updates_engage(steps):
    used = sum(int(post_t[2].n_msckf.sum()) for _, _, post_t in steps)
    assert used > 0, "no MSCKF update in any stream"
    assert int(steps[-1][2][0].n_clones.min()) == 5
