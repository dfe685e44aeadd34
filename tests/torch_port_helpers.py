"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py):
hand JAX pytrees to the port as numpy arrays and compare the results."""

from __future__ import annotations

import json
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from open_vins_tpu_torch import convert

CPU = "cpu"
FIXTURE = (Path(__file__).resolve().parents[1] / "open_vins_tpu_torch"
           / "data" / "msckf_sim20_seed0.npz")


def tree_to_numpy(nt) -> dict:
    """A JAX NamedTuple of arrays as a dict of numpy arrays."""
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def jax_state_to_port(st):
    return convert.state_from_numpy(tree_to_numpy(st), CPU)


def jax_table_to_port(tb):
    return convert.table_from_numpy(tree_to_numpy(tb), CPU)


def jax_frames_to_port(fr):
    """One JAX FrameInput (or a batch of them) as a port FrameInput."""
    arrays = {f"win_{k}": np.asarray(v) for k, v in fr.win._asdict().items()}
    arrays.update({k: np.asarray(getattr(fr, k))
                   for k in ("t_new", "ids", "uv", "uvn", "mask")})
    return convert.frames_from_numpy(arrays, CPU)


def t(a, dtype=torch.float32):
    """numpy/JAX array -> CPU torch tensor (float32 unless told)."""
    return torch.as_tensor(np.array(a), dtype=dtype)


def np_of(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


STATE_VALUE_FIELDS = ("q", "p", "v", "bg", "ba", "clones_q", "clones_p",
                      "clones_q_fej", "clones_p_fej", "calib_ext_q",
                      "calib_ext_p", "calib_intr")
STATE_EXACT_FIELDS = ("clone_valid", "head", "n_clones", "clone_t")


def assert_state_close(port_st, jax_st, atol=1e-4, cov_rel=1e-5, where="",
                       cov_norm="max"):
    """Values within `atol`, bookkeeping exact, covariance within
    cov_rel·‖P‖ of the JAX covariance: ‖P‖ is max|P_ij| (`cov_norm="max"`)
    or the row-sum norm ‖P‖∞ (`cov_norm="inf"`)."""
    for k in STATE_VALUE_FIELDS:
        np.testing.assert_allclose(np_of(getattr(port_st, k)),
                                   np.asarray(getattr(jax_st, k)),
                                   atol=atol, rtol=0, err_msg=f"{where} {k}")
    for k in STATE_EXACT_FIELDS:
        np.testing.assert_array_equal(np_of(getattr(port_st, k)),
                                      np.asarray(getattr(jax_st, k)),
                                      err_msg=f"{where} {k}")
    cov_j = np.asarray(jax_st.cov)
    norm = {"max": np.abs(cov_j).max(), "inf": np.abs(cov_j).sum(1).max()}
    scale = max(norm[cov_norm], 1e-30)
    np.testing.assert_allclose(np_of(port_st.cov), cov_j,
                               atol=cov_rel * scale, rtol=0,
                               err_msg=f"{where} cov")


def assert_table_equal(port_tb, jax_tb, where=""):
    for k in ("ids", "mbits", "seen"):
        np.testing.assert_array_equal(np_of(getattr(port_tb, k)),
                                      np.asarray(getattr(jax_tb, k)),
                                      err_msg=f"{where} table.{k}")
    for k in ("uv", "uvn"):
        np.testing.assert_allclose(np_of(getattr(port_tb, k)),
                                   np.asarray(getattr(jax_tb, k)),
                                   atol=1e-5, rtol=0,
                                   err_msg=f"{where} table.{k}")


class Problem(NamedTuple):
    """A filter problem for both packages: the JAX start state and table,
    the JAX frames (batched over frames), and each package's filter
    configuration and triangulation options."""

    state: object
    table: object
    frames: object
    cfg_jax: object
    cfg_port: object
    tri_jax: object
    tri_port: object


def graft_problem() -> Problem:
    """`__graft_entry__._build_problem()`: 5 clones, 12 points, a 10 Hz
    camera for 1 s (9 frames), max_slam=0, rk4, two Gauss-Newton runs."""
    import __graft_entry__
    from open_vins_tpu.core.layout import FilterConfig as JCfg
    from open_vins_tpu.models import runner as jrun
    from open_vins_tpu.models import triangulation as jtri
    from open_vins_tpu.sim import simulator
    from open_vins_tpu_torch.core.layout import FilterConfig as TCfg
    from open_vins_tpu_torch.models import triangulation as ttri

    _, (state, table, frame0) = __graft_entry__._build_problem()
    params = simulator.SimParams(imu_rate=100.0, cam_rate=10.0, num_cams=1,
                                 num_pts=12, map_size=128, duration=1.0)
    run = jrun.stage_run(simulator.build(params, seed=0), params)
    np.testing.assert_array_equal(np.asarray(run.frames.uv[0]),
                                  np.asarray(frame0.uv))
    kw = dict(max_clones=5, max_slam=0, num_cams=1, max_msckf_in_update=8,
              integration="rk4")
    return Problem(state, table, run.frames, JCfg(**kw), TCfg(**kw),
                   jtri.TriangulationOptions(max_runs=2),
                   ttri.TriangulationOptions(max_runs=2))


def fixture_problem() -> Problem:
    """The staged reference-width run of FIXTURE from its groundtruth start
    (11 clones, 200 points, <= 40 MSCKF features, max_tracks 384)."""
    import jax
    import jax.numpy as jnp

    from open_vins_tpu.core.layout import FilterConfig as JCfg
    from open_vins_tpu.models import manager as jman
    from open_vins_tpu.models import triangulation as jtri
    from open_vins_tpu.models.propagator import ImuWindow
    from open_vins_tpu.ops import lie as jlie
    from open_vins_tpu_torch.core.layout import FilterConfig as TCfg
    from open_vins_tpu_torch.models import triangulation as ttri

    with np.load(FIXTURE) as npz:
        z = {k: npz[k] for k in npz.files}
    meta = json.loads(str(z["meta"]))
    jc = JCfg(**meta["cfg"])
    state = jman.initialize_from_gt(
        jc, jnp.asarray(z["gt_q"][0]), jnp.asarray(z["gt_p"][0]),
        jnp.asarray(z["gt_v"][0]), jnp.asarray(z["bias_g0"]),
        jnp.asarray(z["bias_a0"]), 0.0,
        jax.vmap(jlie.rot_2_quat)(jnp.asarray(z["cam_R_ItoC"])),
        jnp.asarray(z["cam_p_IinC"]), jnp.asarray(z["cam_intr"]))
    frames = jman.FrameInput(
        win=ImuWindow(t=z["win_t"], w=z["win_w"], a=z["win_a"]),
        t_new=z["t_new"], ids=z["ids"], uv=z["uv"], uvn=z["uvn"],
        mask=z["mask"])
    return Problem(state, jman.ft.init_table(jc, meta["max_tracks"]), frames,
                   jc, TCfg(**meta["cfg"]), jtri.TriangulationOptions(),
                   ttri.TriangulationOptions())
