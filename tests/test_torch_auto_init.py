"""The port's routed initialization on the V1_02 replay against the JAX
package: `runner.auto_init_state` (examples/run_benchmark_suite.py:126-230
of the reference) on the port's CPU staging of the replay of
tests/test_corpus_replay.py (the in-repo
`results/suite/truths/V1_02_medium.txt`, 40 s), against JAX's
`auto_init_state` on the same staging, committed with every routed attempt
in `open_vins_tpu_torch/data/v102_autoinit_seed0_ref.npz` (``python
tests/test_torch_fixture.py --write-autoinit-ref``).

* The route, the first frame to process k0, the init time and the number
  of attempts equal JAX's; the dynamic problem the attempt assembled is
  JAX's, array for array; the port's `initialize` on JAX's problem, and the
  state the port starts from, within test_torch_dynamic_init.py's TOL;
  tests/test_corpus_replay.py:133-143's gates (gravity direction < 1°,
  |v| error < 0.1 m/s).
* `background.catch_up` from JAX's init state over the next camera times
  against JAX's: the step rule, 1e-5·‖P‖∞.
* slow: `runner.run_filter_from` from the port's own init over the whole
  replay: posyaw ATE < 0.08 m and < 1.5°, within 0.01 m of JAX's run from
  JAX's init, the aligned NEES in 0.5-30 (chip_smoke.init_replay_metrics),
  more than 10 landmarks over the last three quarters.
"""

import os

import numpy as np
import pytest
import torch

from open_vins_tpu_torch import convert
from open_vins_tpu_torch.core.layout import FilterConfig
from open_vins_tpu_torch.init import background
from open_vins_tpu_torch.models import runner
from open_vins_tpu_torch.models import triangulation as tri
from open_vins_tpu_torch.ops import lie
from test_torch_dynamic_init import TOL, _result_gaps

REF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "open_vins_tpu_torch", "data", "v102_autoinit_seed0_ref.npz")


def _prefixed(z, prefix):
    return {k[len(prefix):]: z[k] for k in z.files if k.startswith(prefix)}


@pytest.fixture(scope="module")
def ref():
    with np.load(REF) as z:
        out = {k: z[k] for k in z.files}
        out["state0"] = _prefixed(z, "state0_")
        out["dyn_in"] = _prefixed(z, "dyn_in_")
        out["dyn_res"] = _prefixed(z, "dyn_res_")
        out["catchup"] = _prefixed(z, "catchup_")
    out["meta"] = convert.load_reference(REF)["meta"]
    return out


@pytest.fixture(scope="module")
def staged(ref):
    sim, params, run = convert.stage_stream(ref["meta"], "cpu")
    return sim, params, run, FilterConfig(**ref["meta"]["cfg"])


@pytest.fixture(scope="module")
def auto(ref, staged):
    """The port's auto_init_state on the CPU staging, with its attempts."""
    sim, params, run, cfg = staged
    attempts = []
    out = runner.auto_init_state(run, runner.sim_calib(sim), cfg, params,
                                 max_search_s=ref["meta"]["max_search_s"],
                                 device="cpu", attempts=attempts)
    assert out is not None, "the port did not initialize"
    return out, attempts


def test_route_and_frame_equal_jax(ref, auto):
    (st0, k0, kind, t_init), attempts = auto
    assert kind == str(ref["ref_kind"]) == "dynamic"
    assert k0 == int(ref["ref_k0"])
    assert t_init == float(ref["ref_t_init"])
    assert len(attempts) == int(ref["ref_attempts"])
    assert float(st0.t) == np.float32(t_init)


def test_dynamic_problem_equals_jax(ref, staged):
    """The attempt's problem at JAX's k0, rebuilt by the port from the same
    track history and IMU stream: every array equal."""
    from open_vins_tpu_torch.init import router

    sim, params, run, cfg = staged
    seen = {}

    def capture(*args, dyn_input=None, **kw):
        seen["inp"] = dyn_input
        return "none", None

    real = router.try_initialize
    router.try_initialize = capture
    try:
        runner.auto_init_state(run, runner.sim_calib(sim), cfg, params,
                               max_search_s=float(ref["ref_t_init"]),
                               device="cpu")
    finally:
        router.try_initialize = real
    got = convert.dyn_input_to_numpy(seen["inp"])
    for k, v in ref["dyn_in"].items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_initialize_on_jax_problem_matches_jax(ref):
    """The port's `initialize` on JAX's recorded problem: success, and the
    outputs within test_torch_dynamic_init.py's TOL."""
    from open_vins_tpu_torch.init import dynamic_init

    got = convert.dyn_result_to_numpy(dynamic_init.initialize(
        convert.dyn_input_from_numpy(ref["dyn_in"], "cpu"),
        dynamic_init.DynamicInitOptions()))
    assert bool(got["success"]) and bool(ref["dyn_res"]["success"])
    gaps = _result_gaps(got, ref["dyn_res"])
    assert all(gaps[k] <= TOL[k] for k in TOL), gaps


def test_init_state_matches_jax_and_truth(ref, staged, auto):
    """The state the replay starts from: the IMU mean and its 15×15 block
    within TOL of JAX's, and tests/test_corpus_replay.py's gates."""
    sim, params, run, cfg = staged
    (st0, k0, _, _), _ = auto
    want = ref["state0"]
    got = convert.state_to_numpy(st0)
    gaps = _result_gaps(
        {"q_GtoI": got["q"], "p": got["p"], "v": got["v"], "bg": got["bg"],
         "ba": got["ba"], "cov15": got["cov"][:15, :15]},
        {"q_GtoI": want["q"], "p": want["p"], "v": want["v"],
         "bg": want["bg"], "ba": want["ba"], "cov15": want["cov"][:15, :15]})
    assert all(gaps[k] <= TOL[k] for k in TOL), gaps
    np.testing.assert_array_equal(got["cov"][15:], want["cov"][15:])
    ez = torch.tensor([0.0, 0.0, 1.0])
    g_i = lie.quat_2_rot(st0.q) @ ez
    g_t = lie.quat_2_rot(run.gt_q[k0]) @ ez
    ang = float(torch.rad2deg(torch.arccos(torch.clamp(g_i @ g_t, -1, 1))))
    assert ang < 1.0, f"init gravity-direction error {ang:.2f} deg"
    v_err = abs(float(st0.v.norm()) - float(run.gt_v[k0].norm()))
    assert v_err < 0.1, f"init |v| error {v_err:.3f} m/s"


def test_catch_up_matches_jax(ref, staged):
    """catch_up over the camera times queued behind the attempt, from JAX's
    init state: the step rule (1e-5·‖P‖∞), values within 1e-4."""
    sim, params, run, cfg = staged
    make_window = runner.window_packer(*runner.imu_stream(run))
    st0 = convert.state_from_numpy(ref["state0"], "cpu")
    got = convert.state_to_numpy(background.catch_up(
        st0, cfg, [float(x) for x in ref["ref_catchup_t"]], make_window,
        params.imu_rate))
    want = ref["catchup"]
    assert int(got["n_clones"]) == int(want["n_clones"]) > 0
    for k in ("q", "p", "v", "clones_q", "clones_p", "clone_t"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4,
                                   err_msg=k)
    for k in ("clone_valid", "head", "n_clones"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    norm = np.abs(want["cov"]).sum(1).max()
    np.testing.assert_allclose(got["cov"], want["cov"], rtol=0,
                               atol=1e-5 * norm)


@pytest.mark.slow
def test_replay_from_own_init(ref, staged, auto):
    """The whole replay from the port's own init (about a minute on a
    CPU)."""
    from chip_smoke import init_replay_metrics

    sim, params, run, cfg = staged
    (st0, k0, _, _), _ = auto
    diags = []
    st, outs = runner.run_filter_from(cfg, tri.TriangulationOptions(), run,
                                      st0, k0, ref["meta"]["max_tracks"],
                                      device="cpu", diags=diags)
    assert torch.isfinite(st.cov).all()
    ate_p, ate_o, nees = init_replay_metrics(outs[0], outs[1], outs[3],
                                             run.gt_q, run.gt_p, k0)
    n_slam = np.array([int(d.n_slam) for d in diags])
    assert ate_p < 0.08 and ate_o < 1.5, (ate_p, ate_o)
    assert abs(ate_p - float(ref["ref_ate_pos_m"])) <= 0.01, ate_p
    assert 0.5 < nees < 30.0, nees
    assert n_slam[len(n_slam) // 4:].mean() > 10
