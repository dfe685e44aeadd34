"""The port's sliding-window BA refinement (`parallel/window_refine.py`)
against the JAX package's, on a live filter state.

The state and table are JAX's operating point (bench.py:94-96: 11 clones,
50 SLAM landmarks, ACI², the joint "qr" update, 384 tracks) after 30 of the
committed fixture's frames, with the window full, committed with JAX's
`refine_window` outputs on them as
`open_vins_tpu_torch/data/window_refine_oppoint30_ref.npz` (written by
``PYTHONPATH=.:tests python tests/test_torch_window_refine.py
--write-ref``, JAX on the CPU,
about a minute).  Both packages take the same state and table:

(a) the landmark rows: the 64 rows with the most observations.  The scores
    are observation counts and tie as a rule; JAX's `lax.top_k` takes the
    lower row among equal scores, and so must the port (a stable
    descending sort; `torch.topk` picks other rows among ties).  Equal
    exactly, on the live table and on tables made of ties;
(b) `ok` (triangulated, finite, more than two observations): equal;
(c) the refined window poses and landmarks and the RMS before and after
    against JAX's run on the same inputs, live and as committed, and the
    RMS after at most the RMS before.  Three Gauss-Newton steps from a
    filter state reproduce in f32 only to the reach of a gauge held by the
    pose damping alone (tests/test_torch_distributed_ba.py): on this input
    JAX's own jitted and eager runs differ by 8.7e-4 in R, 4.2e-4 in p and
    1.7e-3 in the landmarks, and JAX's eager run lies 5.4e-4, 1.7e-4 and
    1.0e-3 from the port's f64 run (measured on the CPU).  So R is held to
    1e-3, p to 5e-4, the landmarks to 2e-3 and the RMS (2.5e-3) to 2e-8;
    and, sharper, the port's f32 answer must lie no farther from its f64
    answer than 1.5 times JAX's eager one does.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_vins_tpu_torch import convert
from open_vins_tpu_torch.core.layout import FilterConfig as TCfg
from open_vins_tpu_torch.models import feature_table as tft
from open_vins_tpu_torch.models import manager as tman
from open_vins_tpu_torch.models import triangulation as ttri
from open_vins_tpu_torch.parallel import distributed_ba as dba
from open_vins_tpu_torch.parallel import window_refine as twr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(ROOT, "open_vins_tpu_torch", "data",
                   "window_refine_oppoint30_ref.npz")
N_FRAMES = 30
MAX_LANDMARKS = 64
ITERS = 3
TOL = {"R": 1e-3, "p": 5e-4, "landmarks": 2e-3, "rms_before": 2e-8,
       "rms_after": 2e-8}
OUTPUTS = ("R", "p", "landmarks", "rms_before", "rms_after")


def load_ref(path=REF):
    """(meta, state arrays, table arrays, JAX outputs {rows, ok, OUTPUTS})."""
    with np.load(path) as z:
        meta = json.loads(str(z["meta"]))
        state = {k[6:]: z[k] for k in z.files if k.startswith("state_")}
        table = {k[6:]: z[k] for k in z.files if k.startswith("table_")}
        ref = {k[4:]: z[k] for k in z.files if k.startswith("ref_")}
    return meta, state, table, ref


def jax_refine(cfg_kw, state, table):
    """JAX's rows, ok and refine_window outputs on the given arrays."""
    from open_vins_tpu.core.layout import FilterConfig
    from open_vins_tpu.core.state import VioState
    from open_vins_tpu.models import feature_table as ft
    from open_vins_tpu.models import manager
    from open_vins_tpu.models import triangulation as tri
    from open_vins_tpu.parallel import window_refine as wr

    cfg = FilterConfig(**cfg_kw)
    st = VioState(**{k: jnp.asarray(v) for k, v in state.items()})
    tb = ft.FeatureTable(**{k: jnp.asarray(v) for k, v in table.items()})
    opts = tri.TriangulationOptions()
    score = jnp.where(tb.ids >= 0, ft.row_obs_counts(tb).astype(jnp.float32),
                      -1.0)
    _, rows = jax.lax.top_k(score, MAX_LANDMARKS)
    _, ok = wr.build_problem(st, cfg, tb, opts, MAX_LANDMARKS,
                             manager.gather_feature_obs)
    outs = wr.refine_window(st, cfg, tb, opts, manager.gather_feature_obs,
                            max_landmarks=MAX_LANDMARKS, iters=ITERS)
    got = {"rows": np.asarray(rows), "ok": np.asarray(ok)}
    got.update({k: np.asarray(v) for k, v in zip(OUTPUTS, outs)})
    return got


@pytest.fixture(scope="module")
def committed():
    return load_ref()


@pytest.fixture(scope="module")
def port_outputs(committed):
    meta, state, table, _ = committed
    cfg = TCfg(**meta["cfg"])
    st = convert.state_from_numpy(state, "cpu")
    tb = convert.table_from_numpy(table, "cpu")
    rows, _ = twr.select_rows(tb, MAX_LANDMARKS)
    prob, ok = twr.build_problem(st, cfg, tb, ttri.TriangulationOptions(),
                                 MAX_LANDMARKS, tman.gather_feature_obs)
    outs = twr.refine_window(st, cfg, tb, ttri.TriangulationOptions(),
                             tman.gather_feature_obs,
                             max_landmarks=MAX_LANDMARKS, iters=ITERS,
                             device="cpu")
    got = {"rows": rows.numpy(), "ok": ok.numpy()}
    got.update({k: v.numpy() for k, v in zip(OUTPUTS, outs)})
    # the same problem refined in f64
    prob64 = dba.BAProblem(**{k: v.double() if v.is_floating_point() else v
                              for k, v in prob.items()})
    refined, _ = dba.refine(prob64, iters=ITERS)
    got["f64"] = {"R": refined.R.numpy(), "p": refined.p.numpy(),
                  "landmarks": refined.landmarks.numpy()}
    return got


@pytest.fixture(scope="module")
def jax_live(committed):
    meta, state, table, _ = committed
    return jax_refine(meta["cfg"], state, table)


def test_committed_state_has_ties(committed):
    """The committed table is the case at stake: a full window with many
    rows of equal observation count across the cut at 64."""
    meta, state, table, ref = committed
    assert int(state["n_clones"]) == meta["cfg"]["max_clones"]
    tb = convert.table_from_numpy(table, "cpu")
    counts = tft.row_obs_counts(tb)[tb.ids >= 0]
    cut = torch.sort(counts.float(), descending=True).values[MAX_LANDMARKS - 1]
    assert int((counts == cut).sum()) > 1
    assert int(ref["ok"].sum()) >= MAX_LANDMARKS // 2


@pytest.mark.parametrize("source", ["live", "committed"])
def test_rows_and_ok_match_jax(port_outputs, jax_live, committed, source):
    want = jax_live if source == "live" else committed[3]
    np.testing.assert_array_equal(port_outputs["rows"], want["rows"])
    np.testing.assert_array_equal(port_outputs["ok"], want["ok"])


@pytest.mark.parametrize("source", ["live", "committed"])
def test_refined_window_matches_jax(port_outputs, jax_live, committed,
                                    source):
    want = jax_live if source == "live" else committed[3]
    for k in OUTPUTS:
        np.testing.assert_allclose(port_outputs[k], want[k], atol=TOL[k],
                                   rtol=0, err_msg=k)
    assert port_outputs["rms_after"] <= port_outputs["rms_before"]


@pytest.mark.parametrize("key", ["R", "p", "landmarks"])
def test_refined_window_as_close_to_f64_as_jax(port_outputs, committed, key):
    want = committed[3][key]
    f64 = port_outputs["f64"][key]
    port_gap = np.abs(port_outputs[key] - f64).max()
    jax_gap = np.abs(want - f64).max()
    assert port_gap <= 1.5 * jax_gap, (port_gap, jax_gap)


@pytest.mark.parametrize("pattern", ["all_equal", "blocks", "random"])
def test_select_rows_breaks_ties_as_top_k(pattern):
    """Tied scores (64 of 240 rows in the live case): the port's rows are
    `lax.top_k`'s, which `torch.topk` does not promise."""
    T, C = 240, 11
    rng = np.random.default_rng(7)
    if pattern == "all_equal":
        counts = np.full(T, 5)
    elif pattern == "blocks":
        counts = np.repeat([3, 7, 7, 2, 9, 7], T // 6)
    else:
        counts = rng.integers(0, 4, size=T)
    ids = np.where(rng.random(T) < 0.9, np.arange(T), -1).astype(np.int32)
    mbits = ((1 << counts.astype(np.int64)) - 1).astype(np.int32)[:, None]
    tb = tft.FeatureTable(
        ids=torch.as_tensor(ids), uv=torch.zeros(T, C, 1, 2),
        uvn=torch.zeros(T, C, 1, 2), mbits=torch.as_tensor(mbits),
        seen=torch.zeros(T, dtype=torch.bool))
    rows, score = twr.select_rows(tb, MAX_LANDMARKS)
    score_j = np.where(ids >= 0, counts.astype(np.float32), -1.0)
    _, rows_j = jax.lax.top_k(jnp.asarray(score_j), MAX_LANDMARKS)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(rows_j))
    np.testing.assert_array_equal(score.numpy(), score_j)


def write_reference(path=REF):
    """JAX's operating point over the fixture's first 30 frames, then JAX's
    refine_window on the state and table; saved with both."""
    import open_vins_tpu  # noqa: F401
    from open_vins_tpu.core.layout import FilterConfig
    from open_vins_tpu.models import feature_table as ft
    from open_vins_tpu.models import manager
    from open_vins_tpu.models import triangulation as tri
    from open_vins_tpu.models.propagator import ImuWindow
    from open_vins_tpu.ops import lie
    from test_torch_fixture import FIXTURE, MAX_TRACKS, OPPOINT_CFG

    with np.load(FIXTURE) as z:
        a = {k: z[k] for k in z.files}
    cfg = FilterConfig(**OPPOINT_CFG)
    opts = tri.TriangulationOptions()
    state = manager.initialize_from_gt(
        cfg, a["gt_q"][0], a["gt_p"][0], a["gt_v"][0], a["bias_g0"],
        a["bias_a0"], jnp.asarray(0.0),
        calib_ext_q=jax.vmap(lie.rot_2_quat)(jnp.asarray(a["cam_R_ItoC"])),
        calib_ext_p=a["cam_p_IinC"], calib_intr=a["cam_intr"])
    table = ft.init_table(cfg, MAX_TRACKS)
    step = jax.jit(lambda s, t, f: manager.step_frame(s, t, cfg, opts, f))
    for k in range(N_FRAMES):
        frame = manager.FrameInput(
            win=ImuWindow(t=a["win_t"][k], w=a["win_w"][k], a=a["win_a"][k]),
            t_new=a["t_new"][k], ids=a["ids"][k], uv=a["uv"][k],
            uvn=a["uvn"][k], mask=a["mask"][k])
        state, table, _ = step(state, table, frame)
    st = {k: np.asarray(v) for k, v in state._asdict().items()}
    tb = {k: np.asarray(v) for k, v in table._asdict().items()}
    ref = jax_refine(OPPOINT_CFG, st, tb)
    meta = {"frames": os.path.basename(FIXTURE), "n_frames": N_FRAMES,
            "cfg": OPPOINT_CFG, "max_tracks": MAX_TRACKS,
            "max_landmarks": MAX_LANDMARKS, "iters": ITERS,
            "tri_opts": "TriangulationOptions()"}
    np.savez_compressed(
        path, **{f"state_{k}": v for k, v in st.items()},
        **{f"table_{k}": v for k, v in tb.items()},
        **{f"ref_{k}": v for k, v in ref.items()},
        meta=np.asarray(json.dumps(meta)))
    print(json.dumps({"path": path, "bytes": os.path.getsize(path),
                      "ok": int(ref["ok"].sum()),
                      "rms_before": float(ref["rms_before"]),
                      "rms_after": float(ref["rms_after"])}))


if __name__ == "__main__":
    if "--write-ref" in sys.argv:
        jax.config.update("jax_platforms", "cpu")
        sys.path.insert(0, ROOT)
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        write_reference()
    else:
        print(__doc__)
