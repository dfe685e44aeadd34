"""The port's checkpoints (`utils/checkpoint.py`) against the JAX package's.

Both packages flatten the filter's records into the same npz keys
(`state.{i}`, `table.{i}`, `extra.{k}`) in the same leaf order (the port's
records are pytrees of their fields in field order, as the JAX
NamedTuples are), so a checkpoint written by either loads into the other.
The state and table are the graft problem's (`__graft_entry__`'s sizes: 5
clones, 12 points, a 10 Hz camera) with 4 SLAM slots, stepped by the port
over 6 frames so that every kind of leaf is live (bool `clone_valid`,
int32 `head` and `slam_id`, scalars).  Leaves must come back equal, dtype
included.  Resuming a run from a checkpoint must give the uninterrupted
run bitwise, on the CPU.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_vins_tpu.core.layout import FilterConfig as JCfg
from open_vins_tpu.core.state import VioState as JState
from open_vins_tpu.core.state import init_state as jinit_state
from open_vins_tpu.models import feature_table as jft
from open_vins_tpu.utils import checkpoint as jckpt
from open_vins_tpu_torch.models import manager, runner
from open_vins_tpu_torch.parallel import dryrun
from open_vins_tpu_torch.utils import checkpoint as tckpt

SIZES = dict(max_clones=5, num_pts=12, map_size=128, max_slam=4, max_msckf=8,
             integration="analytical")
K_SAVE, K_END = 3, 6


@pytest.fixture(scope="module")
def problem():
    return dryrun.build_problem(**SIZES, device="cpu")


def step(problem, state, table, k0, k1):
    cfg, opts, _, _, run = problem
    for k in range(k0, k1):
        state, table, _ = manager.step_frame(state, table, cfg, opts,
                                             runner.frame_at(run.frames, k))
    return state, table


@pytest.fixture(scope="module")
def stepped(problem):
    _, _, state, table, _ = problem
    return step(problem, state, table, 0, K_END)


def jax_records(cfg, state, table):
    """The port's state and table as the JAX package's records."""
    st = JState(**{k: jnp.asarray(v.numpy()) for k, v in state.items()})
    tb = jft.FeatureTable(**{k: jnp.asarray(v.numpy())
                             for k, v in table.items()})
    return st, tb


def assert_leaves_equal(got, want):
    names = [f.name for f in dataclasses.fields(got)]
    assert names == list(want._fields)
    for k in names:
        a, b = getattr(got, k), np.asarray(getattr(want, k))
        assert a.numpy().dtype == b.dtype, k
        np.testing.assert_array_equal(a.numpy(), b, err_msg=k)


def test_stepped_state_is_live(stepped):
    state, table = stepped
    assert bool(state.clone_valid.any()) and int(state.head) >= 0
    assert bool(state.slam_valid.any()), "no landmark in the state"
    assert int((table.ids >= 0).sum()) > 0


def test_jax_checkpoint_loads_into_port(tmp_path, problem, stepped):
    cfg = problem[0]
    st_j, tb_j = jax_records(cfg, *stepped)
    path = str(tmp_path / "jax.npz")
    jckpt.save(path, st_j, tb_j, extra={"frame": np.int64(K_END)})
    _, _, state0, table0, _ = problem
    st, tb, extra = tckpt.load(path, state0, table0, device="cpu")
    assert_leaves_equal(st, st_j)
    assert_leaves_equal(tb, tb_j)
    assert int(extra["frame"]) == K_END


def test_port_checkpoint_loads_into_jax(tmp_path, problem, stepped):
    cfg = problem[0]
    state, table = stepped
    path = str(tmp_path / "port.npz")
    tckpt.save(path, state, table, extra={"frame": torch.tensor(K_END)})
    jcfg = JCfg(**cfg._asdict())
    st_j, tb_j, extra = jckpt.load(path, jinit_state(jcfg),
                                   jft.init_table(jcfg, table.ids.shape[0]))
    assert_leaves_equal(state, st_j)
    assert_leaves_equal(table, tb_j)
    assert int(extra["frame"]) == K_END
    with np.load(path) as z:
        assert sorted(z.files) == sorted(
            [f"state.{i}" for i in range(len(st_j))]
            + [f"table.{i}" for i in range(len(tb_j))] + ["extra.frame"])


def test_resume_is_bitwise(tmp_path, problem, stepped):
    """Step K_SAVE frames, save, load, step to K_END: the uninterrupted
    run exactly."""
    _, _, state0, table0, _ = problem
    st, tb = step(problem, state0, table0, 0, K_SAVE)
    path = str(tmp_path / "mid.npz")
    tckpt.save(path, st, tb)
    st, tb, _ = tckpt.load(path, state0, table0, device="cpu")
    st, tb = step(problem, st, tb, K_SAVE, K_END)
    for got, want in ((st, stepped[0]), (tb, stepped[1])):
        for k, v in want.items():
            assert torch.equal(getattr(got, k), v), k


def test_load_refuses_another_shape(tmp_path, problem, stepped):
    tckpt.save(str(tmp_path / "c.npz"), *stepped)
    cfg = problem[0]
    other = dryrun.build_problem(**dict(SIZES, max_slam=2), device="cpu")[2]
    with pytest.raises(ValueError, match="shape"):
        tckpt.load(str(tmp_path / "c.npz"), other, device="cpu")
    assert cfg.max_slam == 4
