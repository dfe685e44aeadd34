"""The harness on the CPU: a cell added by new files alone runs at two
streams and prints its result line; with the timed path broken underneath
(a step that returns its state unchanged, half of the streams left
unstepped, an answer altered where it is produced, a value carried to the
next steps altered where it is produced) `correct` comes out false.  On a card, the control (TF32 products) comes out not correct at
the cell's own size.

    python -m pytest --noconftest vio_bench/tests -q          # CPU
    python -m pytest --noconftest vio_bench/tests -q -m cuda  # the card
"""

import json
import time

import pytest
import torch

from vio_bench import harness
from vio_bench.program import Program
from vio_bench.tests.tiny import CELL, make_tree

KEYS = ["correct", "attempted", "failed", "metrics", "device", "check"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The MSCKF-only filter on a 0.6 s stream (11 frames), two streams."""
    return make_tree(tmp_path_factory.mktemp("bench"), 0.6)


def _run(root, seconds=3, traced=False):
    return harness.run_cell(root, CELL, 2 ** 31 + 3, seconds, traced,
                            torch.device("cpu"), time.perf_counter())


def test_new_cell_runs_and_prints_its_line(tree, capsys):
    res = _run(tree)
    harness.emit(res)
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(out) == KEYS
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 2 * 10  # the 9-frame pass restarted
    assert {"stream_frames_per_s", "setup_s"} <= set(out["metrics"])
    for name, c in out["check"].items():
        assert c["value"] <= c["limit"], name


def test_traced_run_reads_host_metrics(tree):
    res = _run(tree, seconds=4, traced=True)
    assert res["correct"] is True
    assert {"host_ms_per_step", "ensemble_start_s"} <= set(res["metrics"])


def _frozen(step):
    def run(self, state, table, runs, k):
        _, _, diag = step(self, state, table, runs, k)
        return state, table, diag
    return run


def _half(step):
    def run(self, state, table, runs, k):
        st, tb, diag = step(self, state, table, runs, k)
        h = st.cov.shape[0] // 2

        def mix(new, old):
            return type(new)(**{f: torch.cat([v[:h], getattr(old, f)[h:]])
                                for f, v in new.items()})
        return mix(st, state), mix(tb, table), diag
    return run


def _altered(step):
    def run(self, state, table, runs, k):
        st, tb, diag = step(self, state, table, runs, k)
        return st.replace(p=st.p + 1e-3), tb, diag
    return run


def _carried(step):
    """A value that the next steps read, and no step's output shows,
    altered where it is produced: the clone poses, 1 cm off."""
    def run(self, state, table, runs, k):
        st, tb, diag = step(self, state, table, runs, k)
        return st.replace(clones_p=st.clones_p + 1e-2), tb, diag
    return run


@pytest.mark.parametrize("fault", [_frozen, _half, _altered, _carried])
def test_broken_step_is_not_correct(tree, monkeypatch, fault):
    monkeypatch.setattr(Program, "step", fault(Program.step))
    assert _run(tree)["correct"] is False


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["msckf.mc"])
def test_control_is_not_correct(workload):
    """The program with TF32 products, at the cell's own size, on three
    seeds: none correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs at the cell's "
                    "size on the card")
    from vio_bench import control

    runs = control.readings(workload, [101, 102, 103], 8, "tf32",
                            torch.device("cuda", 0))
    assert [r["correct"] for _, r in runs] == [False] * 3
