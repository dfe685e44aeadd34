"""The system under test, as the benchmark drives it: the only module of
the benchmark that imports the program (`open_vins_tpu_torch`).

It hands the generator's streams to the program as its own records
(`runner.SimRun`, `runner.SimCalib`, `manager.FrameInput`), starts every
stream from its groundtruth (`runner.ensemble_start`), steps all streams
at once (`runner.ensemble_step`: `manager.step_frame` under
`torch.func.vmap`), and takes from the program only its outputs, its state
at sampled frames (for the stepwise reference) and the launch counter of
its hand-written downdate.
"""

from __future__ import annotations

from open_vins_tpu_torch.core.layout import FilterConfig
from open_vins_tpu_torch.models import manager, runner
from open_vins_tpu_torch.models import triangulation as tri
from open_vins_tpu_torch.models.propagator import ImuWindow
from open_vins_tpu_torch.ops import kernels


def filter_config(config: dict) -> FilterConfig:
    return FilterConfig(**config["filter"])


class Program:
    """One configuration of the filter, stepping B streams."""

    def __init__(self, config: dict):
        self.cfg = filter_config(config)
        self.tri = tri.TriangulationOptions(**config.get("triangulation", {}))
        self.max_tracks = int(config["max_tracks"])
        self._step = runner.ensemble_step(self.cfg, self.tri)

    @staticmethod
    def records(streams):
        """(calibs, runs) of the streams, as `runner.stage_ensemble` would
        stack them."""
        frames = manager.FrameInput(
            win=ImuWindow(t=streams.win_t, w=streams.win_w, a=streams.win_a),
            t_new=streams.t_new, ids=streams.ids, uv=streams.uv,
            uvn=streams.uvn, mask=streams.mask)
        runs = runner.SimRun(frames=frames, gt_q=streams.gt_q,
                             gt_p=streams.gt_p, gt_v=streams.gt_v)
        calibs = runner.SimCalib(
            bias_g0=streams.bias_g0, bias_a0=streams.bias_a0,
            cam_R_ItoC=streams.cam_R_ItoC, cam_p_IinC=streams.cam_p_IinC,
            cam_intr=streams.cam_intr)
        return calibs, runs

    def start(self, calibs, runs):
        """(state, table) of every stream at frame 0."""
        return runner.ensemble_start(self.cfg, calibs, runs, self.max_tracks)

    def step(self, state, table, runs, k: int):
        """Frame k of every stream: (state, table, diag)."""
        return self._step(state, table, runner.ensemble_frame(runs, k))

    @staticmethod
    def outputs(state, diag):
        """The kept per-frame outputs (`runner._per_frame`), the pose
        covariance copied out of P: (q, p, v, cov6, n_msckf,
        n_slam_used)."""
        q, p, v, cov6, d = runner._per_frame(state, diag)
        return q, p, v, cov6.contiguous(), d.n_msckf, d.n_slam_used

    @staticmethod
    def snapshot(state, table, idx):
        """Streams `idx` of (state, table), copied on the device: plain
        dicts of field name -> tensor."""
        return ({k: v.index_select(0, idx) for k, v in state.items()},
                {k: v.index_select(0, idx) for k, v in table.items()})

    @staticmethod
    def copy(record):
        """A device copy of a (nested) record."""
        return type(record)(**{k: v.clone() for k, v in record.items()})

    @staticmethod
    def downdate_launches() -> int:
        return kernels.symmetric_downdate.launches
