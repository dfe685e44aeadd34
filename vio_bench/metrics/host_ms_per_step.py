"""Host wall time inside each window step's call into the program
(`runner.ensemble_step` on one frame of every stream), by the harness's
own clock with no synchronize: dispatch, plus any blocking on a full launch
queue.  Mean over the traced run's window steps outside the profiled
block."""

UNIT = "ms"
LAYER = "runner (models/runner.ensemble_step, ensemble_start)"
MOVES = "stream_frames_per_s"


def read(run):
    steps = run.host_step_s_unprofiled
    return 1e3 * sum(steps) / len(steps) if steps else None
