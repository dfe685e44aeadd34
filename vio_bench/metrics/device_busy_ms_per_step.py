"""Device busy time per batched frame: the union of the kernel spans in
the profiled block of window steps over its steps."""

UNIT = "ms"
LAYER = ("estimator modules (models/propagator, feature_table, "
         "triangulation, updater_slam, update_helper, core/ekf)")
MOVES = "stream_frames_per_s"


def read(run):
    t = run.trace
    return 1e3 * t.busy_s / t.steps if t and t.busy_s > 0 else None
