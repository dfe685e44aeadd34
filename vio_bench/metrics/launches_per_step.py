"""CUDA kernels launched per batched frame (one frame of every stream),
counted in the profiled block of window steps."""

UNIT = "launches"
LAYER = "frame step (models/manager.step_frame)"
MOVES = "stream_frames_per_s"


def read(run):
    t = run.trace
    return t.kernels / t.steps if t else None
