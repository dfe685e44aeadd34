"""Share of the profiled block's wall time (its first step call to its
last kernel's end) in which no kernel ran on the device."""

UNIT = "%"
LAYER = "device (one H100 SXM)"
MOVES = "stream_frames_per_s"


def read(run):
    t = run.trace
    if not t or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
