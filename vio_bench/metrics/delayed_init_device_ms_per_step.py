"""Device milliseconds per traced step of delayed init
(`updater_slam.delayed_init`: triangulate the candidates, insert the new
landmarks into the covariance, stack their leftover rows): the device time
of the kernels launched inside the profiler ranges named
`ovt.step.delayed_init` (`trace.reduce`'s `op_device_s`, which counts the
kernels whose correlation ids fall inside the span, those of nested spans
included), over the profiled block's steps.  Kernels that overlap on the
device are each counted whole, so such sums run above the device's busy
time (about 8 % above it over a whole step of `msckf.mc`): a per-layer
reading, not a split of the step.  Nothing when the program has no such
span or the block launched nothing inside it."""

UNIT = "ms"
LAYER = ("frame step stage (models/manager: build_joint_system, "
         "joint_update)")
MOVES = "stream_frames_per_s"
OP = "ovt.step.delayed_init"


def read(run):
    t = run.trace
    dev_s = t.op_device_s.get(OP) if t else None
    return 1e3 * dev_s / t.steps if dev_s else None
