"""Share of its roofline reached by the covariance downdate: the least
time one H100 needs for the profiled block's `symmetric_downdate` calls
(`vio_bench.roofline.downdate_work` at the cell's batched shape
[B, D, D] with K = PHt [B, D, m], m the update's column support) over the
device time of the kernels launched inside the custom op's profiler range
(`open_vins_tpu_torch::symmetric_downdate`), whatever kernel implements
it.  Nothing when the block launched no downdate or the trace attributes
no kernel to the op."""

from vio_bench import roofline

UNIT = "%"
LAYER = ("kernels (ops/kernels.symmetric_downdate -> "
         "ops/csrc/symmetric_downdate.cu)")
MOVES = "stream_frames_per_s"
OP = "::symmetric_downdate"


def read(run):
    t = run.trace
    dev_s = t.op_device_s.get(OP) if t else None
    if not dev_s or not run.downdate_calls:
        return None
    flops, nbytes = roofline.downdate_work(run.state_dim, run.update_cols,
                                           batch=run.n_streams)
    least, _ = roofline.bound_s(flops, nbytes)
    return 100.0 * run.downdate_calls * least / dev_s
