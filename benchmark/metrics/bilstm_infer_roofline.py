"""Kernel 1 (the biLSTM inference recurrence, one launch a layer a
batch): its least time at the served batches' shapes and lengths over its
device time in the trace, in %."""

from yardstick import roofline
from yardstick.trace import KERNELS


def read(ctx):
    summary, calls = ctx.get("trace"), ctx.get("infer_calls")
    if summary is None or not calls:
        return None
    device = summary.kernel_time(KERNELS["bilstm_recurrence"])
    if device <= 0:
        return None
    return 100.0 * sum(roofline.bilstm_infer_launch(*c) for c in calls) / device
