"""Kernels 2 and 3 (the biLSTM train forward and backward): their least
time at the window's shapes and lengths over their device time in the
trace, in %."""

from yardstick import roofline
from yardstick.trace import KERNELS


def read(ctx):
    summary, calls = ctx.get("trace"), ctx.get("lstm_calls")
    if summary is None or not calls:
        return None
    device = summary.kernel_time(KERNELS["bilstm_recurrence"] + KERNELS["bilstm_train_bwd"])
    if device <= 0:
        return None
    least = sum(roofline.bilstm_train_fwd_launch(*c) + roofline.bilstm_train_bwd_launches(*c)
                for c in calls)
    return 100.0 * least / device
