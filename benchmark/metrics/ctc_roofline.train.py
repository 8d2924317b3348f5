"""Kernels 4 and 5 (the CTC lattice forward and adjoint): their least
time at the window's shapes and lengths over their device time in the
trace, in %."""

from yardstick import roofline
from yardstick.trace import KERNELS


def read(ctx):
    summary, calls = ctx.get("trace"), ctx.get("ctc_calls")
    if summary is None or not calls:
        return None
    device = summary.kernel_time(KERNELS["ctc_alpha"] + KERNELS["ctc_adjoint"])
    if device <= 0:
        return None
    least = sum(roofline.ctc_alpha_launch(*c) + roofline.ctc_adjoint_launch(*c) for c in calls)
    return 100.0 * least / device
