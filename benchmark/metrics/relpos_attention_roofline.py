"""Kernel 9 (relative-position attention, forward and backward): its
least time at the window's shapes and lengths (``yardstick/conformer_counts.py``)
over its device time in the trace, in %."""

from yardstick import conformer_counts

KERNEL = ("relpos_",)  # relpos_fwd_kernel, relpos_dkdv_kernel, relpos_dq_kernel


def read(ctx):
    summary, calls = ctx.get("trace"), ctx.get("attn_calls")
    if summary is None or not calls:
        return None
    device = summary.kernel_time(KERNEL)
    if device <= 0:
        return None
    return 100.0 * sum(conformer_counts.attention_least_s(*c) for c in calls) / device
