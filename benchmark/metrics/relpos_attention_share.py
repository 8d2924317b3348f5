"""Kernel 9's device time (relative-position attention, forward and
backward) as a share of the traced window, in %."""


def read(ctx):
    summary = ctx.get("trace")
    if summary is None or summary.window_s <= 0 or not ctx.get("attn_calls"):
        return None
    device = summary.kernel_time(("relpos_",))
    return 100.0 * device / summary.window_s if device > 0 else None
