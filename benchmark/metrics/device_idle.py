"""The share of the traced window in which no kernel, copy or memset ran
on the card, in %."""


def read(ctx):
    summary = ctx.get("trace")
    if summary is None or summary.window_s <= 0 or summary.busy_s <= 0:
        return None
    return 100.0 * (1.0 - summary.busy_s / summary.window_s)
