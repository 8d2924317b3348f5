"""The whole step's share of the card's float32 peak: the model FLOPs of
the traced window (training: forward and backward over the real,
augmented frames; transcription: the forward over every clip's real
frames; the benchmark's own counts) over the window's seconds times the
peak, in %."""

from yardstick import roofline


def read(ctx):
    summary, flops = ctx.get("trace"), ctx.get("model_flops")
    if summary is None or not flops or summary.window_s <= 0:
        return None
    return 100.0 * flops / (summary.window_s * roofline.PEAK_F32_FLOPS)
