"""Mean host time of a ``Trainer.train_step`` call (its enqueue; no sync
inside), a step (the benchmark's span; layer ``training.trainer``)."""

from yardstick import window


def read(ctx):
    spans = ctx["spans"].get("step_enqueue")
    return None if not spans else 1e3 * window.mean(spans)
