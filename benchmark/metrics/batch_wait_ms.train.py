"""Mean host wait for the next batch from the device prefetcher, a step
(the benchmark's span around ``next()``; layer ``data.prefetch``)."""

from yardstick import window


def read(ctx):
    spans = ctx["spans"].get("batch_wait")
    return None if not spans else 1e3 * window.mean(spans)
