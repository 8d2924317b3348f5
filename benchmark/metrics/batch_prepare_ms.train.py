"""Mean seconds the prefetcher's thread spends on a batch, in ms: reading
it from the loader (the port's collate) and the packed copy's enqueue
(the program's ``prefetch.prepare``, charged a batch taken; layer
``data.prefetch``)."""

from yardstick import program_spans


def read(ctx):
    return program_spans.span_ms("prefetch.prepare", "prefetch.prepare")
