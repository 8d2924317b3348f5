"""Mean host time a transcription call of the program's span
``asr.fetch`` (each batch's ``.cpu()`` of ids and lengths: the host
waiting for the card), summed over the call's batches, in ms (layer
``inference.pipeline``)."""

from yardstick import program_spans


def read(ctx):
    return program_spans.span_ms("asr.fetch", "asr.transcribe")
