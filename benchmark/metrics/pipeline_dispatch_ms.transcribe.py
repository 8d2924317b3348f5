"""Mean host time a transcription call of the program's span
``asr.dispatch`` (the enqueue of each batch's log-mel, model and greedy
decoding), summed over the call's batches, in ms (layer
``inference.pipeline``)."""

from yardstick import program_spans


def read(ctx):
    return program_spans.span_ms("asr.dispatch", "asr.transcribe")
