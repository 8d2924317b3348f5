"""Mean host time a transcription call of the program's span
``asr.text`` (ids to text, each batch's rows), summed over the call's
batches, in ms (layer ``inference.pipeline``)."""

from yardstick import program_spans


def read(ctx):
    return program_spans.span_ms("asr.text", "asr.transcribe")
