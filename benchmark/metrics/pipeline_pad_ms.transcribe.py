"""Mean host time a transcription call of the program's span ``asr.pad``
(the bucket check, the sort and each batch's numpy pad), summed over the
call's batches, in ms (layer ``inference.pipeline``)."""

from yardstick import program_spans


def read(ctx):
    return program_spans.span_ms("asr.pad", "asr.transcribe")
