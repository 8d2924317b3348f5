"""Mean host time a transcription call of the program's span
``asr.upload`` (each batch's two pageable host-to-device copies), summed
over the call's batches, in ms (layer ``inference.pipeline``)."""

from yardstick import program_spans


def read(ctx):
    return program_spans.span_ms("asr.upload", "asr.transcribe")
