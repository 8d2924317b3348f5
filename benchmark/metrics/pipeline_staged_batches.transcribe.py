"""Batches a transcription call staged in pinned host memory and
uploaded without a host sync (the program's counter ``asr.staged`` across
``asr.transcribe``; layer ``inference.pipeline``). A program without the
counter reads 0."""

from yardstick import program_spans


def read(ctx):
    return program_spans.counted(("asr.staged",), "asr.transcribe")
