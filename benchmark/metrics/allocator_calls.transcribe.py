"""The caching allocator's device allocations and frees a transcription
call (``cudaMalloc`` and ``cudaFree``; the program's counters across
``asr.transcribe``; layer ``inference.pipeline``)."""

from yardstick import program_spans


def read(ctx):
    return program_spans.counted(("allocator.device_alloc", "allocator.device_free"),
                                 "asr.transcribe")
