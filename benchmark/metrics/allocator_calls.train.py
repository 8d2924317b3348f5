"""The caching allocator's device allocations and frees a training step
(``cudaMalloc`` and ``cudaFree``; the program's counters across
``trainer.train_step``; layer ``training.trainer``)."""

from yardstick import program_spans


def read(ctx):
    return program_spans.counted(("allocator.device_alloc", "allocator.device_free"),
                                 "trainer.train_step")
