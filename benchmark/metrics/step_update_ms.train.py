"""Mean host time of the trainer's ``trainer.update`` span a step (the
program's span inside ``Trainer.train_step``; layer ``training.trainer``)."""

from yardstick import program_spans


def read(ctx):
    return program_spans.span_ms("trainer.update", "trainer.train_step")
