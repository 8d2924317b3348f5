"""Kernel-9 launches a training step (the program's counter
``conformer.attn_launches``: one forward and two backward launches a
Conformer block; 0 where the attention ran another path). None where the
program keeps no such counter."""

from yardstick import program_spans


def read(ctx):
    return program_spans.counted(("conformer.attn_launches",), "trainer.train_step")
