"""The share of the query-key pairs launched into attention that padding
adds: 1 - the window's valid pairs (from its rows' subsampled lengths,
``B H T'^2`` a layer where every row is full) over the program's counter
``conformer.attn_pairs`` (the pairs its kernel-9 forward launches cover),
each a step, in %. None where the program keeps no such counter."""

from yardstick import program_spans


def read(ctx):
    valid, steps = ctx.get("valid_attn_pairs"), ctx.get("steps")
    launched = program_spans.counted(("conformer.attn_pairs",), "trainer.train_step")
    if not valid or not steps or not launched:
        return None
    return 100.0 * (1.0 - valid / steps / launched)
