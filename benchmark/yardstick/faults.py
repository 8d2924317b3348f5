"""Faults planted in the timed path, and the control, to show that the
comparison fails them: the program hooks a runner calls before its window
(``RunContext.hooks["program"]``).

A hook that returns a precision puts the reference, computed in that
precision, in the program's place: the runner reads the stand-in's
outputs where it reads the program's (a training cell's losses, first
gradient and weights after the checked steps; a served cell's frame ids
and lengths) and judges them as the program's."""

from __future__ import annotations


def unchanged_state(trainer=None, task=None, state=None, **_):
    """Every train step returns its state unchanged: Adam never steps."""
    state.optimizer.step = lambda *args, **kwargs: None


def half_batch(trainer=None, task=None, state=None, **_):
    """Half of each batch left out: the loss is the mean over the rest."""
    loss = task.loss

    def half(batch, train, generator=None):
        cut = tuple(tuple(t[:t.shape[0] // 2] for t in pair) for pair in batch)
        return loss(cut, train, generator)

    task.loss = half


def altered_token(pipe=None, model=None, **_):
    """The first frame's id of every served row altered where the model
    produces it."""
    greedy = model.greedy_decode

    def altered(*args):
        ids, lengths = greedy(*args)
        ids = ids.clone()
        ids[:, 0] = (ids[:, 0] + 1) % model.vocab_size
        return ids, lengths

    model.greedy_decode = altered


def control_tf32(**_):
    """The control: the float32 reference computed in TF32, the nearest
    precision below the configuration's float32 with TF32 off, stands in
    for the program."""
    return "tf32"


FAULTS = {"unchanged_state": unchanged_state, "half_batch": half_batch,
          "altered_token": altered_token, "control_tf32": control_tf32}
