"""The share of the samples a transcription call pads that are padding:
1 - the clips' samples (the program's counter ``asr.clip_samples``) over
the batches' padded samples (``asr.padded_samples``, batch size x width a
batch), over the window's calls, in % (layer ``inference.pipeline``).
None where the program keeps no such counter."""

from yardstick import program_spans


def read(ctx):
    padded = program_spans.counted(("asr.padded_samples",), "asr.transcribe")
    if not padded:
        return None
    clips = program_spans.counted(("asr.clip_samples",), "asr.transcribe")
    return 100.0 * (1.0 - clips / padded)
