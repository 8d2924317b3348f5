"""Tiny overrides of the cells for the CPU: the published structure at
widths of 32, short clips, small batches."""

SECONDS = {"range": [1.3, 3.0], "components": [{"weight": 1.0, "uniform": [1.3, 3.0]}]}
ASR = {"init_args": {"encoder_settings": [[32, False, 5, 2, 2, False],
                                          [32, False, 5, 1, 2, False]],
                     "decoder_hidden_size": 32}}
TTS = {"init_args": {"encoder_hidden_size": 32,
                     "decoder_settings": [[32, False, 5, 1, 2, False], [32, True, 5, 2, 2, False],
                                          [32, False, 5, 1, 2, False]]}}
TRAIN = {"batch_size": 4, "pool": 32, "seconds": SECONDS}

OVERRIDES = {
    "asr_en_base.train_librispeech": {"config": ASR, "traffic": TRAIN},
    "tts_en_base.train_ljspeech": {"config": TTS, "traffic": TRAIN},
    "asr_en_base.transcribe_bulk": {"config": ASR, "traffic": {
        "clips_per_call": 16, "variants": 2, "batch_size": 8, "seconds": SECONDS, "sample": 8}},
    "asr_en_base.serve_poisson": {"config": ASR, "traffic": {
        "pool": 16, "seconds": SECONDS, "sample": 8, "rate_per_s": 20.0, "warm_s": 0.3,
        "clients": 8}},
}
