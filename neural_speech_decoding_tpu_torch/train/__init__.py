"""Training: the loop (loop.py), augmentation (augment.py), checkpoint and
resume (checkpointing.py) and the CLI (`python -m
neural_speech_decoding_tpu_torch.train`)."""

from neural_speech_decoding_tpu_torch.train.loop import (  # noqa: F401
    TrainConfig,
    TrainState,
    make_eval_fn,
    make_train_step,
    train,
)
