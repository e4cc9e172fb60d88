from neural_speech_decoding_tpu_torch.models.lstm import decoder_logits  # noqa: F401
