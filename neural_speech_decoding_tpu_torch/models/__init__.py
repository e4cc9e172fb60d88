from neural_speech_decoding_tpu_torch.models.logcov import (  # noqa: F401
    LogCovConfig,
    logcov_apply_ex,
    logcov_features,
)
from neural_speech_decoding_tpu_torch.models.lstm import decoder_apply, decoder_logits, init_decoder_params  # noqa: F401
from neural_speech_decoding_tpu_torch.models.registry import get_model  # noqa: F401
