from neural_speech_decoding_tpu_torch.ops.hilbert import analytic_signal  # noqa: F401
from neural_speech_decoding_tpu_torch.ops.iir import butter_sos  # noqa: F401
from neural_speech_decoding_tpu_torch.ops.kernels.iir import collector_stages, fused_preprocess  # noqa: F401
from neural_speech_decoding_tpu_torch.ops.kuramoto import (  # noqa: F401
    mai_filter,
    mai_filter_batch,
)
