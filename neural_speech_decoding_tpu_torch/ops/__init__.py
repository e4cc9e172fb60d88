from neural_speech_decoding_tpu_torch.ops.hilbert import analytic_signal, instantaneous_phase  # noqa: F401
from neural_speech_decoding_tpu_torch.ops.iir import butter_sos  # noqa: F401
from neural_speech_decoding_tpu_torch.ops.kernels.iir import collector_stages, fused_preprocess  # noqa: F401
from neural_speech_decoding_tpu_torch.ops.kuramoto import (  # noqa: F401
    KuramotoSpatialFilter,
    kuramoto_operator,
    kuramoto_operator_from_analytic,
    kuramoto_spatial_filter,
    mai_filter,
    mai_filter_batch,
)
