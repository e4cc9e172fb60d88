"""Filter analysis: signal-file intake, SNR/impact metrics, and the offline
and real-time analysis CLIs (counterpart of neural_speech_decoding_tpu/
analysis/)."""

from neural_speech_decoding_tpu_torch.analysis.metrics import (  # noqa: F401
    compute_filter_metrics,
    snr_db,
)
from neural_speech_decoding_tpu_torch.analysis.io import (  # noqa: F401
    detect_orientation,
    detect_unit_scale,
    read_numeric_csv,
)
