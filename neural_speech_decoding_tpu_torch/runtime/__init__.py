from neural_speech_decoding_tpu_torch.runtime.board import (  # noqa: F401
    Board,
    ReplayBoard,
    SyntheticBoard,
    open_board,
)
from neural_speech_decoding_tpu_torch.runtime.engine import InferenceEngine  # noqa: F401
from neural_speech_decoding_tpu_torch.runtime.ensemble import EnsembleEngine  # noqa: F401
from neural_speech_decoding_tpu_torch.runtime.streaming import StreamingProducer  # noqa: F401
from neural_speech_decoding_tpu_torch.runtime.tester import (  # noqa: F401
    RunStats,
    TrialResult,
    run_trials,
    run_trials_ex,
)
