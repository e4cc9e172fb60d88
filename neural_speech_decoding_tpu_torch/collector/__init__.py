from neural_speech_decoding_tpu_torch.collector.chain import (  # noqa: F401
    preprocess_trial,
    record_trial,
    write_trial_csv,
)
from neural_speech_decoding_tpu_torch.collector.experiment import (  # noqa: F401
    ExperimentConfig,
    run_experiment,
)
