from neural_speech_decoding_tpu_torch.io.checkpoint import (  # noqa: F401
    load_decoder_params,
    load_torch_checkpoint,
    torch_lstm_state_to_params,
)
from neural_speech_decoding_tpu_torch.io.from_jax import params_from_jax  # noqa: F401
from neural_speech_decoding_tpu_torch.io.params_io import load_params_npz  # noqa: F401
from neural_speech_decoding_tpu_torch.io.dataset import TrialDataset, load_trials  # noqa: F401
from neural_speech_decoding_tpu_torch.io.export import (  # noqa: F401
    decoder_params_to_torch_state,
    save_torch_checkpoint,
)
from neural_speech_decoding_tpu_torch.io.params_io import save_params_npz  # noqa: F401
