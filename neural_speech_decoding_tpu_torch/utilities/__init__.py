"""The reference app's import surface, on the port.

Counterpart of the repository's `Utilities/` package, which forwards the
reference app's module paths (`Utilities.tester`, `.lstm_eeg_model`,
`.preprocessor`, `.neurokit_connector`, `.knight_board_init`,
`.streaming_process`) to the JAX package. These modules keep the same
names and signatures over the port's runtime:

  from neural_speech_decoding_tpu_torch.utilities.tester import run_trials

Every entry point runs on CUDA unless the caller passes `device="cpu"`;
without CUDA it raises.
"""
