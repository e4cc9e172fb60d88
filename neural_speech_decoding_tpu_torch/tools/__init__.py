"""The repository's evaluation tools on the port: cross-validation,
session-level accuracy, deployment ensemble fitting and the streaming soak
(counterparts of tools/crossval.py, session_eval.py, fit_ensemble.py and
stream_soak.py). Run each as
`python -m neural_speech_decoding_tpu_torch.tools.<name>`."""
