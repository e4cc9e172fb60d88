"""The repository's evaluation tools on the port: cross-validation,
session-level accuracy, deployment ensemble fitting, the streaming soak and
the model-selection sweep (counterparts of tools/crossval.py,
session_eval.py, fit_ensemble.py, stream_soak.py and sweep.py). Run each as
`python -m neural_speech_decoding_tpu_torch.tools.<name>`."""
