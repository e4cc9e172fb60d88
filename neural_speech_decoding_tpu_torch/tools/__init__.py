"""The repository's evaluation tools on the port: cross-validation,
session-level accuracy, deployment ensemble fitting, the streaming soak,
the model-selection sweep, held-out accuracy of the shipped checkpoints
and the per-precision fidelity report (counterparts of tools/crossval.py,
session_eval.py, fit_ensemble.py, stream_soak.py, sweep.py,
eval_models.py and fidelity_report.py). Run each as
`python -m neural_speech_decoding_tpu_torch.tools.<name>`."""
