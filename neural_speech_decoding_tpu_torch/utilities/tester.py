"""`utilities.tester`: the reference's `Utilities.tester` module path.

Forwards to the port's runtime/tester.py with the names that
`Utilities/tester.py` exports (reference tester.py:23-37). With the
default engine (the fast filter), `run_trials` launches the pair-sums
kernel once a trial on the card.
"""

from neural_speech_decoding_tpu_torch.runtime.tester import (  # noqa: F401
    DEFAULT_SERIAL,
    TrialResult,
    main,
    run_trials,
    run_trials_ex,
)
