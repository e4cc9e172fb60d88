"""Port parity: the LSTM decoder of neural_speech_decoding_tpu_torch
against the JAX package's decoder_apply (the streaming eval scan), on 64
of the 324 golden filtered windows, for the 3- and 5-class checkpoints.

Budget: <= 1e-4 max |delta logit|, the JAX package's f32 fidelity budget.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_speech_decoding_tpu.config import DecoderConfig as JaxDecoderConfig
from neural_speech_decoding_tpu.io.params_io import load_params_npz as jax_load_npz
from neural_speech_decoding_tpu.models.lstm import decoder_apply
from neural_speech_decoding_tpu_torch.config import DecoderConfig
from neural_speech_decoding_tpu_torch.io.from_jax import params_from_jax
from neural_speech_decoding_tpu_torch.io.params_io import load_params_npz
from neural_speech_decoding_tpu_torch.models.lstm import decoder_logits

REPO = Path(__file__).resolve().parents[1]
GOLDEN = REPO / "tests" / "golden" / "reference_filtered.npz"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def filtered():
    with np.load(GOLDEN, allow_pickle=False) as z:
        x = z["filtered"]
    # 64 windows spread over the whole set (all classes of the recording)
    return x[np.linspace(0, len(x) - 1, 64).astype(int)]


def test_npz_loader_matches_jax():
    path = REPO / "checkpoints" / "lstm3_retrained.npz"
    ours, theirs = load_params_npz(path), jax_load_npz(path)
    assert len(ours["lstm"]) == len(theirs["lstm"]) == 2
    for l in range(2):
        for k in ("w_ih", "w_hh", "b"):
            np.testing.assert_array_equal(ours["lstm"][l][k], theirs["lstm"][l][k])
    assert np.asarray(ours["attn"]["b"]).shape == ()
    assert params_from_jax(ours)["attn"]["b"].shape == ()


@pytest.mark.parametrize("checkpoint, classes", [("lstm3_retrained", 3), ("lstm5", 5)])
@pytest.mark.parametrize("n", [64, 1])  # a serving batch, and run_trials' single window
def test_decoder_logits_match_jax(filtered, checkpoint, classes, n):
    x = filtered[:n]
    params = jax_load_npz(REPO / "checkpoints" / f"{checkpoint}.npz")
    want = np.asarray(decoder_apply(params, jnp.asarray(x), JaxDecoderConfig(num_classes=classes)))
    got = decoder_logits(
        params_from_jax(params), torch.from_numpy(x), DecoderConfig(num_classes=classes)
    ).numpy()
    assert got.shape == (n, classes) and got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-4
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


def test_decoder_refusals(filtered):
    """A class count the checkpoint does not have, and an unknown
    recurrence dtype, raise. Other depths are served (through the
    per-layer recurrence) since the port has one: a one-layer cut of the
    checkpoint agrees with JAX's decoder_apply on it."""
    params = params_from_jax(load_params_npz(REPO / "checkpoints" / "lstm3_retrained.npz"))
    with pytest.raises(ValueError, match="3 classes, config 5"):
        decoder_logits(params, torch.from_numpy(filtered[:2]), DecoderConfig(num_classes=5))
    with pytest.raises(ValueError, match="unknown recurrence_dtype"):
        decoder_logits(params, torch.from_numpy(filtered[:2]), DecoderConfig(recurrence_dtype="float16"))
    jax_params = jax_load_npz(REPO / "checkpoints" / "lstm3_retrained.npz")
    jax_params["lstm"] = jax_params["lstm"][:1]
    params["lstm"] = params["lstm"][:1]
    x = filtered[:4]
    want = np.asarray(decoder_apply(jax_params, jnp.asarray(x), JaxDecoderConfig()))
    got = decoder_logits(params, torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 1e-4
