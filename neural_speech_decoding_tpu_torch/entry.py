"""Entry points of the port (counterpart of `__graft_entry__.py`).

entry()             -> (forward, (params, windows)): the serving forward
                       step (fast MAI filter -> LSTM -> softmax) with the
                       shipped 3-class LSTM (checkpoints/lstm3_retrained.npz)
                       and 8 windows [8, 625, 8] from np.random.default_rng(0)
dryrun_multichip(n) -> one data-parallel training step a family on an
                       n-device mesh (parallel/), the sharded filter held
                       against the stages filter, and the shipped flagship
                       manifest served dp-sharded

  python -m neural_speech_decoding_tpu_torch.entry [N] [--device cpu]

Both run on CUDA unless the caller names another device; without CUDA
they raise.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from neural_speech_decoding_tpu_torch.config import DecoderConfig, FilterConfig
from neural_speech_decoding_tpu_torch.io.from_jax import params_from_jax
from neural_speech_decoding_tpu_torch.io.params_io import load_params_npz
from neural_speech_decoding_tpu_torch.models.lstm import decoder_logits, init_decoder_params
from neural_speech_decoding_tpu_torch.models.registry import get_model
from neural_speech_decoding_tpu_torch.ops.kuramoto import mai_filter, mai_filter_batch, mai_filter_batch_sharded
from neural_speech_decoding_tpu_torch.parallel.mesh import make_mesh
from neural_speech_decoding_tpu_torch.runtime.ensemble import EnsembleEngine
from neural_speech_decoding_tpu_torch.train.loop import (
    Optimizer,
    TrainConfig,
    _is_buffer,
    _leaves,
    make_sharded_train_step,
)
from neural_speech_decoding_tpu_torch.utils.device import DeviceLike, disable_tf32, resolve_device

ROOT = Path(__file__).resolve().parents[1]
CHECKPOINT = ROOT / "checkpoints" / "lstm3_retrained.npz"
MANIFEST = ROOT / "checkpoints" / "logcov8wd_ens_manifest.json"


def entry(device: DeviceLike = None):
    """The serving forward step on the port's default model, and its
    example arguments: forward(params, windows [B, T, C]) -> probabilities
    [B, 3] on the device."""
    dev = resolve_device(device)
    disable_tf32()
    params = params_from_jax(load_params_npz(CHECKPOINT), dev)
    filter_cfg, decoder_cfg = FilterConfig(precision="fast"), DecoderConfig()

    @torch.no_grad()
    def forward(p, windows_btc):
        filtered = mai_filter_batch(windows_btc, filter_cfg, device=dev)
        return torch.softmax(decoder_logits(p, filtered, decoder_cfg), dim=-1)

    windows = np.random.default_rng(0).standard_normal((8, 625, 8)).astype(np.float32)
    return forward, (params, windows)


def _sharded_step(model, params, x: np.ndarray, y: np.ndarray, mesh) -> float:
    """One data-parallel train step (Adam 1e-3, no clipping) of `model`
    from `params` over `mesh`; returns the loss."""
    primary = mesh.primary
    replicas = {d: params if d == primary else params_from_jax(params, d) for d in mesh.distinct}
    for tree in replicas.values():
        for path, t in _leaves(tree):
            t.requires_grad_(not _is_buffer(path))
    optimizer = Optimizer(replicas[primary], TrainConfig(learning_rate=1e-3, grad_clip=0.0))
    generators = {d: torch.Generator(device=d).manual_seed(42 + k) for k, d in enumerate(mesh.distinct)}
    step = make_sharded_train_step(model, optimizer, mesh)
    metrics = step(replicas, torch.from_numpy(x).to(primary), torch.from_numpy(y).long().to(primary), generators)
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    return loss


def dryrun_multichip(
    n_devices: int,
    families: Sequence[str] = ("lstm", "logcov8", "ensemble"),
    devices: Optional[Sequence] = None,
) -> dict:
    """One sharded training step a family on an n-device mesh, plus a
    sharded serving pass of the deployment ensemble; returns the numbers
    it prints.

    The mesh is n x 1 (dp x tp) over `devices`, by default the first n
    cards (raising when fewer are visible); pass one device repeated (e.g.
    ["cuda:0"] * n or ["cpu"] * n) to run it on one. The port's training
    shards the batch over dp only, so the JAX dryrun's tp axis has no
    counterpart here. Families: "lstm", the reference LSTM at 64 steps,
    batch 2 * dp; "logcov8", whitened logcov8 at the served log (rational:
    the band-gram and feature kernels on the card; the JAX dryrun takes the
    Chebyshev scan) on full 625-sample windows; "ensemble", the shipped
    manifest (checkpoints/logcov8wd_ens_manifest.json) through
    EnsembleEngine(mesh=). Always: mai_filter_batch_sharded (the pair-sums
    kernel once a shard) against the fast stages filter."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass devices=['cpu'] * n for a mesh on the CPU")
        if torch.cuda.device_count() < n_devices:
            raise RuntimeError(f"need {n_devices} cards, have {torch.cuda.device_count()}; "
                               f"pass devices=['cuda:0'] * {n_devices} to repeat one")
        devices = [f"cuda:{i}" for i in range(n_devices)]
    if len(devices) != n_devices:
        raise ValueError(f"{len(devices)} devices given for n_devices={n_devices}")
    mesh = make_mesh(list(devices), tp=1)
    disable_tf32()
    primary, dp = mesh.primary, mesh.shape["dp"]
    b = 2 * dp
    y = np.random.default_rng(1).integers(0, 3, size=(b,)).astype(np.int64)
    out = {"dp": dp, "tp": mesh.shape["tp"]}

    if "lstm" in families:
        cfg = DecoderConfig()
        params = init_decoder_params(torch.Generator(device=primary).manual_seed(0), cfg)
        x = np.random.default_rng(0).standard_normal((b, 64, cfg.input_size)).astype(np.float32)
        out["loss"] = _sharded_step(cfg, params, x, y, mesh)

    if "logcov8" in families:
        spec = get_model("logcov8", whiten=True)
        xl = np.random.default_rng(2).standard_normal((b, 625, 8)).astype(np.float32)
        lparams = spec.init(torch.Generator(device=primary).manual_seed(1))
        lparams = spec.fit(lparams, torch.from_numpy(xl).to(primary))  # the tangent-point whitener
        out["logcov8_loss"] = _sharded_step(spec, lparams, xl, y, mesh)

    # the sharded filter (the serving default's kernel, once a shard)
    # against the fast stages filter on the primary device
    wk = np.random.default_rng(5).standard_normal((b, 625, 8)).astype(np.float32)
    fast = FilterConfig(precision="fast")
    kern = mai_filter_batch_sharded(wk, fast, mesh=mesh)
    stages = mai_filter(torch.from_numpy(wk).to(primary), fast)
    delta = float((kern - stages).abs().max())
    budget = 2e-4 * float(stages.abs().max())
    if not delta <= budget:
        raise AssertionError(f"sharded filter diverges from stages: {delta:.3e} > {budget:.3e}")
    out["kernel_vs_stages_max_delta"] = delta

    if "ensemble" in families and MANIFEST.is_file():
        ens = EnsembleEngine.from_manifest(str(MANIFEST), mesh=mesh)
        probs = ens.predict_batch(np.random.default_rng(3).standard_normal((b, 625, 8)).astype(np.float32))
        if not (np.isfinite(probs).all() and probs.shape == (b, 3)):
            raise AssertionError(f"ensemble over the mesh: bad probabilities {probs.shape}")
        out["ensemble_members"] = ens.num_members

    print(f"dryrun_multichip ok: mesh dp={dp} tp={out['tp']}"
          + (f" loss={out['loss']:.4f}" if "loss" in out else "")
          + (f" logcov8_loss={out['logcov8_loss']:.4f}" if "logcov8_loss" in out else "")
          + (f" ensemble_members={out['ensemble_members']}" if "ensemble_members" in out else "")
          + f" kernel_vs_stages_max_delta={delta:.3e}")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="entry()'s forward, or dryrun_multichip(N)")
    ap.add_argument("n_devices", nargs="?", type=int, default=None,
                    help="run dryrun_multichip over this many devices (default: entry's forward)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device); with N, the device repeated N times")
    args = ap.parse_args(argv)
    if args.n_devices is not None:
        devices = None if args.device is None else [args.device] * args.n_devices
        dryrun_multichip(args.n_devices, devices=devices)
    else:
        fn, (params, windows) = entry(args.device)
        print("entry ok:", tuple(fn(params, windows).shape))


if __name__ == "__main__":
    main()
