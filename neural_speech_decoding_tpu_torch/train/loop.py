"""Training loop on one device.

Counterpart of neural_speech_decoding_tpu/train/loop.py:31-398, with
torch.optim in place of optax and one torch.Generator in place of the
jax.random keys:

  * windows are MAI-filtered once up front (the filter has no trainable
    state), or taken from `preprocessed`;
  * the stratified split (io/dataset.TrialDataset.split), the numpy
    augmentation (train/augment.py) and the per-epoch batch permutation
    (default_rng(seed + start_epoch)) draw exactly what the JAX loop draws,
    so both frameworks see the same batches;
  * parameters come from the family's init on one Generator on the
    training device, seeded from TrainConfig.seed, which then draws every
    dropout mask and RReLU slope; a family with a fit (the logcov whitener)
    fits it on the clean training windows;
  * a family with a parameter-free featurize (logcov) is featurized once
    and trained in head space (apply == head_apply(featurize));
  * the optimizer is Adam, or AdamW with the whitener kept out of it (the
    JAX "whitener" mask keeps it out of the decay, and its gradient is
    zero, so Adam never moves it either), behind optax's global-norm
    clipping and learning-rate schedule, computed here by optax's formulas;
  * softmax cross-entropy with optional label smoothing and class weights,
    keep_best, early stop, and checkpoint/resume (train/checkpointing.py).

The loop runs on the card unless the caller names another device; without
CUDA and without a device it raises.

With `mesh=` (parallel/mesh.Mesh) it trains data-parallel, as the JAX loop
does under its mesh: the batch is max(dp, (batch_size // dp) * dp), the
validation set is padded to a multiple of dp with weight 0, the windows are
filtered dp-sharded, and there is no head-space fast path. Each dp shard
runs the train-mode forward and backward on the first device of its row,
with a replica of the parameters there and a loss normalised by the
*global* batch (and class weights); the shard gradients are summed on the
primary device in shard order, clipped once and stepped once, and the
replicas are then updated from the primary. Each distinct device draws
from its own torch.Generator, seeded with TrainConfig.seed plus the
device's place in the mesh (the primary's is the one of the unsharded loop,
which also draws the init); JAX draws the global batch's masks from one
key, so the port's masks under a mesh differ from the unsharded ones.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from neural_speech_decoding_tpu_torch.config import DecoderConfig, FilterConfig
from neural_speech_decoding_tpu_torch.io.from_jax import params_from_jax
from neural_speech_decoding_tpu_torch.models.lstm import decoder_apply, init_decoder_params
from neural_speech_decoding_tpu_torch.ops.kuramoto import mai_filter_batch, mai_filter_batch_sharded
from neural_speech_decoding_tpu_torch.parallel.mesh import primary_device
from neural_speech_decoding_tpu_torch.parallel.sharding import batch_sharding
from neural_speech_decoding_tpu_torch.utils.device import DeviceLike, disable_tf32, resolve_device


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-3
    weight_decay: float = 0.0
    epochs: int = 60
    batch_size: int = 32
    label_smoothing: float = 0.0
    grad_clip: float = 1.0
    seed: int = 0
    val_fraction: float = 0.2
    # "constant" | "cosine" (linear warmup over `warmup_epochs` from lr/100
    # to lr, then cosine decay to lr/100 at the end of the run)
    schedule: str = "constant"
    warmup_epochs: int = 5
    # stop after this many epochs without val-accuracy improvement; 0 = off
    early_stop_patience: int = 0
    # noise-injection augmentation (train/augment.py); 0 disables
    augment_prob: float = 0.0
    # "noise": the reference's injectors; "all" adds time_shift, scale and
    # channel_drop
    augment_kinds: str = "noise"
    # checkpoint/resume (train/checkpointing.py); None disables
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 20
    resume: bool = True
    # return the parameters of the best-val-accuracy epoch, not the last
    keep_best: bool = True


@dataclasses.dataclass
class TrainState:
    """A run's state (JAX TrainState): the parameters, the optimizer (its
    moments and step count with it) and the step."""

    params: Any
    optimizer: Any
    step: int = 0


# ---------------------------------------------------------------------------
# parameter trees
# ---------------------------------------------------------------------------
def _leaves(tree: Any, path: Tuple = ()) -> Iterator[Tuple[Tuple, torch.Tensor]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _is_buffer(path: Tuple) -> bool:
    """A fitted buffer (the logcov whitener), not a weight."""
    return "whitener" in path


def _trainable(params) -> List[torch.Tensor]:
    return [t for path, t in _leaves(params) if not _is_buffer(path)]


def _detached(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_detached(v) for v in tree]
    return tree.detach().clone()


def _copy_into(tree: Any, values: Any) -> None:
    for (_, dst), (_, src) in zip(_leaves(tree), _leaves(values)):
        with torch.no_grad():
            dst.copy_(src)


# ---------------------------------------------------------------------------
# optimizer: optax's schedule and clipping around torch.optim
# ---------------------------------------------------------------------------
def warmup_cosine_decay_schedule(
    init_value: float,
    peak_value: float,
    warmup_steps: int,
    decay_steps: int,
    end_value: float = 0.0,
    exponent: float = 1.0,
) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule: linear from init to peak over
    `warmup_steps`, then (1 - a) * (0.5 (1 + cos(pi t / T)))^exponent + a
    times peak, t the steps since warmup (held at T = decay_steps -
    warmup_steps), a = end / peak."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1 - min(max(count, 0), warmup_steps) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        span = decay_steps - warmup_steps
        t = min(count - warmup_steps, span)
        cosine = 0.5 * (1 + math.cos(math.pi * t / span))
        return peak_value * ((1 - alpha) * cosine**exponent + alpha)

    return schedule


def _schedule(cfg: TrainConfig, steps_per_epoch: int) -> Callable[[int], float]:
    if cfg.schedule == "cosine":
        warmup = max(1, cfg.warmup_epochs * steps_per_epoch)
        total = max(warmup + 1, cfg.epochs * steps_per_epoch)
        return warmup_cosine_decay_schedule(
            cfg.learning_rate / 100.0, cfg.learning_rate, warmup, total, cfg.learning_rate / 100.0
        )
    if cfg.schedule == "constant":
        return lambda count: cfg.learning_rate
    raise ValueError(f"unknown schedule {cfg.schedule!r}")


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: g / norm * max_norm for every
    gradient when the global norm is not below max_norm, else unchanged
    (torch's clip_grad_norm_ adds 1e-6 to the norm, so it is not used).
    Returns the norm; decides on the device, without a host read."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


class Optimizer:
    """JAX `_optimizer` (train/loop.py:163-197) over torch.optim: Adam, or
    AdamW when weight_decay > 0 (decoupled, as optax.adamw), over the
    trainable leaves only; global-norm clipping first when grad_clip > 0;
    the step's learning rate from the schedule at the number of steps
    taken before it, as optax counts."""

    def __init__(self, params: Any, cfg: TrainConfig, steps_per_epoch: int = 1):
        self.leaves = _trainable(params)
        self.schedule = _schedule(cfg, steps_per_epoch)
        self.grad_clip = cfg.grad_clip
        self.count = 0
        lr = self.schedule(0)
        if cfg.weight_decay > 0:
            self.torch = torch.optim.AdamW(self.leaves, lr=lr, eps=1e-8, weight_decay=cfg.weight_decay)
        else:
            self.torch = torch.optim.Adam(self.leaves, lr=lr, eps=1e-8)

    def zero_grad(self) -> None:
        self.torch.zero_grad(set_to_none=True)

    def step(self) -> None:
        """One update from the trainable leaves' .grad."""
        live = [t.grad for t in self.leaves if t.grad is not None]
        if self.grad_clip > 0 and live:
            clip_by_global_norm_(live, self.grad_clip)
        for group in self.torch.param_groups:
            group["lr"] = self.schedule(self.count)
        self.torch.step()
        self.count += 1

    def state_dict(self) -> Dict[str, Any]:
        return {"torch": self.torch.state_dict(), "count": self.count}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.torch.load_state_dict(state["torch"])
        self.count = int(state["count"])


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------
def _as_apply_fn(model) -> Callable:
    """`model` -> apply(params, x, *, train, generator) -> logits: a
    DecoderConfig (the reference LSTM), a registry ModelSpec, or a callable
    already of that form."""
    if isinstance(model, DecoderConfig):
        cfg = model
        return lambda p, x, *, train=False, generator=None: decoder_apply(
            p, x, cfg, train=train, generator=generator
        )
    if hasattr(model, "apply"):
        return model.apply
    if callable(model):
        return model
    raise TypeError(f"cannot build apply fn from {type(model)}")


def _per_example(logits: torch.Tensor, batch_y: torch.Tensor, label_smoothing: float) -> torch.Tensor:
    """Softmax cross-entropy of each example against one-hot targets
    smoothed by `label_smoothing`."""
    n_cls = logits.shape[-1]
    onehot = F.one_hot(batch_y.long(), n_cls).to(logits.dtype)
    if label_smoothing > 0:
        onehot = onehot * (1 - label_smoothing) + label_smoothing / n_cls
    return -torch.sum(onehot * torch.log_softmax(logits, dim=-1), dim=-1)


def _loss_fn(
    params, batch_x, batch_y, generator, apply_fn, label_smoothing: float, class_weights=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, accuracy) of a train-mode forward: softmax cross-entropy
    against one-hot targets smoothed by `label_smoothing`; with
    `class_weights`, each example weighted by its class's weight and the
    sum divided by the weights' sum."""
    logits = apply_fn(params, batch_x, train=True, generator=generator)
    per_example = _per_example(logits, batch_y, label_smoothing)
    if class_weights is not None:
        w = torch.as_tensor(class_weights, dtype=logits.dtype, device=logits.device)[batch_y.long()]
        loss = torch.sum(w * per_example) / torch.clamp(torch.sum(w), min=1e-9)
    else:
        loss = per_example.mean()
    acc = (logits.argmax(-1) == batch_y).to(torch.float32).mean()
    return loss, acc


def make_train_step(model, optimizer: Optimizer, label_smoothing: float = 0.0, class_weights=None) -> Callable:
    """step(params, x [B,T,C], y [B], generator) -> {"loss", "accuracy"}
    (device tensors): one train-mode forward, backward and optimizer
    update, in place on the parameters."""
    apply_fn = _as_apply_fn(model)
    class_weights = tuple(class_weights) if class_weights is not None else None

    def step(params, x, y, generator):
        optimizer.zero_grad()
        loss, acc = _loss_fn(params, x, y, generator, apply_fn, label_smoothing, class_weights)
        loss.backward()
        optimizer.step()
        return {"loss": loss.detach(), "accuracy": acc}

    return step


def make_sharded_train_step(
    model, optimizer: Optimizer, mesh, label_smoothing: float = 0.0, class_weights=None
) -> Callable:
    """The data-parallel step over `mesh`: step(replicas, x [B,T,C], y [B],
    generators) -> {"loss", "accuracy"} on the primary device.

    `replicas` maps each distinct device of the mesh to its copy of the
    parameters (the primary's is the tree `optimizer` steps);
    `generators` maps each to its torch.Generator. x and y split over
    'dp' (B must divide); each shard's forward and backward runs on its
    row's first device, its loss normalised by the global batch (and class
    weights), so that the shards' gradients sum to the batch's. The sum
    is taken on the primary in shard order, the optimizer steps once, and
    the other replicas are copied from the primary."""
    apply_fn = _as_apply_fn(model)
    class_weights = tuple(class_weights) if class_weights is not None else None
    primary = mesh.primary

    def shard(params, x, y, generator, n_total, w_total):
        logits = apply_fn(params, x, train=True, generator=generator)
        per_example = _per_example(logits, y, label_smoothing)
        if class_weights is not None:
            w = torch.as_tensor(class_weights, dtype=logits.dtype, device=logits.device)[y.long()]
            loss = torch.sum(w * per_example) / w_total.to(logits.device)
        else:
            loss = torch.sum(per_example) / n_total
        correct = (logits.argmax(-1) == y).to(torch.float32).sum() / n_total
        leaves = _trainable(params)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), correct, grads

    def step(replicas, x, y, generators):
        n_total = int(x.shape[0])
        w_total = None
        if class_weights is not None:
            cw = torch.as_tensor(class_weights, dtype=torch.float32, device=y.device)
            w_total = torch.clamp(cw[y.long()].sum(), min=1e-9)
        xs, ys = batch_sharding(mesh, x), batch_sharding(mesh, y)
        outs = mesh.run([
            (w.device, shard, (replicas[w.device], w, t, generators[w.device], n_total, w_total))
            for w, t in zip(xs, ys)
        ])
        optimizer.zero_grad()
        for k, leaf in enumerate(_trainable(replicas[primary])):
            parts = [o[2][k] for o in outs if o[2][k] is not None]
            if parts:
                total = parts[0].to(primary)
                for g in parts[1:]:
                    total = total + g.to(primary)
                leaf.grad = total
        optimizer.step()
        for d, tree in replicas.items():
            if d != primary:
                _copy_into(tree, replicas[primary])
        loss = sum(o[0].to(primary) for o in outs)
        acc = sum(o[1].to(primary) for o in outs)
        return {"loss": loss, "accuracy": acc}

    return step


def _eval_sums(apply_fn, params, x, y, w) -> torch.Tensor:
    """[sum of w * loss, sum of w * correct, sum of w] of an eval-mode
    forward."""
    logits = apply_fn(params, x, train=False)
    per = -torch.log_softmax(logits, dim=-1).gather(1, y.long()[:, None])[:, 0]
    correct = (logits.argmax(-1) == y).to(torch.float32)
    return torch.stack([torch.sum(per * w), torch.sum(correct * w), torch.sum(w)])


def _eval_metrics(sums: torch.Tensor) -> Dict[str, torch.Tensor]:
    denom = torch.clamp(sums[2], min=1.0)
    return {"loss": sums[0] / denom, "accuracy": sums[1] / denom}


def make_eval_fn(model) -> Callable:
    apply_fn = _as_apply_fn(model)

    @torch.no_grad()
    def evaluate(params, x, y, w):
        """Eval-mode loss and accuracy, each example weighted by w (0 for
        padding rows)."""
        return _eval_metrics(_eval_sums(apply_fn, params, x, y, w))

    return evaluate


def make_sharded_eval_fn(model, mesh) -> Callable:
    """evaluate(replicas, x, y, w) over `mesh`: each dp shard's weighted
    sums on its row's first device, added on the primary in shard order
    (B must divide by dp)."""
    apply_fn = _as_apply_fn(model)

    @torch.no_grad()
    def evaluate(replicas, x, y, w):
        shards = zip(*(batch_sharding(mesh, a) for a in (x, y, w)))
        parts = mesh.run([(xs.device, _eval_sums, (apply_fn, replicas[xs.device], xs, ys, ws)) for xs, ys, ws in shards])
        return _eval_metrics(sum(p.to(mesh.primary) for p in parts))

    return evaluate


def _pad_to_multiple(x: np.ndarray, m: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pad axis 0 to a multiple of m (repeating row 0); returns (padded,
    weights) with weights 0 on padding (JAX loop.py:140-148)."""
    n = x.shape[0]
    pad = (-n) % m
    w = np.concatenate([np.ones(n, np.float32), np.zeros(pad, np.float32)])
    if pad:
        x = np.concatenate([x, np.repeat(x[:1], pad, axis=0)], axis=0)
    return x, w


def _filter_windows(windows: np.ndarray, filter_cfg: FilterConfig, dev, mesh) -> np.ndarray:
    """The MAI filter of the training windows: on `dev`, or dp-sharded over
    `mesh` (padded to a multiple of dp, the padding dropped)."""
    if mesh is None:
        return mai_filter_batch(windows, filter_cfg, device=dev).cpu().numpy()
    padded, _ = _pad_to_multiple(np.asarray(windows), mesh.shape[mesh.axis_names[0]])
    return mai_filter_batch_sharded(padded, filter_cfg, mesh=mesh)[: len(windows)].cpu().numpy()


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------
def train(
    dataset,
    decoder_cfg: Optional[DecoderConfig] = None,
    train_cfg: TrainConfig = TrainConfig(),
    filter_cfg: Optional[FilterConfig] = None,
    mesh=None,
    init_params=None,
    verbose: bool = True,
    preprocessed: Optional[np.ndarray] = None,
    model=None,
    model_kw: Optional[Dict[str, Any]] = None,
    device: DeviceLike = None,
) -> Tuple[Any, List[Dict[str, float]]]:
    """Train a decoder on a TrialDataset. Returns (params, history): the
    parameters as float32 tensors on the training device, and one record an
    epoch (epoch, train_loss, train_accuracy, val_loss, val_accuracy,
    wall_s).

    `model`: a registry name ("lstm", "eegnet", "logcov8", ...) or a
    ModelSpec; otherwise the reference LSTM with `decoder_cfg`.
    `init_params`: a parameter pytree (numpy or tensor leaves) to start
    from instead of the family's init and fit. `device`: the training
    device (CUDA unless named). `mesh`: a parallel/mesh.Mesh to train
    data-parallel over (module docstring); the training device is then its
    primary device."""
    dev = resolve_device(device) if mesh is None else primary_device(mesh, device)
    if model is not None:
        if isinstance(model, str):
            from neural_speech_decoding_tpu_torch.models.registry import get_model

            spec = get_model(model, **(model_kw or {}))
        else:
            spec = model
        model_for_step: Any = spec
    else:
        decoder_cfg = decoder_cfg or DecoderConfig(num_classes=dataset.num_classes)
        spec = None
        model_for_step = decoder_cfg
    filter_cfg = filter_cfg or FilterConfig()
    disable_tf32()

    train_ds, val_ds = dataset.split(train_cfg.val_fraction, seed=train_cfg.seed)
    if preprocessed is not None:
        if preprocessed.shape != dataset.windows.shape:
            raise ValueError(
                f"preprocessed {preprocessed.shape} does not match the windows {dataset.windows.shape}"
            )
        index = {f: i for i, f in enumerate(dataset.files)}
        x_train = np.stack([preprocessed[index[f]] for f in train_ds.files])
        x_val = np.stack([preprocessed[index[f]] for f in val_ds.files])
    else:
        x_train = _filter_windows(train_ds.windows, filter_cfg, dev, mesh)
        x_val = _filter_windows(val_ds.windows, filter_cfg, dev, mesh)
    y_train = train_ds.labels.astype(np.int32)
    y_val = val_ds.labels.astype(np.int32)

    x_clean, y_clean = x_train, y_train  # before augmentation
    if train_cfg.augment_prob > 0:
        from neural_speech_decoding_tpu_torch.train.augment import ALL_KINDS, KINDS, augment_batch_np

        x_aug, y_aug = augment_batch_np(
            x_train, y_train, prob=train_cfg.augment_prob, seed=train_cfg.seed,
            kinds=ALL_KINDS if train_cfg.augment_kinds == "all" else KINDS,
        )
        x_train = np.concatenate([x_train, x_aug])
        y_train = np.concatenate([y_train, y_aug])

    generator = torch.Generator(device=dev)
    generator.manual_seed(train_cfg.seed)
    if init_params is None:
        params = spec.init(generator) if spec is not None else init_decoder_params(generator, decoder_cfg)
        if spec is not None and spec.fit is not None:
            # data-dependent init on the CLEAN training windows only
            params = spec.fit(params, x_clean, y_clean)
    else:
        params = params_from_jax(init_params, dev)
    for path, t in _leaves(params):
        t.requires_grad_(not _is_buffer(path))

    w_val_np = np.ones(x_val.shape[0], np.float32)
    if mesh is not None:  # the validation set padded to a multiple of dp, weight 0
        dp = mesh.shape[mesh.axis_names[0]]
        x_val, w_val_np = _pad_to_multiple(x_val, dp)
        y_val, _ = _pad_to_multiple(y_val, dp)
    x_train_t = torch.as_tensor(x_train, dtype=torch.float32, device=dev)
    x_val_t = torch.as_tensor(x_val, dtype=torch.float32, device=dev)
    # head-space fast path: featurize once, train the head every step (the
    # mesh path keeps the full apply, as the JAX loop's does)
    if mesh is None and spec is not None and spec.featurize is not None:
        with torch.no_grad():
            x_train_t = spec.featurize(params, x_train_t)
            x_val_t = spec.featurize(params, x_val_t)
        head = spec.head_apply
        model_for_step = lambda p, f, *, train=False, generator=None: head(  # noqa: E731
            p, f, train=train, generator=generator
        )
    y_train_t = torch.as_tensor(y_train, dtype=torch.int64, device=dev)
    y_val_t = torch.as_tensor(y_val, dtype=torch.int64, device=dev)
    w_val = torch.as_tensor(w_val_np, device=dev)

    steps_per_epoch = max(1, x_train_t.shape[0] // max(1, train_cfg.batch_size))
    optimizer = Optimizer(params, train_cfg, steps_per_epoch)

    start_epoch = 0
    if train_cfg.checkpoint_dir and train_cfg.resume:
        from neural_speech_decoding_tpu_torch.train import checkpointing as ckpt

        if ckpt.latest_epoch(train_cfg.checkpoint_dir) is not None:
            last, restored, opt_state = ckpt.restore_train_state(train_cfg.checkpoint_dir, params)
            _copy_into(params, restored)
            optimizer.load_state_dict(opt_state)
            start_epoch = last + 1
            if verbose:
                print(f"resumed from epoch {last}", flush=True)

    if mesh is None:
        step_fn = make_train_step(model_for_step, optimizer, train_cfg.label_smoothing)
        eval_fn = make_eval_fn(model_for_step)
        state, generators = params, generator
        bs = train_cfg.batch_size
    else:
        state, generators = {dev: params}, {dev: generator}
        for k, d in enumerate(mesh.distinct):
            if d != dev:
                state[d] = params_from_jax(params, d)
                for path, t in _leaves(state[d]):
                    t.requires_grad_(not _is_buffer(path))
                generators[d] = torch.Generator(device=d)
                generators[d].manual_seed(train_cfg.seed + k)
        step_fn = make_sharded_train_step(model_for_step, optimizer, mesh, train_cfg.label_smoothing)
        eval_fn = make_sharded_eval_fn(model_for_step, mesh)
        bs = max(dp, (train_cfg.batch_size // dp) * dp)

    history: List[Dict[str, float]] = []
    best_acc, best_params = -1.0, None
    epochs_since_best = 0
    n = x_train_t.shape[0]
    np_rng = np.random.default_rng(train_cfg.seed + start_epoch)
    t0 = time.perf_counter()
    for epoch in range(start_epoch, train_cfg.epochs):
        perm = torch.as_tensor(np_rng.permutation(n), device=dev)
        losses, accs = [], []
        for i in range(0, n - bs + 1, bs):
            idx = perm[i : i + bs]
            m = step_fn(state, x_train_t[idx], y_train_t[idx], generators)
            losses.append(m["loss"])
            accs.append(m["accuracy"])
        val_m = eval_fn(state, x_val_t, y_val_t, w_val)
        rec = {
            "epoch": epoch,
            "train_loss": float(torch.stack(losses).mean()) if losses else float("nan"),
            "train_accuracy": float(torch.stack(accs).mean()) if accs else float("nan"),
            "val_loss": float(val_m["loss"]),
            "val_accuracy": float(val_m["accuracy"]),
            "wall_s": time.perf_counter() - t0,
        }
        history.append(rec)
        if rec["val_accuracy"] > best_acc:
            epochs_since_best = 0
        else:
            epochs_since_best += 1
        if train_cfg.keep_best and rec["val_accuracy"] >= best_acc:
            best_acc = rec["val_accuracy"]
            best_params = _detached(params)
        if verbose and (epoch % 10 == 0 or epoch == train_cfg.epochs - 1):
            print(
                f"epoch {epoch:3d} loss {rec['train_loss']:.4f} "
                f"acc {rec['train_accuracy']:.3f} val_acc {rec['val_accuracy']:.3f}",
                flush=True,
            )
        if train_cfg.checkpoint_dir and (
            (epoch + 1) % train_cfg.checkpoint_every == 0 or epoch == train_cfg.epochs - 1
        ):
            from neural_speech_decoding_tpu_torch.train import checkpointing as ckpt

            ckpt.save_train_state(train_cfg.checkpoint_dir, epoch, params, optimizer.state_dict())
        if train_cfg.early_stop_patience > 0 and epochs_since_best >= train_cfg.early_stop_patience:
            if verbose:
                print(f"early stop at epoch {epoch} (patience {train_cfg.early_stop_patience})", flush=True)
            break
    if train_cfg.keep_best and best_params is not None:
        return best_params, history
    return _detached(params), history
