"""Training loop (port of ``dlwp_tpu.train.trainer``).

One train step is a forward through the model, the loss, ``backward`` and
an optimizer step with optax's update rule (:mod:`dlwp_torch.train.optim`),
on the model's device:

- the loss, the optimizer and the metrics are plain callables;
- multi-step ("sequence") training rolls the model out ``sequence_steps``
  times inside the loss, feeding each prediction back through
  ``splice_fn``, each model step under ``torch.utils.checkpoint`` (the
  JAX package's ``jax.checkpoint``): its activations are recomputed in the
  backward;
- early stopping with a minimum-epoch floor and best-weights restore;
- checkpoints every few epochs and resume from the latest;
- :meth:`Trainer.fit_device`, the epoch driver for a
  :class:`~dlwp_torch.data.device_sampler.DeviceSeriesSampler`: the
  shuffled window starts go to the card once an epoch, each batch is
  gathered there, and the step loop reads nothing back to the host; the
  losses come down once at the epoch's end;
- training on a mesh (a model built with ``mesh=`` / ``batch_spec=``).
  The port is one program over the mesh: batches stay global tensors on
  the model's device, and each sharded conv cuts its input into the
  mesh's blocks and joins its output (:mod:`dlwp_torch.parallel.spatial`),
  so a mesh with ``lat = lon = 1`` computes the same function as no mesh.
  As in the JAX package, :meth:`Trainer.fit` drops a batch whose length
  does not divide over the ``data`` shards, with one warning;
- data parallelism across processes (a mesh from
  :func:`~dlwp_torch.parallel.distributed.multihost_mesh` whose ``data``
  axis spans them): every process runs the same loop over the same global
  batches, keeps its own block of each (the JAX worker's
  ``make_array_from_process_local_data``), and averages the gradients
  with one ``all_reduce`` before the optimizer step; the parameters start
  as process 0's and stay bit-equal across processes, the loss in the
  history is the global mean, evaluation runs whole on every process, and
  only the primary process writes checkpoints (every process reads them
  on resume).

Kernels: every forward of a train step runs the ``lstm_gates`` kernel
(kernel forward, plain VJP), and so does checkpoint's recompute; the
conv-pool stages run their composition while a gradient is recorded, as
the JAX layer trains them. The sharded convs of impl 'pallas' / 'overlap'
run their kernels in the forward and recompute through the plain halo
exchange in the backward. Evaluation runs under ``torch.no_grad()``, so
the kernels run there.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Any, Callable, Iterable

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from dlwp_torch.ops import losses as loss_lib
from dlwp_torch.parallel.distributed import (
    all_reduce_mean,
    broadcast_flat,
    broadcast_params,
    is_primary,
    process_group,
)
from dlwp_torch.train.optim import OPTIMIZERS, add_decayed_weights

LOSSES = {
    "mse": loss_lib.mse,
    "mae": loss_lib.mae,
    "mean_squared_error": loss_lib.mse,
    "mean_absolute_error": loss_lib.mae,
}

EVAL_IMPLS = ("forward", "outer", "grad")


def resolve_loss(loss) -> Callable:
    if callable(loss):
        return loss
    try:
        return LOSSES[loss]
    except KeyError:
        raise ValueError(f"unknown loss {loss!r}") from None


def resolve_optimizer(optimizer, learning_rate=1e-3, **kwargs) -> Callable:
    """A factory ``params -> torch.optim.Optimizer``: an optimizer name of
    :data:`~dlwp_torch.train.optim.OPTIMIZERS` with ``learning_rate`` and
    the rule's keyword arguments, or such a callable as it is. The
    trainer calls it with the model's ``named_parameters()``."""
    if callable(optimizer):
        return optimizer
    try:
        rule = OPTIMIZERS[optimizer]
    except KeyError:
        raise ValueError(f"unknown optimizer {optimizer!r}") from None
    return lambda params: rule(params, learning_rate, **kwargs)


@dataclasses.dataclass
class TrainConfig:
    """Training configuration, with the JAX package's fields and defaults."""

    loss: Any = "mse"
    optimizer: Any = "adam"
    learning_rate: float = 1e-3
    weight_decay: float = 0.0  # optax add_decayed_weights in front
    epochs: int = 10
    batch_size: int = 64
    shuffle: bool = True
    # Early stopping:
    early_stopping: bool = False
    min_epochs: int = 0
    patience: int = 0
    monitor: str = "val_loss"
    restore_best_weights: bool = True
    # Multi-step sequence training:
    sequence_steps: int = 1
    # Validation-eval form, all three of the same value: 'forward' is the
    # train step's loss without the backward; 'outer' computes the
    # per-step losses after the rollout, over the stacked predictions.
    # 'grad' is, in the JAX package, the forward lowered under
    # value_and_grad with the gradients discarded: a workaround for a TPU
    # compile fault (its utils/compile_safe.py), which this package does
    # not port. Here it is the 'forward' form.
    eval_impl: str = "forward"
    seed: int = 0


class History:
    """Keras-History-like record of epoch metrics."""

    def __init__(self):
        self.history: dict[str, list[float]] = {}
        self.epoch: list[int] = []

    def append(self, epoch: int, metrics: dict[str, float]):
        self.epoch.append(epoch)
        for k, v in metrics.items():
            self.history.setdefault(k, []).append(float(v))


class EarlyStoppingMin:
    """Early stopping with a minimum-epoch floor and best-weights restore:
    no stop before ``min_epochs``; stop after ``patience`` epochs without
    improvement; keep a copy of the best parameters (a state dict)."""

    def __init__(self, monitor="val_loss", min_epochs=0, patience=0,
                 restore_best_weights=True, min_delta=0.0):
        self.monitor = monitor
        self.min_epochs = min_epochs
        self.patience = patience
        self.restore_best_weights = restore_best_weights
        self.min_delta = min_delta
        self.best = np.inf
        self.best_params = None
        self.wait = 0

    def update(self, epoch: int, metrics: dict[str, float], params) -> bool:
        """Returns True if training should stop. ``params``: a state dict."""
        current = metrics.get(self.monitor)
        if current is None:
            return False
        if current < self.best - self.min_delta:
            self.best = current
            self.wait = 0
            if self.restore_best_weights:
                self.best_params = {k: v.detach().clone()
                                    for k, v in params.items()}
        else:
            self.wait += 1
        return epoch + 1 >= self.min_epochs and self.wait > self.patience


class Trainer:
    """Training loop for a port ``SequentialModel``, on its device.

    Args:
        model: the model (``model.device`` is where batches go).
        config: TrainConfig.
        splice_fn: for sequence training, ``(current_input, prediction,
            step_index) -> next input``; default: the prediction itself.
        mesh / batch_spec / target_spec: the mesh the model's convs are
            sharded over, and the axis names of the input and target
            batches (tuples such as ``("data", None, None, "lat", None)``).
            ``batch_spec[0]`` names the data axis whose shards a batch must
            divide over in :meth:`fit`; without a ``target_spec``,
            sequence training (S > 1) shifts ``batch_spec``'s feature axes
            right by one for the target's step axis, as the JAX trainer
            does. The batches themselves stay whole on the model's device.
        metrics: ``{name: fn(y_true, y_pred)}``, recorded beside the loss.
    """

    def __init__(
        self,
        model,
        config: TrainConfig | None = None,
        splice_fn: Callable | None = None,
        mesh=None,
        batch_spec=None,
        target_spec=None,
        metrics: dict[str, Callable] | None = None,
    ):
        self.model = model
        self.config = config or TrainConfig()
        if self.config.eval_impl not in EVAL_IMPLS:
            raise ValueError(f"eval_impl must be one of {EVAL_IMPLS}")
        self.loss_fn = resolve_loss(self.config.loss)
        self.make_optimizer = resolve_optimizer(
            self.config.optimizer, self.config.learning_rate)
        self.splice_fn = splice_fn
        self.metrics = metrics or {}
        self.mesh = mesh
        self.batch_spec = self.target_spec = None
        if mesh is not None and batch_spec is not None:
            self.batch_spec = tuple(batch_spec)
            if (target_spec is None and self.config.sequence_steps > 1
                    and len(self.batch_spec) > 1):
                target_spec = (self.batch_spec[0], None) + self.batch_spec[1:]
            self.target_spec = (tuple(target_spec) if target_spec is not None
                                else self.batch_spec)
        # A mesh over several processes (its entries' ``ranks``): they start
        # from process 0's parameters and process 0 writes checkpoints.
        # Data parallelism across them: the batch spec's data axis spans
        # them, and gradients average over the processes along it.
        self._spans = mesh is not None and mesh.ranks is not None
        self._across = (self.batch_spec is not None
                        and mesh.spans_processes(self.batch_spec[0]))
        self._data_group = (process_group(mesh.line(self.batch_spec[0]))
                            if self._across else None)
        # The processes along the lat / lon axes (those that share this
        # one's data index) compute the same gradient; the card's
        # nondeterministic reductions (cuDNN's backward, atomics) may round
        # it differently on each, so each step takes the first one's.
        space = (mesh.plane(self.batch_spec[0] if self.batch_spec else None)
                 if self._spans else [])
        self._space = ((space[0], process_group(space)) if len(space) > 1
                       else None)
        self.optimizer = None
        self._warned_ragged = False
        if self._spans and model.built:
            broadcast_params(model)

    @property
    def device(self) -> torch.device:
        return self.model.device

    @property
    def params(self):
        """The model's state dict (live tensors), or None before
        parameters exist."""
        return self.model.state_dict() if self.model.built else None

    # ------------------------------------------------------------------ core
    def init(self, sample_x):
        """Random parameters from ``config.seed`` for layers that have none
        (loaded weights are kept), gradients on, and a fresh optimizer."""
        self.model.init(self._to_device(sample_x[:1]), seed=self.config.seed)
        if self._spans:
            broadcast_params(self.model)
        for p in self.model.parameters():
            p.requires_grad_(True)
        self.optimizer = self.make_optimizer(list(self.model.named_parameters()))
        return self.params

    def _to_device(self, a) -> torch.Tensor:
        """A batch as a tensor on the model's device, in the parameters'
        dtype once they exist. Host arrays go to a card through pinned
        memory without a host wait, so the host can queue the step behind
        the copy."""
        params = [p for p in self.model.parameters()]
        dtype = params[0].dtype if params else None
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.ascontiguousarray(a))
            if self.device.type == "cuda":
                a = a.pin_memory()
        return a.to(device=self.device, dtype=dtype or a.dtype,
                    non_blocking=True)

    def _forward_loss(self, x, y):
        """Single- or multi-step loss and prediction.

        For ``sequence_steps`` S > 1 the target carries a step axis at
        position 1, (B, S, ...). The model runs S times, each step's input
        spliced from the previous one and its prediction, each step under
        ``checkpoint`` while a gradient is recorded; the loss is the mean
        of the S step losses (equal weights)."""
        S = self.config.sequence_steps
        if S == 1:
            pred = self.model(x)
            return self.loss_fn(y, pred), pred
        splice = self.splice_fn or (lambda inp, pred, k: pred)
        remat = torch.is_grad_enabled()
        inp, losses, preds = x, [], []
        for k in range(S):
            pred = (checkpoint(self.model, inp, use_reentrant=False) if remat
                    else self.model(inp))
            losses.append(self.loss_fn(y[:, k], pred))
            preds.append(pred)
            inp = splice(inp, pred, k)
        return torch.stack(losses).mean(), torch.stack(preds, dim=1)

    def _forward_loss_outer(self, x, y):
        """The same value as :meth:`_forward_loss`, the step losses taken
        after the rollout over the stacked predictions."""
        S = self.config.sequence_steps
        if S == 1:
            pred = self.model(x)
            return self.loss_fn(y, pred), pred
        splice = self.splice_fn or (lambda inp, pred, k: pred)
        inp, preds = x, []
        for k in range(S):
            pred = self.model(inp)
            preds.append(pred)
            inp = splice(inp, pred, k)
        preds = torch.stack(preds, dim=1)
        losses = torch.stack([self.loss_fn(y[:, k], preds[:, k])
                              for k in range(S)])
        return losses.mean(), preds

    def _own_block(self, batch):
        """This process's block of a global batch where the data axis
        spans processes (the whole batch otherwise)."""
        if not self._across:
            return batch
        axis = self.batch_spec[0]
        n = self.mesh.shape[axis]
        if len(batch) % n:
            raise ValueError(f"a batch of {len(batch)} does not divide over "
                             f"{n} data shards")
        start, stop = self.mesh.process_rows(axis)
        b = len(batch) // n
        return batch[start * b:stop * b]

    def train_step(self, x, y) -> dict[str, torch.Tensor]:
        """One optimizer step on a batch (host arrays or tensors); returns
        the batch's loss and metrics as 0-d tensors on the device. After it,
        each parameter's ``grad`` holds this step's gradient (with
        ``weight_decay`` added when it is set). Across processes ``x`` and
        ``y`` are the global batch: the process steps on its own block,
        and the gradient, loss and metrics are the means over processes."""
        if self.optimizer is None:
            self.init(x)
        x = self._to_device(self._own_block(x))
        y = self._to_device(self._own_block(y))
        params = [p for group in self.optimizer.param_groups
                  for p in group["params"]]
        for p in params:
            p.grad = None
        loss, pred = self._forward_loss(x, y)
        loss.backward()
        out = {"loss": loss.detach()}
        with torch.no_grad():
            for name, fn in self.metrics.items():
                out[name] = fn(y, pred.detach())
        if self._across or self._space is not None:
            self._share(params, out)
        if self.config.weight_decay:
            add_decayed_weights(params, self.config.weight_decay)
        self.optimizer.step()
        return out

    @torch.no_grad()
    def _share(self, params, out: dict) -> None:
        """Gradients, loss and metrics made the same on every process:
        their means over the data axis's processes (one ``all_reduce``),
        then, where the lat or lon axis spans processes, the first such
        process's (one broadcast)."""
        have = [p for p in params if p.grad is not None]
        dtype = out["loss"].dtype
        stats = torch.stack([v.to(dtype) for v in out.values()])
        tensors = [p.grad for p in have] + [stats]
        if self._across:
            tensors = all_reduce_mean(tensors, self._data_group)
        if self._space is not None:
            tensors = broadcast_flat(tensors, *self._space)
        *grads, stats = tensors
        for p, g in zip(have, grads):
            p.grad = g
        for k, v in zip(list(out), stats):
            out[k] = v.to(out[k].dtype)

    @torch.no_grad()
    def _eval_step(self, x, y):
        if self.config.eval_impl == "outer":
            loss, pred = self._forward_loss_outer(x, y)
        else:
            loss, pred = self._forward_loss(x, y)
        out = {"loss": loss}
        for name, fn in self.metrics.items():
            out[name] = fn(y, pred)
        return out

    def _ragged(self, batch) -> bool:
        """Whether a batch does not divide over the data shards of the
        batch spec (warned once): :meth:`fit` drops it, as the JAX
        trainer's drop_remainder rule does."""
        if self.batch_spec is None or self.batch_spec[0] is None:
            return False
        n_shards = self.mesh.shape.get(self.batch_spec[0], 1)
        if len(batch) % n_shards == 0:
            return False
        if not self._warned_ragged:
            self._warned_ragged = True
            warnings.warn(
                f"dropping ragged batch of {len(batch)} samples not "
                f"divisible by {n_shards} data shards; pad the dataset or "
                "pick a divisible batch size to train on every sample",
                stacklevel=3)
        return True

    def _stopper(self):
        cfg = self.config
        return (EarlyStoppingMin(cfg.monitor, cfg.min_epochs, cfg.patience,
                                 cfg.restore_best_weights)
                if cfg.early_stopping else None)

    def _resume(self, checkpoint_dir, resume, verbose) -> int:
        """Restore the latest checkpoint of ``checkpoint_dir`` when asked;
        returns the epoch to start from."""
        if not (checkpoint_dir and resume):
            return 0
        from dlwp_torch.train.checkpoint import restore_checkpoint

        try:
            state, meta = restore_checkpoint(checkpoint_dir,
                                             device=self.device)
        except FileNotFoundError:
            return 0
        self.model.load_state_dict(state["params"])
        self.optimizer.load_state_dict(state["opt_state"])
        start_epoch = int(meta.get("epoch", -1)) + 1
        if verbose:
            print(f"resumed from epoch {start_epoch}")
        return start_epoch

    def _end_epoch(self, run: dict, epoch: int, metrics: dict,
                   t0: float) -> bool:
        """What follows an epoch's steps in both drivers: the non-finite
        loss check, validation, the history, callbacks, the checkpoint and
        early stopping. Returns True when training stops."""
        stopper = run["stopper"]

        def restore_best():
            if (stopper is not None and stopper.restore_best_weights
                    and stopper.best_params is not None):
                self.model.load_state_dict(stopper.best_params)

        if not np.isfinite(metrics.get("loss", 0.0)):
            print(f"non-finite loss at epoch {epoch + 1}; stopping")
            restore_best()
            run["history"].append(epoch, metrics)
            return True
        if run["validation_data"] is not None:
            metrics.update({
                f"val_{k}": v for k, v in self.evaluate(
                    run["validation_data"],
                    batch_size=run["eval_batch_size"]).items()
            })
        metrics["time"] = time.time() - t0
        run["history"].append(epoch, metrics)
        for cb in run["callbacks"]:
            cb(epoch, metrics, self.params)
        if (run["checkpoint_dir"]
                and (epoch + 1) % run["checkpoint_every"] == 0):
            from dlwp_torch.train.checkpoint import save_checkpoint

            if not self._spans or is_primary():
                save_checkpoint(
                    run["checkpoint_dir"], self.model.state_dict(),
                    self.optimizer.state_dict(), step=epoch,
                    metadata={"epoch": epoch, **metrics},
                )
            if self._spans:
                torch.distributed.barrier()
        if run["verbose"]:
            desc = " ".join(f"{k}={v:.6g}" for k, v in metrics.items())
            print(f"epoch {epoch + 1}/{run['epochs']}: {desc}")
        if stopper is not None and stopper.update(
                epoch, metrics, self.model.state_dict()):
            restore_best()
            if run["verbose"]:
                print(f"early stopping at epoch {epoch + 1}")
            return True
        return False

    # ------------------------------------------------------------------ API
    def fit(
        self,
        x=None,
        y=None,
        generator: Iterable | None = None,
        validation_data=None,
        epochs: int | None = None,
        batch_size: int | None = None,
        verbose: bool = True,
        callbacks: list | None = None,
        checkpoint_dir: str | None = None,
        checkpoint_every: int = 1,
        resume: bool = False,
    ) -> History:
        """Train from arrays or a batch generator.

        ``generator`` yields (x_batch, y_batch) and supports len() and
        re-iteration each epoch (the Keras ``Sequence`` protocol, as
        :class:`~dlwp_torch.data.sampler.SeriesSampler`). A
        :class:`~dlwp_torch.data.device_sampler.DeviceSeriesSampler` goes
        to :meth:`fit_device`, unless a callback has ``on_batch`` (which
        reads each batch's loss). Array batches come in the order of
        ``np.random.RandomState(config.seed)`` shuffles.
        ``validation_data`` is (x, y) arrays or a generator. The epoch
        metric is the unweighted mean of the batch losses. Training stops
        on a non-finite epoch loss.

        ``checkpoint_dir``: save the parameters and optimizer state every
        ``checkpoint_every`` epochs; with ``resume=True``, restore the
        latest checkpoint and continue from the epoch after it. A resumed
        run sees the batches the uninterrupted run would have seen: the
        array shuffle, and a generator's ``on_epoch_end`` order, advance
        once per completed epoch (as the JAX package's ``fit_device``
        realigns its shuffle; its per-batch ``fit`` does not).
        """
        if generator is not None and hasattr(generator, "gather") and not any(
                hasattr(cb, "on_batch") for cb in callbacks or []):
            return self.fit_device(
                generator, epochs=epochs, verbose=verbose,
                callbacks=callbacks, validation_data=validation_data,
                checkpoint_dir=checkpoint_dir,
                checkpoint_every=checkpoint_every, resume=resume)
        cfg = self.config
        batch_size = batch_size or cfg.batch_size
        run = dict(epochs=epochs or cfg.epochs, history=History(),
                   stopper=self._stopper(), callbacks=callbacks or [],
                   validation_data=validation_data,
                   eval_batch_size=batch_size, checkpoint_dir=checkpoint_dir,
                   checkpoint_every=checkpoint_every, verbose=verbose)
        rng = np.random.RandomState(cfg.seed)

        if self.optimizer is None:
            if generator is not None:
                x0, _ = (generator[0] if hasattr(generator, "__getitem__")
                         else next(iter(generator)))
            else:
                x0 = x[:1]
            self.init(x0)

        start_epoch = self._resume(checkpoint_dir, resume, verbose)
        for _ in range(start_epoch):
            if generator is None and cfg.shuffle:
                rng.shuffle(np.arange(len(x)))
            elif generator is not None and hasattr(generator, "on_epoch_end"):
                generator.on_epoch_end()

        n = None if x is None else len(x)
        for epoch in range(start_epoch, run["epochs"]):
            t0 = time.time()
            train_metrics: dict[str, list] = {}
            if generator is not None:
                epoch_iter = iter(generator)
            else:
                idx = np.arange(n)
                if cfg.shuffle:
                    rng.shuffle(idx)
                epoch_iter = (
                    (x[idx[i:i + batch_size]], y[idx[i:i + batch_size]])
                    for i in range(0, n, batch_size)
                )
            for xb, yb in epoch_iter:
                if self._ragged(xb):
                    continue
                m = self.train_step(xb, yb)
                for k, v in m.items():
                    train_metrics.setdefault(k, []).append(v)
                for cb in run["callbacks"]:
                    if hasattr(cb, "on_batch"):
                        cb.on_batch(float(m["loss"]))
            metrics = {k: _mean(vs) for k, vs in train_metrics.items()}
            if self._end_epoch(run, epoch, metrics, t0):
                break
        return run["history"]

    def fit_device(
        self,
        sampler,
        epochs: int | None = None,
        verbose: bool = True,
        callbacks: list | None = None,
        validation_data=None,
        checkpoint_dir: str | None = None,
        checkpoint_every: int = 1,
        resume: bool = False,
    ) -> History:
        """Train over a :class:`~dlwp_torch.data.device_sampler.
        DeviceSeriesSampler` whose series lives on the model's device.

        Each epoch the window starts of ``sampler._index_pool``, shuffled
        by the wrapped sampler's own RNG when its ``shuffle`` is on, go to
        the device once as one (batches, B) int32 tensor; then
        :meth:`_device_epoch` gathers each batch there and steps on it,
        reading nothing back to the host. The per-step losses come down
        once, at the epoch's end; their mean is the epoch's loss, and a
        non-finite one stops training. The ragged last batch is dropped.
        Validation, callbacks, checkpoints and early stopping run as in
        :meth:`fit`. A resumed run advances the RNG once per completed
        epoch, so it sees the batches the uninterrupted run would have.
        """
        cfg = self.config
        base = getattr(sampler, "sampler", None)
        if base is not None and hasattr(base, "_shuffle"):
            do_shuffle, rng = bool(base._shuffle), base._rng
        else:
            do_shuffle, rng = cfg.shuffle, np.random.RandomState(cfg.seed)
        if self.optimizer is None:
            self.init(sampler[0][0])
        nb, bsz = len(sampler), sampler._batch
        if nb < 1:
            raise ValueError("sampler yields no full batches")
        run = dict(epochs=epochs or cfg.epochs, history=History(),
                   stopper=self._stopper(), callbacks=callbacks or [],
                   validation_data=validation_data, eval_batch_size=bsz,
                   checkpoint_dir=checkpoint_dir,
                   checkpoint_every=checkpoint_every, verbose=verbose)
        start_epoch = self._resume(checkpoint_dir, resume, verbose)
        base_idx = np.asarray(sampler._index_pool, dtype=np.int32)
        if do_shuffle:
            for _ in range(start_epoch):
                rng.shuffle(base_idx.copy())
        for epoch in range(start_epoch, run["epochs"]):
            t0 = time.time()
            idx = base_idx.copy()
            if do_shuffle:
                rng.shuffle(idx)
            idx = torch.from_numpy(idx[:nb * bsz].reshape(nb, bsz)).to(
                self.device)
            steps = self._device_epoch(sampler, idx)
            metrics = {k: _mean([m[k] for m in steps]) for k in steps[0]}
            if self._end_epoch(run, epoch, metrics, t0):
                break
        return run["history"]

    def _device_epoch(self, sampler, idx: torch.Tensor) -> list[dict]:
        """The train steps of one epoch, a batch gathered on the device for
        each row of ``idx`` (window starts on the device): each step's
        metrics as 0-d tensors on the device. Nothing is read back."""
        return [self.train_step(*sampler.gather(samples)) for samples in idx]

    def evaluate(self, data, batch_size: int = 64) -> dict[str, float]:
        """Mean over batches of the loss and metrics, without gradients
        (the kernels run): ``data`` is (x, y) arrays or a generator."""
        if isinstance(data, tuple):
            x, y = data
            batches = ((x[i:i + batch_size], y[i:i + batch_size])
                       for i in range(0, len(x), batch_size))
        else:
            batches = iter(data)
        out: dict[str, list] = {}
        for xb, yb in batches:
            m = self._eval_step(self._to_device(xb), self._to_device(yb))
            for k, v in m.items():
                out.setdefault(k, []).append(v)
        return {k: _mean(v) for k, v in out.items()}

    @torch.inference_mode()
    def predict(self, x, batch_size: int = 64) -> np.ndarray:
        """The model's output for host array ``x``, ``batch_size`` samples
        a call on the model's device, as a host numpy array."""
        return np.concatenate([
            self.model(self._to_device(np.asarray(x[i:i + batch_size])))
            .cpu().numpy()
            for i in range(0, len(x), batch_size)])


def _mean(values) -> float:
    """The unweighted mean of per-batch 0-d tensors, taken on the host in
    their dtype."""
    return float(np.mean(torch.stack(values).cpu().numpy()))


__all__ = [
    "EarlyStoppingMin",
    "History",
    "LOSSES",
    "TrainConfig",
    "Trainer",
    "resolve_loss",
    "resolve_optimizer",
]
