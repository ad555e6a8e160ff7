#!/usr/bin/env python
"""ConvLSTM-front-end training workflow (the canonical configuration).

The reference's canonical full architecture (examples/train.py:142-221):
a convolutional LSTM over the input time steps feeding the
conv-pool-upsample tower. The recurrent path uses the is_recurrent batch
layout (B, T, C, H, W); the ConvLSTM applies spherical boundaries on both
the input *and* recurrent convolutions and its per-step outputs are
flattened into the tower's channels, mirroring the reference's Reshape
bridge (train.py:158). On a card every train step runs the ``lstm_gates``
kernel, and validation also the ``fused_conv_pool`` kernel.

``--sequence k`` additionally trains k forecast iterations jointly with
equal loss weights (the reference's functional multi-step training,
train_functional.py:61,283-285): the rollout runs inside the loss, each
step recomputed in the backward. With an insolation input channel the
splice persists the last known insolation (the recomputation per valid
time is the *forecast*-time behavior, dlwp_torch.forecast).

Flags as in the JAX package's script, plus ``--device``. ``--eval-impl
auto`` is 'forward' (the JAX script picks 'grad' only on a TPU, to avoid
a fault of that platform).
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def convlstm_tower(time_steps, c_in, c_out, lstm_features):
    """ConvLSTM front end + fused tower (reference train.py:142-221)."""
    return [
        ("ConvLSTM2D", (lstm_features, 3),
         {"dilation": 2, "activation": "tanh", "return_sequences": True}),
        ("Reshape", ((time_steps * lstm_features, -1),), None),
        ("CyclicConv2D", (32, 3), {"dilation": 2, "activation": "tanh"}),
        ("MaxPooling2D", (2,), None),
        ("CyclicConv2D", (64, 3), {"activation": "tanh"}),
        ("UpSampling2D", (2,), None),
        ("CyclicConv2D", (32, 3), {"dilation": 2, "activation": "tanh"}),
        ("CyclicConv2D", (c_out, 5), {"activation": "linear"}),
    ]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--predictor-file", default=None)
    p.add_argument("--model-file", default="dlwp_convlstm_model")
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--time-steps", type=int, default=2)
    p.add_argument("--lstm-features", type=int, default=None,
                   help="default 4*(C+1) per the reference (train.py:149)")
    p.add_argument("--sequence", type=int, default=1,
                   help="jointly trained forecast iterations "
                        "(train_functional.py:61)")
    p.add_argument("--add-insolation", dest="add_insolation",
                   action="store_true", default=True)
    p.add_argument("--no-insolation", dest="add_insolation",
                   action="store_false")
    p.add_argument("--learning-rate", type=float, default=1e-3)
    p.add_argument("--cosine-decay", action="store_true",
                   help="cosine LR decay to 5%% over the run + grad clip")
    p.add_argument("--validation-fraction", type=float, default=0.0,
                   help="hold out the series tail for val_loss/early stop")
    p.add_argument("--no-val-eval", action="store_true",
                   help="hold the tail out of training but skip the "
                        "per-epoch evaluation pass (validate separately "
                        "with dlwp_torch.examples.validate)")
    p.add_argument("--eval-impl", default="auto",
                   choices=["auto", "forward", "outer", "grad"],
                   help="validation-eval form: 'forward' (the sequence "
                        "loss inside the rollout), 'outer' (the step "
                        "losses after it) or 'grad' (the train step's "
                        "form, gradients discarded); 'auto' is 'forward'")
    p.add_argument("--min-epochs", type=int, default=0)
    p.add_argument("--patience", type=int, default=0)
    p.add_argument("--loss", default="mse", choices=["mse", "lat_mse"])
    p.add_argument("--device-resident", action="store_true",
                   help="put the whole series on the device and assemble "
                        "batches there; each epoch's steps read nothing "
                        "back (DeviceSeriesSampler + Trainer.fit_device)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="write a checkpoint of {params, opt_state} every "
                        "--checkpoint-every epochs (mid-training "
                        "checkpointing the reference lacks -- it saves only "
                        "at the end, util.py:126-192)")
    p.add_argument("--checkpoint-every", type=int, default=1)
    p.add_argument("--resume", action="store_true",
                   help="restore the latest checkpoint in --checkpoint-dir "
                        "and continue from its epoch")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "PyTorch versions of the kernels)")
    return p.parse_args(argv)


def main(argv=None):
    """Train and save the model; returns ``(model, history)``."""
    args = parse_args(argv)
    from dlwp_torch.data import DeviceSeriesSampler, SeriesSampler
    from dlwp_torch.device import resolve_device
    from dlwp_torch.examples._synthetic import load_or_synthetic
    from dlwp_torch.models import DLWPNeuralNet
    from dlwp_torch.utils import save_model, train_test_split_ind

    device = resolve_device(args.device)
    data = load_or_synthetic(args.predictor_file)

    # Pole crop to even latitude count for the pool/upsample tower
    # (reference train.py:86-87).
    if data.predictors.shape[-2] % 2:
        data.predictors = np.asarray(data.predictors)[..., 1:, :]
        data.lat = data.lat[1:]

    n = data.predictors.shape[0]
    if args.validation_fraction > 0:
        n_val = int(n * args.validation_fraction)
        tr_idx, val_idx = train_test_split_ind(n, n_val, method="last")
        train_data = data.isel_sample(tr_idx)
        val_data = data.isel_sample(val_idx)
    else:
        train_data, val_data = data, None

    dlwp = DLWPNeuralNet(
        is_convolutional=True, is_recurrent=True,
        time_dim=args.time_steps, scaler_type=None, device=device,
    )
    mk = lambda d, shuffle: SeriesSampler(
        d, model=dlwp,
        input_time_steps=args.time_steps,
        output_time_steps=args.time_steps,
        sequence=args.sequence if args.sequence > 1 else None,
        add_insolation=args.add_insolation,
        batch_size=args.batch_size, shuffle=shuffle, seed=args.seed,
    )
    sampler = mk(train_data, True)
    val_gen = (
        mk(val_data, False)
        if val_data is not None and not args.no_val_eval
        else None
    )
    # Recurrent layout: (B, T, C, H, W) in; targets keep the time axis too.
    T, C, H, W = sampler.convolution_shape
    out_t, out_c = sampler.output_convolution_shape[:2]
    lstm_features = args.lstm_features or 4 * C
    specs = convlstm_tower(T, C, out_t * out_c, lstm_features)
    # Fix the Reshape bridge (spec index 1, after the ConvLSTM) to
    # concrete spatial dims, and reshape the tower output back to the
    # (T, C, H, W) target layout.
    specs[1] = ("Reshape", ((T * lstm_features, H, W),), None)
    specs.append(("Reshape", ((out_t, out_c, H, W),), None))

    splice_fn = None
    if args.sequence > 1 and args.add_insolation:
        # Persist the insolation forcing channel when feeding predictions
        # back inside the training rollout (forecasts recompute it for
        # each valid time; training uses the last known forcing).
        def splice_fn(inp, pred, k):  # noqa: F811
            import torch

            return torch.cat([pred, inp[:, :, out_c:]], dim=2)

    if args.loss == "lat_mse":
        from dlwp_torch.ops.losses import latitude_weighted_loss, mse

        loss = latitude_weighted_loss(mse, train_data.lat)
    else:
        loss = args.loss

    if args.cosine_decay:
        from dlwp_torch.train import (chain, clip_by_global_norm,
                                      cosine_decay_schedule)
        from dlwp_torch.train.optim import adam

        steps_total = max(1, len(sampler) * args.epochs)
        optimizer = chain(
            clip_by_global_norm(1.0),
            adam(cosine_decay_schedule(args.learning_rate, steps_total, 0.05)),
        )
    else:
        optimizer = "adam"

    eval_impl = "forward" if args.eval_impl == "auto" else args.eval_impl
    dlwp.build_model(
        specs, loss=loss, optimizer=optimizer,
        learning_rate=args.learning_rate,
        sequence_steps=args.sequence, splice_fn=splice_fn,
        early_stopping=args.patience > 0, min_epochs=args.min_epochs,
        patience=args.patience, seed=args.seed, eval_impl=eval_impl,
    )
    if args.device_resident:
        sampler = DeviceSeriesSampler(sampler, device=device)
        if val_gen is not None:
            val_gen = DeviceSeriesSampler(val_gen, device=device)
    ckpt_kwargs = {}
    if args.checkpoint_dir:
        ckpt_kwargs = dict(
            checkpoint_dir=args.checkpoint_dir,
            checkpoint_every=args.checkpoint_every,
            resume=args.resume,
        )
    t0 = time.time()
    history = dlwp.fit_generator(
        sampler, validation_data=val_gen, epochs=args.epochs, verbose=True,
        **ckpt_kwargs,
    )
    print(f"Train time -- {time.time() - t0:.0f} seconds")
    save_model(dlwp, args.model_file, history=history)
    print(f"saved {args.model_file}")
    return dlwp, history


if __name__ == "__main__":
    main()
