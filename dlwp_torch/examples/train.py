#!/usr/bin/env python
"""Canonical CNN training workflow.

Equivalent of the reference's ``examples/train.py`` (and the
argparse-configurable ``Azure/train_tf.py``): predictor file ->
SeriesSampler -> fused spherical-CNN tower -> training with early stopping
-> saved model. Typed flags replace the reference's '#%% Parameters' block.
On a card the tower's conv + pool stages run the ``fused_conv_pool`` kernel
in validation and forecasts (a train step differentiates their
composition).

Flags as in the JAX package's script, plus ``--device``. Run with
``--device cpu`` and no other argument for a quick synthetic demo.
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--predictor-file", default=None,
                   help="series-format predictor HDF5 (default: synthetic)")
    p.add_argument("--model-file", default="dlwp_cnn_model",
                   help="output model path prefix")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--learning-rate", type=float, default=1e-3)
    p.add_argument("--min-epochs", type=int, default=0)
    p.add_argument("--patience", type=int, default=5)
    p.add_argument("--input-time-steps", type=int, default=2)
    p.add_argument("--output-time-steps", type=int, default=2)
    p.add_argument("--add-insolation", action="store_true", default=True)
    p.add_argument("--validation-fraction", type=float, default=0.2)
    p.add_argument("--loss", default="lat_mse",
                   choices=["mse", "mae", "lat_mse", "acc"])
    p.add_argument("--crop-north-pole", action="store_true", default=True,
                   help="drop the 90N row (reference train.py:86-87)")
    p.add_argument("--device-resident", action="store_true",
                   help="put the whole series on the device and assemble "
                        "batches there (DeviceSeriesSampler)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="write a checkpoint every --checkpoint-every "
                        "epochs (mid-training checkpointing; the reference "
                        "saves only at the end, util.py:126-192)")
    p.add_argument("--checkpoint-every", type=int, default=1)
    p.add_argument("--resume", action="store_true",
                   help="restore the latest checkpoint in --checkpoint-dir "
                        "and continue from its epoch")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "PyTorch versions of the kernels)")
    return p.parse_args(argv)


def build_layer_specs(c_in, c_out):
    """The reference tower (train.py:142-221) in fused layers."""
    return [
        ("CyclicConv2D", (32, 3), {"dilation": 2, "activation": "tanh"}),
        ("MaxPooling2D", (2,), None),
        ("CyclicConv2D", (64, 3), {"activation": "tanh"}),
        ("MaxPooling2D", (2,), None),
        ("CyclicConv2D", (128, 3), {"activation": "tanh"}),
        ("UpSampling2D", (2,), None),
        ("CyclicConv2D", (64, 3), {"activation": "tanh"}),
        ("UpSampling2D", (2,), None),
        ("CyclicConv2D", (32, 3), {"dilation": 2, "activation": "tanh"}),
        ("CyclicConv2D", (c_out, 5), {"activation": "linear"}),
    ]


def main(argv=None):
    """Train and save the model; returns ``(model, history)``."""
    args = parse_args(argv)
    from dlwp_torch.data import DeviceSeriesSampler, SeriesSampler
    from dlwp_torch.device import resolve_device
    from dlwp_torch.examples._synthetic import load_or_synthetic
    from dlwp_torch.models import DLWPNeuralNet
    from dlwp_torch.ops.losses import (
        anomaly_correlation_loss, latitude_weighted_loss, mse,
    )
    from dlwp_torch.utils import save_model, train_test_split_ind

    device = resolve_device(args.device)
    data = load_or_synthetic(
        args.predictor_file,
        "no --predictor-file given; using synthetic demo data")

    if args.crop_north_pole and data.lat[0] == 90.0:
        data.predictors = np.asarray(data.predictors)[..., 1:, :]
        data.lat = data.lat[1:]

    n = data.predictors.shape[0]
    n_val = int(n * args.validation_fraction)
    train_idx, val_idx = train_test_split_ind(n, n_val, method="last")
    train_data = data.isel_sample(train_idx)
    val_data = data.isel_sample(val_idx)

    dlwp = DLWPNeuralNet(
        is_convolutional=True, time_dim=args.input_time_steps,
        scaler_type=None,  # predictor files are pre-scaled
        device=device,
    )
    mk = lambda d, shuffle: SeriesSampler(
        d, model=dlwp,
        input_time_steps=args.input_time_steps,
        output_time_steps=args.output_time_steps,
        add_insolation=args.add_insolation,
        batch_size=args.batch_size, shuffle=shuffle, seed=args.seed,
    )
    train_gen = mk(train_data, True)
    val_gen = mk(val_data, False)
    if args.device_resident:
        train_gen = DeviceSeriesSampler(train_gen, device=device)
        val_gen = DeviceSeriesSampler(val_gen, device=device)

    c_in = train_gen.convolution_shape[0]
    c_out = train_gen.output_convolution_shape[0]
    if args.loss == "lat_mse":
        loss = latitude_weighted_loss(mse, data.lat)
    elif args.loss == "acc":
        loss = anomaly_correlation_loss(regularize_mean="mse")
    else:
        loss = args.loss

    dlwp.build_model(
        build_layer_specs(c_in, c_out),
        loss=loss, optimizer="adam", learning_rate=args.learning_rate,
        early_stopping=True, min_epochs=args.min_epochs,
        patience=args.patience, seed=args.seed,
    )

    ckpt_kwargs = {}
    if args.checkpoint_dir:
        ckpt_kwargs = dict(
            checkpoint_dir=args.checkpoint_dir,
            checkpoint_every=args.checkpoint_every,
            resume=args.resume,
        )
    t0 = time.time()
    history = dlwp.fit_generator(
        train_gen, validation_data=val_gen, epochs=args.epochs, verbose=True,
        **ckpt_kwargs,
    )
    print(f"Train time -- {time.time() - t0:.0f} seconds")

    save_model(dlwp, args.model_file, history=history)
    print(f"saved model to {args.model_file}.pkl/.params")
    return dlwp, history


if __name__ == "__main__":
    main()
