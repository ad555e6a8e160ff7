#!/usr/bin/env python
"""Spherical-CNN training workflow (the s2cnn path).

Equivalent of the reference's ``examples/train_torch.py``: the same
architecture -- two spherical convolutions that carry features from the
data grid down to a working bandwidth, a flatten, and a linear read-out
back to the predictor shape (``train_torch.py:100-114``) -- built through
the declarative spec path with the spectral
:class:`~dlwp_torch.models.spherical.S2Convolution` layers (gamma-averaged
s2cnn semantics computed as per-degree contractions). The spherical
layers are ordinary modules, so the standard :class:`DLWPNeuralNet`
training and serving stack applies unchanged. No hand kernel runs here:
the contractions are cuBLAS matrix products on a card.

Flags as in the JAX package's script, plus ``--device``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def build_layer_specs(c_in, c_out, nlat, nlon, b_in, truncation, features):
    """The reference spherical stack (train_torch.py:100-114), spec-for-spec."""
    from dlwp_torch.models.spherical import s2_near_identity_grid

    s2_grid = s2_near_identity_grid(max_beta=0.2, n_alpha=12, n_beta=1)
    n_features = c_out * nlat * nlon
    return [
        ("S2Convolution", (c_in, features, b_in, truncation, s2_grid),
         {"mean_gamma": True, "activation": "tanh"}),
        ("S2Convolution", (features, features, truncation, truncation, s2_grid),
         {"mean_gamma": True, "activation": "tanh"}),
        ("TorchReshape", ((-1, features * (2 * truncation) ** 2),), None),
        ("Linear", (features * (2 * truncation) ** 2, n_features), None),
        ("TorchReshape", ((-1, c_out, nlat, nlon), ), None),
    ]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--predictor-file", default=None)
    p.add_argument("--model-file", default="dlwp_spherical_model")
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--learning-rate", type=float, default=1e-3)
    p.add_argument("--input-time-steps", type=int, default=2)
    p.add_argument("--output-time-steps", type=int, default=2)
    p.add_argument("--b-in", type=int, default=None,
                   help="input bandwidth (default: max the grid supports, "
                        "cf. 36 in train_torch.py:101)")
    p.add_argument("--truncation", type=int, default=12,
                   help="working bandwidth between the spherical layers "
                        "(train_torch.py:101)")
    p.add_argument("--features", type=int, default=16,
                   help="spherical feature channels (train_torch.py:103)")
    p.add_argument("--validation-fraction", type=float, default=0.2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' for the CPU)")
    return p.parse_args(argv)


def main(argv=None):
    """Train and save the model; returns ``(model, history)``."""
    args = parse_args(argv)
    from dlwp_torch.data import SeriesSampler
    from dlwp_torch.device import resolve_device
    from dlwp_torch.examples._synthetic import load_or_synthetic
    from dlwp_torch.models import DLWPNeuralNet
    from dlwp_torch.utils import save_model, train_test_split_ind

    device = resolve_device(args.device)
    data = load_or_synthetic(
        args.predictor_file,
        "no --predictor-file given; using synthetic demo data")

    n = data.predictors.shape[0]
    n_val = int(n * args.validation_fraction)
    train_idx, val_idx = train_test_split_ind(n, n_val, method="last")
    train_data = data.isel_sample(train_idx)
    val_data = data.isel_sample(val_idx)

    dlwp = DLWPNeuralNet(
        is_convolutional=True, time_dim=args.input_time_steps,
        scaler_type=None, device=device,
    )
    mk = lambda d, shuffle: SeriesSampler(
        d, model=dlwp,
        input_time_steps=args.input_time_steps,
        output_time_steps=args.output_time_steps,
        batch_size=args.batch_size, shuffle=shuffle, seed=args.seed,
    )
    train_gen = mk(train_data, True)
    val_gen = mk(val_data, False)

    c_in, nlat, nlon = train_gen.convolution_shape
    c_out = train_gen.output_convolution_shape[0]
    b_in = args.b_in or (min(nlat - 1, nlon // 2) + 1)

    dlwp.build_model(
        build_layer_specs(c_in, c_out, nlat, nlon,
                          b_in, args.truncation, args.features),
        loss="mse", optimizer="adam", learning_rate=args.learning_rate,
        seed=args.seed,
    )

    t0 = time.time()
    history = dlwp.fit_generator(
        train_gen, validation_data=val_gen, epochs=args.epochs, verbose=True,
    )
    print(f"Train time -- {time.time() - t0:.0f} seconds")

    save_model(dlwp, args.model_file, history=history)
    print(f"saved model to {args.model_file}.pkl/.params")

    # Quick forecast sanity: one prediction batch round-trips the shape.
    x, _ = val_gen[0]
    pred = dlwp.predict(x)
    print("prediction shape:", np.asarray(pred).shape)
    return dlwp, history


if __name__ == "__main__":
    main()
