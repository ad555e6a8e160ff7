#!/usr/bin/env python
"""Multi-step ("functional") sequence training.

Equivalent of the reference's ``examples/train_functional.py``: the model is
trained on ``--sequence`` consecutive forecast steps jointly, with equal
loss weights (reference train_functional.py:61, 283-285). Where the
reference builds a Keras functional graph with chained shared layers, here
the rollout runs inside the loss (Trainer.sequence_steps), each step
recomputed in the backward.

Flags as in the JAX package's script, plus ``--device``.
"""

from __future__ import annotations

import argparse
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--predictor-file", default=None)
    p.add_argument("--model-file", default="dlwp_functional_model")
    p.add_argument("--epochs", type=int, default=8)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--sequence", type=int, default=4,
                   help="jointly trained forecast steps")
    p.add_argument("--learning-rate", type=float, default=1e-3)
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
    from dlwp_torch.utils import save_model

    device = resolve_device(args.device)
    data = load_or_synthetic(args.predictor_file)

    dlwp = DLWPNeuralNet(time_dim=1, scaler_type=None, device=device)
    sampler = SeriesSampler(
        data, model=dlwp, sequence=args.sequence,
        batch_size=args.batch_size, shuffle=True,
    )
    c = sampler.convolution_shape[0]
    dlwp.build_model(
        [("CyclicConv2D", (32, 3), {"activation": "tanh"}),
         ("CyclicConv2D", (64, 3), {"activation": "tanh"}),
         ("CyclicConv2D", (c, 3), {})],
        loss="mse", learning_rate=args.learning_rate,
        sequence_steps=args.sequence,
    )
    t0 = time.time()
    history = dlwp.fit_generator(sampler, epochs=args.epochs, verbose=True)
    print(f"Train time -- {time.time() - t0:.0f} seconds")
    save_model(dlwp, args.model_file, history=history)
    print(f"saved {args.model_file}")
    return dlwp, history


if __name__ == "__main__":
    main()
