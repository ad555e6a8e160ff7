#!/usr/bin/env python
"""Derive a thickness variable into an existing predictor file.

Equivalent of the reference's ``examples/add_thickness.py``: compute layer
thickness THICK = z(upper level) - z(lower level) from two height channels
already in the file, appending the new channel with freshly computed
mean/std (reference add_thickness.py:44-46). Host only (numpy and h5py):
no device flag.
"""

from __future__ import annotations

import argparse

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("predictor_file")
    p.add_argument("--upper", default="HGT/300",
                   help="varlev of the upper (lower-pressure) height")
    p.add_argument("--lower", default="HGT/700",
                   help="varlev of the lower (higher-pressure) height")
    p.add_argument("--name", default=None,
                   help="output varlev name (default THICK/<up>-<low>)")
    p.add_argument("--output-file", default=None,
                   help="default: rewrite in place")
    return p.parse_args(argv)


def add_thickness(data, upper, lower, name=None):
    """Append ``upper - lower`` (physical units), scaled by its own mean
    and std, to ``data`` as channel ``name``; returns ``(name, mean,
    std)``."""
    iu = data.varlev.index(upper)
    il = data.varlev.index(lower)
    arr = np.asarray(data.predictors)
    phys = arr * data.std[:, None, None] + data.mean[:, None, None] \
        if data.mean is not None else arr
    thick = phys[:, iu] - phys[:, il]
    mean, std = float(np.nanmean(thick)), float(np.nanstd(thick))
    if std == 0:
        std = 1.0
    scaled = ((thick - mean) / std).astype(arr.dtype)

    name = name or "THICK/{}-{}".format(
        upper.split("/")[-1], lower.split("/")[-1]
    )
    data.predictors = np.concatenate([arr, scaled[:, None]], axis=1)
    data.varlev = list(data.varlev) + [name]
    if data.mean is not None:
        data.mean = np.concatenate([data.mean, [mean]])
        data.std = np.concatenate([data.std, [std]])
    return name, mean, std


def main(argv=None):
    """Rewrite the file with the new channel; returns the dataset."""
    args = parse_args(argv)
    from dlwp_torch.data import PredictorDataset

    data = PredictorDataset.from_file(args.predictor_file)
    name, mean, std = add_thickness(data, args.upper, args.lower, args.name)
    out = args.output_file or args.predictor_file
    data.to_file(out)
    print(f"added {name} (mean {mean:.1f}, std {std:.1f}) -> {out}")
    return data


if __name__ == "__main__":
    main()
