"""Sample splitting and NaN handling (port of ``dlwp_tpu.utils.split``)."""

from __future__ import annotations

import numpy as np


def train_test_split_ind(
    n_samples: int, test_size: int, method: str = "first", seed: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """Index split into (train, test); ``method`` in {'first', 'last',
    'random'} selects where the test block comes from."""
    idx = np.arange(n_samples)
    if method == "first":
        return idx[test_size:], idx[:test_size]
    if method == "last":
        return idx[:-test_size], idx[-test_size:]
    if method == "random":
        rng = np.random.RandomState(seed)
        perm = rng.permutation(n_samples)
        return np.sort(perm[test_size:]), np.sort(perm[:test_size])
    raise ValueError("'method' must be 'first', 'last', or 'random'")


def delete_nan_samples(
    predictors: np.ndarray,
    targets: np.ndarray | None = None,
    large_fill_value: bool = False,
    threshold: float | None = None,
):
    """Drop samples containing NaN in either array: ``(predictors, targets,
    keep)``. ``large_fill_value`` also drops non-finite values and |x| >=
    1e30; ``threshold`` keeps samples whose NaN fraction is below it, with
    their NaNs set to 0."""
    p = np.asarray(predictors)
    bad_p = ~np.isfinite(p) if large_fill_value else np.isnan(p)
    if large_fill_value:
        bad_p |= np.abs(np.nan_to_num(p, nan=np.inf)) >= 1e30
    flat_p = bad_p.reshape(len(p), -1)
    if targets is not None:
        t = np.asarray(targets)
        bad_t = ~np.isfinite(t) if large_fill_value else np.isnan(t)
        flat_t = bad_t.reshape(len(t), -1)
    else:
        flat_t = np.zeros((len(p), 1), dtype=bool)
    if threshold is None:
        keep = ~(flat_p.any(axis=1) | flat_t.any(axis=1))
    else:
        frac = (flat_p.sum(axis=1) + flat_t.sum(axis=1)) / (
            flat_p.shape[1] + flat_t.shape[1])
        keep = frac < threshold
    p_out = (np.where(np.isnan(p[keep]), 0.0, p[keep])
             if threshold is not None else p[keep])
    if targets is None:
        return p_out, None, keep
    t_kept = np.asarray(targets)[keep]
    t_out = (np.where(np.isnan(t_kept), 0.0, t_kept)
             if threshold is not None else t_kept)
    return p_out, t_out, keep


__all__ = ["delete_nan_samples", "train_test_split_ind"]
