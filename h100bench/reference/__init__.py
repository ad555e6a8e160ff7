"""Plain references of the benchmark's configurations: plain PyTorch and
numpy, TF32 off, importing nothing of ``dlwp_torch``, JAX or the JAX
package. A configuration names its reference module under ``reference``.
"""

import importlib


def load(name: str):
    """The reference module ``h100bench/reference/<name>.py``."""
    return importlib.import_module(f"h100bench.reference.{name}")
