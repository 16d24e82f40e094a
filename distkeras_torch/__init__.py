"""Drop-in alias: ``import distkeras_torch`` → ``distkeras_tpu_torch``.

Reference users wrote ``from distkeras.trainers import ADAG`` etc.; with
the port the same imports read ``from distkeras_torch.trainers import
ADAG``, and resolve to the port's classes (PyTorch, no JAX).
"""

import importlib as _importlib
import pkgutil as _pkgutil
import sys

import distkeras_tpu_torch
from distkeras_tpu_torch import *  # noqa: F401,F403

# Register EVERY submodule so `from distkeras_torch.evaluators import
# AccuracyEvaluator` resolves like the reference layout. Registration must
# be eager: a submodule import (`from pkg.sub import X`) consults
# sys.modules and pkg.__path__ only, never the package-level __getattr__.
# The list is derived from the real package, so modules added to
# distkeras_tpu_torch later alias automatically.
for _m in _pkgutil.iter_modules(distkeras_tpu_torch.__path__):
    sys.modules[f"distkeras_torch.{_m.name}"] = _importlib.import_module(
        f"distkeras_tpu_torch.{_m.name}"
    )


def __getattr__(name):
    # Unknown names raise AttributeError so hasattr()/getattr(..., default)
    # behave normally (everything real is eagerly registered above).
    try:
        return sys.modules[f"distkeras_torch.{name}"]
    except KeyError:
        raise AttributeError(
            f"module 'distkeras_torch' has no attribute {name!r}"
        ) from None
