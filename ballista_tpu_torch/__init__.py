"""ballista_tpu_torch — the PyTorch/CUDA port of ``ballista_tpu``.

The same SQL engine, run with PyTorch on an NVIDIA card (Hopper, sm_90a)
instead of JAX on a TPU. The layout mirrors ``ballista_tpu`` module for
module: the device-free front end (``sql``, ``plan``, ``expr.logical``,
``datatypes``, ``errors``, ``tpch``) is a copy of the reference's, and the
device modules (``columnar``, ``expr.physical``, ``ops``, ``exec``) are
plain functions over torch tensors with an explicit ``device``. The one
TPU kernel of the reference (``ops/pallas_agg.py``) is a hand-written CUDA
kernel here (``csrc/onehot_agg.cu`` behind ``ops/onehot_agg.py``).

The port imports nothing of ``ballista_tpu`` and never imports ``jax``.
Entry points: ``ballista_tpu_torch.exec.context.TorchContext``, the
cluster client ``ballista_tpu_torch.client.context.BallistaContext``, and
the shell ``python -m ballista_tpu_torch.cli``.

The packages re-export the reference's API names (``__all__``). A name
whose module imports torch is imported at its first use (PEP 562
``__getattr__``), so that ``import ballista_tpu_torch`` and the front end
(``expr``, ``plan``) stay device-free at import.
"""

import importlib as _importlib

from ballista_tpu_torch.errors import BallistaError

__version__ = "0.1.0"


def _lazy(package: str, names: dict[str, str], submodules: tuple[str, ...] = ()):
    """A module ``__getattr__`` for ``package``: ``names`` maps an exported
    name to the module that defines it, ``submodules`` are exported as
    themselves. Each is imported at its first access and then kept in the
    package's namespace."""

    def __getattr__(name: str):
        if name in submodules:
            value = _importlib.import_module(f"{package}.{name}")
        elif name in names:
            value = getattr(_importlib.import_module(names[name]), name)
        else:
            raise AttributeError(f"module {package!r} has no attribute {name!r}")
        setattr(_importlib.import_module(package), name, value)
        return value

    return __getattr__


__getattr__ = _lazy(__name__, {"BallistaConfig": "ballista_tpu_torch.config"})

__all__ = ["BallistaConfig", "BallistaError", "__version__"]
