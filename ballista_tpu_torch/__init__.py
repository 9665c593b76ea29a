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
Entry point: ``ballista_tpu_torch.exec.context.TorchContext``.
"""

__version__ = "0.1.0"
