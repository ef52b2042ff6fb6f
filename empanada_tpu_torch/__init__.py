"""PyTorch/CUDA port of empanada_tpu for one NVIDIA H100.

Imports torch, numpy, scipy and yaml only; nothing of jax, flax or
empanada_tpu (the host stitching layer and its C++ library are the port's
own copies).
Module paths mirror the JAX package's (``models/resnet.py``,
``ops/postprocess.py``, ``engine/engines.py``, ...).  Entry points run on
the card by default (``device=None`` means "cuda", and this rank's card in
a world of processes, ``parallel.multihost``) and raise without a GPU
unless the caller passes ``device="cpu"``.
"""

from empanada_tpu_torch.utils import fp32_strict, resolve_device

__all__ = ["fp32_strict", "resolve_device"]
