"""Weights from elsewhere: the bridge from the JAX package's flax
variables (``weights``) and the importer of the reference's PyTorch
checkpoints (``torch_port``)."""

from empanada_tpu_torch.port.torch_port import (
    infer_arch_and_kwargs,
    load_torch_checkpoint,
    port_state_dict,
)
from empanada_tpu_torch.port.weights import flatten_variables, flax_key, from_flax, load_flax

__all__ = ["flatten_variables", "flax_key", "from_flax", "load_flax",
           "infer_arch_and_kwargs", "load_torch_checkpoint", "port_state_dict"]
