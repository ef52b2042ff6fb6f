"""Weight bridge from the JAX package's flax variables."""

from empanada_tpu_torch.port.weights import flatten_variables, from_flax, load_flax

__all__ = ["flatten_variables", "from_flax", "load_flax"]
