"""Shared fixtures of the PyTorch port's parity tests (tests/test_torch_*.py).

Both packages get the same numbers: seeded numpy values fill the flax
variable tree of the JAX model (BN running statistics included, so the maps
and the PointRend uncertainty are not near-constant), and the weight bridge
(``empanada_tpu_torch.port.weights``) loads them into the port's modules.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from empanada_tpu.models import create_model as jax_create_model
from empanada_tpu_torch.models import create_model as torch_create_model
from empanada_tpu_torch.port.weights import flatten_variables, load_flax

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port's many small CPU ops (autouse in the
    modules that import it): the suite runs several test processes side by
    side, and a thread pool per process on shared cores slows each op's
    parallel region by an order of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# a small PanopticDeepLabPR with every module of MitoNet_v1's chain: resnet18
# at output stride 16, one low-level stage, an instance decoder, K = 256
SMALL_PR = dict(encoder="resnet18", num_classes=1, decoder_channels=32,
                low_level_stages=[1], low_level_channels_project=[16],
                ins_decoder=True, subdivision_num_points=256)

# MitoNet_v1's widths (empanada_tpu/configs/MitoNet_v1.yaml)
MITONET_V1 = dict(encoder="resnet50", num_classes=1, stage4_stride=16,
                  decoder_channels=256, low_level_stages=[1],
                  low_level_channels_project=[32], ins_decoder=True,
                  subdivision_num_points=8192)


def to_numpy(tree):
    """Nested flax variables -> the same nesting of float32 numpy arrays."""
    if hasattr(tree, "items"):
        return {k: to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree, np.float32)


def random_variables(shapes, seed=0):
    """Seeded numpy values for a flax variable tree of ``jax.ShapeDtypeStruct``
    leaves: LeCun-normal kernels, small random biases, BN scales in
    U(0.5, 1.5), and random BN running statistics (mean ~ N(0, 0.1),
    var ~ U(0.5, 1.5)), so that the maps and the PointRend uncertainty are
    not near-constant."""
    rng = np.random.default_rng(seed)

    def leaf(name, shape):
        if name == "kernel":
            return rng.normal(0, 1, shape) / np.sqrt(np.prod(shape[:-1]))
        if name in ("bias", "mean"):
            return rng.normal(0, 0.1, shape)
        return rng.uniform(0.5, 1.5, shape)  # BN scale and var

    def walk(tree):
        return {k: walk(v) if hasattr(v, "items") else
                leaf(k, v.shape).astype(np.float32) for k, v in sorted(tree.items())}

    return walk(shapes)


def jax_init(arch, kw, size=64, seed=0, dtype=jnp.float32):
    """(flax model, numpy variables): the variable tree of ``arch`` (shapes
    from ``jax.eval_shape`` of ``init``, so nothing is compiled) filled by
    ``random_variables``."""
    model = jax_create_model(arch, dtype=dtype, **kw)
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.key(seed)}, jnp.zeros((1, size, size, 1)), train=False))
    return model, random_variables(shapes, seed)


def port_model(arch, kw, variables, dtype=torch.float32, **extra):
    """The port's model on the CPU with the flax ``variables`` loaded."""
    model = torch_create_model(arch, device="cpu", **kw, **extra)
    return load_flax(model, variables).to(dtype)


def n_leaves(variables):
    return len(flatten_variables(variables))
