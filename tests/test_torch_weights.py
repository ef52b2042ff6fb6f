"""Weight bridge of the PyTorch port (empanada_tpu_torch/port/weights.py):
every flax leaf of PanopticDeepLabPR lands on exactly one port parameter,
with the layout conversions (HWIO -> OIHW, depthwise, Dense, BN)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import MITONET_V1, SMALL_PR, jax_init, n_leaves, port_model, to_numpy
from empanada_tpu.models import create_model as jax_create_model
from empanada_tpu_torch.models import create_model
from empanada_tpu_torch.port.weights import flatten_variables, from_flax


def test_small_pr_every_leaf_exactly_once():
    _, variables = jax_init("PanopticDeepLabPR", SMALL_PR)
    model = create_model("PanopticDeepLabPR", device="cpu", **SMALL_PR)
    state = from_flax(variables, model)
    assert set(state) == set(model.state_dict())
    assert len(state) == n_leaves(variables)
    # values arrive unchanged up to the layout transposes
    flat = flatten_variables(variables)
    stem = flat["params", "encoder", "stem_conv", "kernel"]
    np.testing.assert_array_equal(state["encoder.stem_conv.weight"].numpy(),
                                  stem.transpose(3, 2, 0, 1))
    dw = flat["params", "semantic_head", "conv", "sepconv", "depthwise", "kernel"]
    assert dw.shape[2] == 1
    np.testing.assert_array_equal(
        state["semantic_head.conv.sepconv.depthwise.weight"].numpy(),
        dw.transpose(3, 2, 0, 1))
    fc1 = flat["params", "semantic_pr", "point_head", "fc1", "kernel"]
    np.testing.assert_array_equal(state["semantic_pr.point_head.fc1.weight"].numpy(), fc1.T)
    var = flat["batch_stats", "encoder", "stem_bn", "var"]
    np.testing.assert_array_equal(state["encoder.stem_bn.running_var"].numpy(), var)


def test_mitonet_v1_widths_every_leaf_exactly_once():
    model = jax_create_model("PanopticDeepLabPR", **MITONET_V1)
    shapes = jax.eval_shape(
        lambda: model.init({"params": jax.random.key(0)}, jnp.zeros((1, 64, 64, 1)),
                           train=False))
    variables = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    port = create_model("PanopticDeepLabPR", device="cpu", **MITONET_V1)
    state = from_flax(to_numpy(variables), port)
    assert set(state) == set(port.state_dict())
    assert len(state) == n_leaves(variables)
    n_params = sum(p.numel() for p in port.parameters())
    n_flax = sum(np.prod(s.shape) for s in jax.tree.leaves(shapes["params"]))
    assert n_params == n_flax


def test_leftover_leaf_and_unset_parameter_raise():
    _, variables = jax_init("PanopticDeepLabPR", SMALL_PR)
    model = create_model("PanopticDeepLabPR", device="cpu", **SMALL_PR)
    extra = dict(variables, params=dict(variables["params"], stray={"kernel": np.zeros((1, 1))}))
    with pytest.raises(KeyError, match="stray"):
        from_flax(extra, model)
    params = dict(variables["params"])
    del params["ins_xy"]
    with pytest.raises(KeyError, match="unset"):
        from_flax(dict(variables, params=params), model)


def test_loaded_model_keeps_dtype_and_device():
    _, variables = jax_init("PanopticDeepLabPR", SMALL_PR)
    model = port_model("PanopticDeepLabPR", SMALL_PR, variables, dtype=torch.bfloat16)
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    assert all(p.device.type == "cpu" for p in model.parameters())
