"""Forward parity of the PyTorch port's models and resize ops against the
JAX package, in float32 on the CPU, within 1e-5 (the tolerance of the
existing torch-parity tests, PARITY.md section 2.2)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import SMALL_PR, jax_init, port_model
from empanada_tpu.ops import interpolate as jin
from empanada_tpu_torch.ops import interpolate as tin

ATOL = 1e-5


def _image(size, seed=11):
    return np.random.default_rng(seed).normal(0, 1, (1, size, size, 1)).astype(np.float32)


def _forward_both(arch, kw, x, **call):
    model, variables = jax_init(arch, kw, size=x.shape[1])
    want = jax.jit(lambda v, a: model.apply(v, a, train=False, **call))(
        variables, jnp.asarray(x))
    tmodel = port_model(arch, kw, variables, fused_render="never") if arch.endswith("PR") \
        else port_model(arch, kw, variables)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x), **call)
    return {k: np.asarray(v) for k, v in want.items()}, {k: v.numpy() for k, v in got.items()}


PDL_KW = {k: v for k, v in SMALL_PR.items() if k != "subdivision_num_points"}


@pytest.mark.parametrize("interpolate_ins", [True, False])
def test_panoptic_deeplab_forward(interpolate_ins):
    want, got = _forward_both("PanopticDeepLab", PDL_KW, _image(64),
                              interpolate_ins=interpolate_ins)
    assert set(want) == set(got)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=0, err_msg=k)


def test_panoptic_deeplab_pr_dense_then_sparse_step():
    # 64^2 input: the 1/4 logits are 16^2; step 1 (32^2 <= 8K) takes the dense
    # path, step 2 (64^2 > 8K) the sparse top-K path, with K = 256
    want, got = _forward_both("PanopticDeepLabPR", SMALL_PR, _image(64),
                              render_steps=2, interpolate_ins=False)
    assert want["sem_logits"].shape == (1, 64, 64, 1)
    assert want["ctr_hmp"].shape == (1, 16, 16, 1)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=0, err_msg=k)


def test_panoptic_deeplab_pr_odd_padded_size():
    want, got = _forward_both("PanopticDeepLabPR", SMALL_PR, _image(48, seed=3),
                              render_steps=2, interpolate_ins=True)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("align_corners,zeros_padding,out_hw", [
    (False, False, (26, 40)),
    (True, False, (52, 41)),
    (False, True, (26, 40)),
    (False, True, (52, 80)),
    (True, False, (7, 9)),
])
def test_bilinear_resize(align_corners, zeros_padding, out_hw):
    x = np.random.default_rng(1).normal(0, 1, (2, 13, 20, 3)).astype(np.float32)
    want = np.asarray(jin.bilinear_resize(jnp.asarray(x), out_hw, align_corners,
                                          zeros_padding))
    got = tin.bilinear_resize(torch.from_numpy(x), out_hw, align_corners,
                              zeros_padding).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_bilinear_resize_bf16_rounds_per_pass():
    # the upsample the refine kernel passes through: bit-exact in bf16
    x = np.random.default_rng(2).normal(0, 2, (2, 16, 24, 1)).astype(np.float32)
    want = jin.bilinear_resize(jnp.asarray(x, jnp.bfloat16), (32, 48))
    got = tin.bilinear_resize(torch.from_numpy(x).to(torch.bfloat16), (32, 48))
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_nearest_resize_and_point_sample():
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (1, 9, 11, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        tin.nearest_resize(torch.from_numpy(x), (36, 44)).numpy(),
        np.asarray(jin.nearest_resize(jnp.asarray(x), (36, 44))))
    pc = rng.random((1, 300, 2)).astype(np.float32)
    pc[0, :4] = [[0, 0], [1, 1], [0, 1], [1, 0]]
    want = np.asarray(jin.point_sample(jnp.asarray(x), jnp.asarray(pc)))
    for fn in (tin.point_sample, tin.point_sample_packed):
        got = fn(torch.from_numpy(x), torch.from_numpy(pc)).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
