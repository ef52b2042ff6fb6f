"""The int8 convolution kernel's launch plan (``ops/int8_conv.py::plan``)
and its split of K, on the CPU.

The plan is pure Python over the shape and an SM count: it is held here to
cover every K step exactly once, to fill a 132-SM card at a request's size
(N = 1) on MitoNet_v1's five int8 shapes, to leave a batch of 8 unsplit,
and to refuse what the kernel refuses.  A plain emulation of the split
(the float64 partial convolutions of each block's taps and channel ranges,
summed) is compared bit for bit with ``int8_conv_reference`` and with the
JAX package's ``blocks.int8_conv``: integer sums are exact in any order,
which is what lets the kernel split K at all.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import empanada_tpu.models.blocks as jax_blocks
from empanada_tpu_torch.ops import int8_conv as ic

# MitoNet_v1's int8 convolutions of a 512 x 512 request: (input side,
# channels, stride, dilation), 13 calls in all
MITONET_SHAPES = [(128, 128, 2, 1), (64, 128, 1, 1), (64, 256, 2, 1), (32, 256, 1, 1),
                  (32, 512, 1, 2)]
H100_SMS = 132
# the most clusters of 1..8 GEMM blocks an H100 80GB HBM3 holds at once
# (cudaOccupancyMaxActiveClusters for the kernel's 384 threads and its shared
# memory): its GPCs differ in size, so clusters of 3-8 leave SMs idle
H100_CLUSTERS = (132, 66, 39, 30, 22, 17, 15, 15)


def _plan(n, side, c, o, stride, dilation, sms=H100_SMS, side_w=None, clusters=None):
    return ic.plan(n, side, side_w or side, c, o, 3, 3, stride, dilation, dilation, sms,
                   clusters)


@pytest.mark.parametrize("k_steps,split", [(k, s) for k in (1, 2, 7, 9, 18, 36, 37)
                                            for s in (1, 2, 3, 4, 5, 8) if s <= k])
def test_every_k_step_lies_in_exactly_one_split(k_steps, split):
    """(The plan never splits wider than the K steps.)"""
    ranges = [ic.split_range(k_steps, split, r) for r in range(split)]
    covered = [k for lo, hi in ranges for k in range(lo, hi)]
    assert covered == list(range(k_steps))
    sizes = [hi - lo for lo, hi in ranges]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("side,c,stride,dilation", MITONET_SHAPES)
def test_a_request_fills_the_card(side, c, stride, dilation):
    p = _plan(1, side, c, c, stride, dilation)
    blocks = p.split * p.tiles_m * p.tiles_n
    assert 64 <= blocks <= H100_SMS
    assert p.split > 1 and p.split <= ic.MAX_SPLIT and p.split <= p.k_steps
    assert p.k_steps == 9 * -(-c // ic.BK)


@pytest.mark.parametrize("side,c,stride,dilation", MITONET_SHAPES)
def test_a_request_fits_the_h100_in_one_wave(side, c, stride, dilation):
    """With the clusters an H100 really holds, every block of a request's
    grid is resident at once, and still at least 64 of them."""
    p = _plan(1, side, c, c, stride, dilation, clusters=H100_CLUSTERS)
    assert p.tiles_m * p.tiles_n <= H100_CLUSTERS[p.split - 1]
    assert p.split * p.tiles_m * p.tiles_n >= 64
    bigger = [s for s in range(p.split + 1, min(ic.MAX_SPLIT, p.k_steps) + 1)]
    assert all(p.tiles_m * p.tiles_n > H100_CLUSTERS[s - 1] for s in bigger)


@pytest.mark.parametrize("side,c,stride,dilation", MITONET_SHAPES)
def test_a_batch_of_eight_is_not_split(side, c, stride, dilation):
    p = _plan(8, side, c, c, stride, dilation)
    assert p.split == 1
    assert p.tiles_m * p.tiles_n >= H100_SMS // 2


def test_plan_geometry():
    p = _plan(2, 17, 160, 136, 2, 1, sms=32, side_w=23)
    assert (p.ho, p.wo) == (9, 12)
    # TMA-fed tiles of 8 rows x 16 pixels: 2 a 9 x 12 image, the fewest
    assert p.wb == 16 and p.tiles_m == 2 * 2 and p.tiles_n == 2
    assert p.k_steps == 18  # ceil(160 / 128) steps a tap
    assert p.split == 4  # 32 SMs over 8 tiles


@pytest.mark.parametrize("side,c,stride,dilation", MITONET_SHAPES)
def test_mitonet_tiles_are_whole_rows(side, c, stride, dilation):
    """At MitoNet_v1's shapes the activations come by TMA in tiles of whole
    output rows: no tile reaches past the output."""
    p = _plan(1, side, c, c, stride, dilation)
    assert p.wb == p.wo and p.ho % (ic.BM // p.wb) == 0
    assert p.tiles_m * ic.BM == p.ho * p.wo


@pytest.mark.parametrize("c,stride,wo,wb", [(96, 1, 20, 0), (32, 1, 9, 0), (128, 9, 40, 0),
                                            (128, 8, 40, 16), (256, 1, 57, 64),
                                            (128, 2, 5, 16), (160, 1, 200, 16)])
def test_activation_path(c, stride, wo, wb):
    """TMA boxes need 128 channel bytes and a stride of at most 8; other
    shapes take the cp.async path (wb = 0).  The width covers the output
    in the fewest tiles."""
    assert ic._tile_width(c, stride, wo, wo) == wb
    if wb:
        hb = ic.BM // wb
        assert wb * stride <= 256 and hb * stride <= 256
        for other in (128, 64, 32, 16, 8, 4, 2, 1):
            if other * stride <= 256 and ic.BM // other * stride <= 256:
                assert (-(-wo // hb) * -(-wo // wb)
                        <= -(-wo // (ic.BM // other)) * -(-wo // other))


@pytest.mark.parametrize("args,match", [
    ((1, 8, 8, 96 + 16, 64, 3, 3, 1, 1, 1), "C_in % 32"),
    ((1, 8, 8, 128, 60, 3, 3, 1, 1, 1), "C_out % 8"),
    ((1, 2, 2, 128, 64, 3, 3, 1, 0, 1), "out of the kernel's range"),
    ((1, 8, 8, 128, 64, 3, 3, 0, 1, 1), "out of range"),
    ((1, 8, 8, 128, 64, 3, 3, 1, -1, 1), "out of range"),
    ((2 ** 10, 2 ** 10, 2 ** 6, 32, 8, 3, 3, 1, 1, 1), "below 2\\^31"),
    ((64, 256, 256, 32, 1024, 3, 3, 1, 1, 1), "out of the kernel's range"),
])
def test_plan_refuses_what_the_kernel_refuses(args, match):
    with pytest.raises(ValueError, match=match):
        ic.plan(*args, H100_SMS)


def test_plan_fields_are_the_kernels_struct():
    """The plan reaches the kernel as ints in ``ConvPlan``'s order."""
    src = open(os.path.join(os.path.dirname(ic.__file__), "..", "csrc", "int8_conv.cu")).read()
    body = re.search(r"struct ConvPlan \{\s*int ([^;]*);", src).group(1)
    fields = [f.strip() for f in body.split(",")]
    assert fields == [{"dilation": "dil"}.get(f, f) for f in ic.Plan._fields]


def _split_k_emulation(x, wq, w_scale, stride, pad, dilation, p):
    """The kernel's arithmetic with K split as ``p`` splits it: each
    block's partial sums (its K steps: one tap, a 128-channel range) as
    float64 convolutions of the int8 values, summed over the blocks, then
    the epilogue's float32 steps."""
    xq, a_scale = ic.quantize_activation_reference(x)
    xd, wd = xq.to(torch.float64), wq.to(torch.float64)
    per_tap = -(-p.c // ic.BK)
    total = 0
    for rank in range(p.split):
        lo, hi = ic.split_range(p.k_steps, p.split, rank)
        part = torch.zeros(wd.shape, dtype=torch.float64)
        for ks in range(lo, hi):
            tap, cc = divmod(ks, per_tap)
            ky, kx = divmod(tap, p.kw)
            ch = slice(cc * ic.BK, min(p.c, (cc + 1) * ic.BK))
            part[:, ch, ky, kx] = wd[:, ch, ky, kx]
        acc = F.conv2d(xd, part, stride=stride, padding=pad, dilation=dilation)
        assert torch.equal(acc, acc.round())  # exact integers
        total = total + acc.to(torch.int64)
    scale = a_scale * w_scale
    y = (total.to(torch.float32) * scale[None, :, None, None]).to(x.dtype)
    return y


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("cin,cout,stride,dilation,sms", [
    (128, 64, 1, 1, 16),   # 9 K steps over 4 blocks: 3, 2, 2, 2
    (160, 72, 2, 1, 40),   # C % 128 != 0: 18 steps, the second of each tap 32 channels
    (96, 32, 1, 2, 20),    # one partial step a tap, dilation 2
    (256, 128, 1, 1, 60),  # 18 steps over 5 blocks (uneven)
])
def test_split_k_emulation_is_bit_for_bit(dtype, cin, cout, stride, dilation, sms):
    rng = np.random.default_rng(cin + cout + stride)
    x = rng.normal(size=(2, 9, 11, cin)).astype(np.float32)
    x[1] *= 4.0
    kernel = (rng.normal(size=(3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(np.float32)
    xt = torch.from_numpy(x).to(dtype).permute(0, 3, 1, 2)
    wq, w_scale = ic.quantize_weight(torch.from_numpy(kernel).permute(3, 2, 0, 1))
    p = ic.plan(2, 9, 11, cin, cout, 3, 3, stride, dilation, dilation, sms)
    assert p.split > 1
    got = _split_k_emulation(xt, wq, w_scale, stride, dilation, dilation, p)
    want = ic.int8_conv_reference(xt, wq, w_scale, stride, dilation, dilation)
    assert torch.equal(got, want)
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    jax_out = jax.jit(jax_blocks.int8_conv, static_argnums=(2, 3, 4, 5))(
        jnp.asarray(x, jdt), jnp.asarray(kernel), stride, dilation, dilation, jdt)
    np.testing.assert_array_equal(got.float().permute(0, 2, 3, 1).numpy(),
                                  np.asarray(jax_out.astype(jnp.float32)))
