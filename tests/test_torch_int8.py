"""``int8_execution`` in the port (ops/int8_conv.py, models/blocks.py),
held to the JAX package's ``blocks.int8_conv`` and its int8 models on the
same numpy inputs and weights.

Tolerances: the convolution and the quantized weights are compared bit for
bit (the same integer sums, the same float32 rounding steps).  A whole int8
model is compared within 1e-3 of its largest output: the float32 trunks
before each int8 convolution differ by rounding (~1e-6), and where a value
sits on a quantization boundary one int8 level flips, which moves that
convolution's output by one step of its scale.  On flax's initial
variables the port's int8 model stays within 2 % (mean relative) of its
float model, the JAX package's own bound there
(``tests/test_models.py::test_int8_execution_parity``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import empanada_tpu.models.blocks as jax_blocks
from _torch_port import jax_init, one_torch_thread, port_model, to_numpy  # noqa: F401
from empanada_tpu.models import create_model as jax_create_model
from empanada_tpu.models.resnet import ResNet as JaxResNet
from empanada_tpu.models.resnet import resnet_configs as jax_resnet_configs
from empanada_tpu_torch.models import blocks, create_model
from empanada_tpu_torch.models.resnet import ResNet, resnet_configs
from empanada_tpu_torch.ops import int8_conv as ic

# a narrow PanopticDeepLabPR on MitoNet_v1's encoder (resnet50, stride 16)
NARROW_R50 = dict(encoder="resnet50", num_classes=1, decoder_channels=32,
                  low_level_stages=[1], low_level_channels_project=[16],
                  ins_decoder=True, subdivision_num_points=256)
JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _nchw(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype).permute(0, 3, 1, 2)


def _oihw(kernel):
    return torch.from_numpy(np.ascontiguousarray(kernel)).permute(3, 2, 0, 1)


_jax_int8_conv = jax.jit(jax_blocks.int8_conv, static_argnums=(2, 3, 4, 5))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("cin,stride,dilation", [(128, 1, 1), (128, 2, 1), (256, 1, 2),
                                                 (256, 2, 1)])
def test_int8_conv_matches_jax_bit_for_bit(dtype, cin, stride, dilation):
    rng = np.random.default_rng(cin + 10 * stride + dilation)
    x = rng.normal(size=(2, 9, 11, cin)).astype(np.float32)
    x[1] *= 4.0  # the images' scales differ: one a_scale for the whole batch
    kernel = (rng.normal(size=(3, 3, cin, 64)) / np.sqrt(9 * cin)).astype(np.float32)
    kernel[..., 5] = 0.0  # an all-zero output channel: w_scale = 1e-12
    jdt = JAX_DTYPES[dtype]
    want = np.asarray(_jax_int8_conv(jnp.asarray(x, jdt), jnp.asarray(kernel), stride,
                                     dilation, dilation, jdt).astype(jnp.float32))
    wq, w_scale = ic.quantize_weight(_oihw(kernel))
    got = ic.int8_conv(_nchw(x, dtype), wq, w_scale, stride, dilation, dilation)
    assert got.dtype == dtype and got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(got.float().permute(0, 2, 3, 1).numpy(), want)


def test_a_scale_is_one_for_the_batch():
    """The second image's scale sets the first's quantization: the batch
    quantized together differs from the first image quantized alone."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(2, 128, 6, 6)).astype(np.float32))
    x[1] *= 8.0
    wq, w_scale = ic.quantize_weight(torch.from_numpy(
        rng.normal(size=(32, 128, 3, 3)).astype(np.float32)))
    both = ic.int8_conv(x, wq, w_scale, 1, 1, 1)
    alone = ic.int8_conv(x[:1], wq, w_scale, 1, 1, 1)
    assert not torch.equal(both[:1], alone)
    xq, a_scale = ic.quantize_activation_reference(x)
    assert a_scale.item() == np.float32(x.abs().max().item()) * np.float32(ic.INV127)
    assert xq.abs().max().item() == 127


def _jax_quantized(kernel):
    w_scale = np.maximum(np.abs(kernel).max(axis=(0, 1, 2)) * np.float32(ic.INV127),
                         np.float32(1e-12))
    f = jax.jit(lambda k: (jnp.maximum(jnp.max(jnp.abs(k), axis=(0, 1, 2)) / 127.0, 1e-12),
                           jnp.clip(jnp.round(k / jnp.maximum(
                               jnp.max(jnp.abs(k), axis=(0, 1, 2), keepdims=True) / 127.0,
                               1e-12)), -127, 127).astype(jnp.int8)))
    js, jq = (np.asarray(a) for a in f(jnp.asarray(kernel)))
    np.testing.assert_array_equal(js, w_scale)  # XLA multiplies by float32(1/127)
    return js, jq


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_quantized_weights_come_from_float32_masters(dtype):
    """Every int8 convolution of a model made in ``dtype`` quantizes its
    flax float32 kernel exactly as JAX does: a bf16 model keeps the float32
    master weights of those convolutions (the other parameters go bf16)."""
    model, variables = jax_init("PanopticDeepLabPR", NARROW_R50)
    tmodel = port_model("PanopticDeepLabPR", NARROW_R50, variables, dtype=dtype,
                        int8_execution=True)
    enc = variables["params"]["encoder"]
    convs = [(name, m) for name, m in tmodel.named_modules()
             if isinstance(m, blocks.ConvBnAct) and m.int8]
    assert len(convs) == 13
    for name, m in convs:
        block, cba = name.split(".")[1:3]
        kernel = enc[block][cba]["conv"]["kernel"]
        assert m.conv.weight.dtype == torch.float32
        wq, w_scale = m.conv.quantized()
        js, jq = _jax_quantized(kernel)
        np.testing.assert_array_equal(w_scale.numpy(), js)
        np.testing.assert_array_equal(wq.permute(2, 3, 1, 0).numpy(), jq)
    assert tmodel.encoder.stem_conv.weight.dtype == dtype
    # the cache follows the weight: changed in place, quantized again
    m = convs[0][1].conv
    wq0, _ = m.quantized()
    assert m.quantized()[0] is wq0
    with torch.no_grad():
        m.weight.mul_(2.0)
    assert m.quantized()[0] is not wq0


def _count_jax(arch_kw, size=64):
    calls = []
    real = jax_blocks.int8_conv

    def counting(*args):
        calls.append(args[0].shape)
        return real(*args)

    model = JaxResNet(output_stride=16, int8_execution=True, **arch_kw)
    x = jnp.zeros((1, size, size, 1))
    variables = jax.eval_shape(lambda: model.init(jax.random.key(0), x, train=False))
    jax_blocks.int8_conv = counting
    try:
        jax.eval_shape(lambda v: model.apply(v, x, train=False), variables)
    finally:
        jax_blocks.int8_conv = real
    return len(calls)


@pytest.mark.parametrize("name,expected", [("resnet18", 11), ("resnet50", 13)])
def test_int8_convolutions_counted_as_in_jax(name, expected, monkeypatch):
    assert _count_jax(jax_resnet_configs[name]) == expected
    calls = []
    real = blocks.int8_conv
    monkeypatch.setattr(blocks, "int8_conv",
                        lambda x, *a: calls.append(tuple(x.shape)) or real(x, *a))
    enc = ResNet(output_stride=16, int8_execution=True, **resnet_configs[name]).eval()
    with torch.no_grad():
        enc(torch.randn(1, 1, 64, 64).contiguous(memory_format=torch.channels_last))
    assert len(calls) == expected
    assert min(c[1] for c in calls) >= 128


@pytest.fixture(scope="module")
def pr_models():
    """JAX's int8 and float PanopticDeepLabPR on the same variables, and the
    port's, at 64 x 64."""
    model, variables = jax_init("PanopticDeepLabPR", NARROW_R50)
    jax8 = jax_create_model("PanopticDeepLabPR", int8_execution=True, **NARROW_R50)
    x = np.random.default_rng(0).normal(0, 1, (1, 64, 64, 1)).astype(np.float32)
    outs = {}
    for key, m in (("jax8", jax8), ("jax32", model)):
        o = jax.jit(lambda v, x, m=m: m.apply(v, x, train=False))(variables, jnp.asarray(x))
        outs[key] = {k: np.asarray(v, np.float32) for k, v in o.items()}
    for key, int8 in (("port8", True), ("port32", False)):
        m = port_model("PanopticDeepLabPR", NARROW_R50, variables, int8_execution=int8)
        with torch.no_grad():
            o = m(torch.from_numpy(x))
        outs[key] = {k: v.float().numpy() for k, v in o.items()}
    return outs


@pytest.mark.parametrize("key", ["sem_logits", "ctr_hmp", "offsets"])
def test_int8_pr_model_matches_jax(pr_models, key):
    got, want = pr_models["port8"][key], pr_models["jax8"][key]
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-3 * scale
    # the float models agree far closer: the int8 path is what differs
    f_err = np.abs(pr_models["port32"][key] - pr_models["jax32"][key]).max()
    assert f_err <= 1e-4 * scale


@pytest.fixture(scope="module")
def flax_init_outputs():
    """The port's int8 and float PanopticDeepLab (resnet50) on flax's own
    initial variables, the setting of the JAX package's 2 % test
    (``tests/test_models.py::test_int8_execution_parity``)."""
    kw = dict(encoder="resnet50", num_classes=1, decoder_channels=32,
              low_level_stages=(1,), low_level_channels_project=(16,))
    m32 = jax_create_model("PanopticDeepLab", **kw)
    v = jax.jit(m32.init, static_argnames=("train",))(
        {"params": jax.random.key(0)}, jnp.zeros((1, 64, 64, 1)), train=False)
    x = torch.from_numpy(np.random.default_rng(0).normal(0, 1, (1, 64, 64, 1)).astype(
        np.float32))
    outs = {}
    for int8 in (True, False):
        m = port_model("PanopticDeepLab", kw, to_numpy(v), int8_execution=int8)
        with torch.no_grad():
            outs[int8] = {k: t.numpy() for k, t in m(x).items()}
    return outs


@pytest.mark.parametrize("key", ["sem_logits", "ctr_hmp", "offsets"])
def test_int8_stays_within_two_percent_of_float(flax_init_outputs, key):
    a, b = flax_init_outputs[True][key], flax_init_outputs[False][key]
    assert np.abs(a - b).mean() / (np.abs(b).mean() + 1e-9) < 0.02
    assert not np.array_equal(a, b)  # the int8 path ran


def test_train_mode_takes_the_float_convolution(monkeypatch):
    kw = dict(NARROW_R50, encoder="resnet18")
    kw.pop("subdivision_num_points")
    _, variables = jax_init("PanopticDeepLab", kw)
    m8 = port_model("PanopticDeepLab", kw, variables, int8_execution=True)
    m32 = port_model("PanopticDeepLab", kw, variables)
    monkeypatch.setattr(blocks, "int8_conv", lambda *a, **k: pytest.fail("int8 in train"))
    x = torch.from_numpy(np.random.default_rng(1).normal(0, 1, (2, 64, 64, 1)).astype(
        np.float32))
    gen = [torch.Generator().manual_seed(0) for _ in range(2)]
    o8 = m8(x, train=True, generator=gen[0])
    o32 = m32(x, train=True, generator=gen[1])
    for k in o32:
        torch.testing.assert_close(o8[k], o32[k], rtol=0, atol=0)
    sum(v.sum() for v in o8.values()).backward()
    convs = [m for m in m8.modules() if isinstance(m, blocks.ConvBnAct) and m.int8]
    assert len(convs) == 11
    assert all(c.conv.weight.grad is not None and c.conv.weight.grad.abs().sum() > 0
               for c in convs)


@pytest.mark.parametrize("arch", ["PanopticBiFPN", "PanopticBiFPNPR"])
def test_bifpn_models_refuse_the_flag(arch):
    with pytest.raises(TypeError):
        jax_create_model(arch, int8_execution=True)
    with pytest.raises(TypeError):
        create_model(arch, device="cpu", int8_execution=True)


@pytest.mark.parametrize("arch", ["PanopticDeepLab", "PanopticDeepLabPR", "PanopticDeepLabBC"])
def test_every_resnet_assembly_takes_the_flag(arch, monkeypatch):
    kw = dict(NARROW_R50, encoder="resnet18")
    if arch == "PanopticDeepLab":
        kw.pop("subdivision_num_points")
    calls = []
    real = blocks.int8_conv
    monkeypatch.setattr(blocks, "int8_conv",
                        lambda *a: calls.append(1) or real(*a))
    m = create_model(arch, device="cpu", int8_execution=True, **kw)
    with torch.no_grad():
        out = m(torch.randn(1, 64, 64, 1))
    assert len(calls) == 11
    assert all(torch.isfinite(v).all() for v in out.values())


def test_regnet_encoder_runs_in_float():
    m = create_model("PanopticDeepLab", device="cpu", int8_execution=True,
                     encoder="regnety_200mf", decoder_channels=32,
                     low_level_stages=[1], low_level_channels_project=[16])
    assert not any(isinstance(c, blocks.MasterConv2d) for c in m.modules())


def test_config_and_bundle_carry_the_flag(tmp_path):
    from empanada_tpu_torch.api import utils as U

    kw = dict(NARROW_R50, encoder="resnet18", int8_execution=True)
    cfg = {"arch": "PanopticDeepLabPR", "model_kwargs": kw}
    model = U.init_model_from_config(cfg, seed=0, device="cpu", dtype=torch.bfloat16)
    assert sum(isinstance(c, blocks.MasterConv2d) for c in model.modules()) == 11
    path = U.save_model_bundle(str(tmp_path / "m"), cfg["arch"], kw, model)
    back = U.load_model_bundle(path, device="cpu", dtype=torch.bfloat16)
    for (k, a), b in zip(model.state_dict().items(), back.state_dict().values()):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    x = torch.randn(1, 64, 64, 1, dtype=torch.bfloat16)
    with torch.no_grad():
        for k, v in model(x).items():
            torch.testing.assert_close(back(x)[k], v, rtol=0, atol=0)


def test_registered_op_passes_opcheck():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(2, 128, 7, 7)).astype(np.float32)).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    wq, w_scale = ic.quantize_weight(torch.from_numpy(
        rng.normal(size=(16, 128, 3, 3)).astype(np.float32)))
    args = (x, wq, w_scale, 2, 1, 1)
    result = torch.library.opcheck(ic.int8_conv_op, args)
    assert all(v == "SUCCESS" for v in result.values()), result
    torch.testing.assert_close(ic.int8_conv_op(*args), ic.int8_conv_reference(*args),
                               rtol=0, atol=0)


def test_flop_count_keeps_the_convolution():
    from torch.utils.flop_counter import FlopCounterMode

    x = torch.randn(1, 128, 8, 8)
    wq, w_scale = ic.quantize_weight(torch.randn(64, 128, 3, 3))
    counter = FlopCounterMode(display=False)
    with counter:
        ic.int8_conv_op(x, wq, w_scale, 1, 1, 1)
    assert counter.get_total_flops() == 2 * 64 * 8 * 8 * 128 * 9


def test_int8_block_exports(monkeypatch):
    """A block exported by ``torch.export`` traces its weights' quantization
    (fake parameters have no storage for the cache's key) and calls the
    registered op once.  CPU tensors are routed through the op here, as CUDA
    tensors are on the card."""
    monkeypatch.setattr(blocks, "int8_conv",
                        lambda x, *a: ic.int8_conv_op(x, *a))
    m = blocks.ConvBnAct(128, 128, 3, int8_execution=True).eval()
    x = torch.randn(1, 128, 8, 8).contiguous(memory_format=torch.channels_last)
    ep = torch.export.export(m, (x,))
    ops = [n.target for n in ep.graph.nodes if n.op == "call_function"]
    assert ops.count(torch.ops.empanada_tpu_torch.int8_conv.default) == 1
    with torch.no_grad():
        torch.testing.assert_close(ep.module()(x), m(x), rtol=0, atol=0)


def test_card_wrapper_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the wrapper launches there")
    x = torch.randn(1, 128, 4, 4)
    wq, w_scale = ic.quantize_weight(torch.randn(8, 128, 3, 3))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ic.launch(x, wq, w_scale, 1, 1, 1)
    with pytest.raises(ValueError, match="no kernel for device"):
        ic.int8_conv(x.to("meta"), wq, w_scale, 1, 1, 1)
