"""MitoNet_v1_mini's modules in the port against the JAX package's, in
float32 on the CPU with the same weights (seeded values in the flax tree,
carried by the weight bridge): the blocks (per-pixel squeeze-excite, the
parameterless identity resample, nearest-up and max-pool-down resizes, the
transposed conv through the bridge, with its spatial flip), RegNet, the
BiFPN (one shared ``after_combine`` per pass, ``fusion_weights``) and its
decoder, ``PanopticBiFPN{,PR}``, ``PanopticDeepLab`` on a RegNet encoder,
the mini at full width from its config, and the mini through the render
engine, ``Engine2d`` and a ``MultiChipEngine3d`` xy sweep.  Forward maps
within 1e-5; id maps and trackers equal."""

import jax
import numpy as np
import pytest
import torch

from _torch_port import jax_init, one_torch_thread, port_model, random_variables  # noqa: F401
from conftest import make_blob_image
from empanada_tpu import api as jax_api
from empanada_tpu.engine import PanopticDeepLabRenderEngine as JaxRenderEngine
from empanada_tpu.models import blocks as jblocks
from empanada_tpu.models import decoders as jdecoders
from empanada_tpu.models import regnet as jregnet
from empanada_tpu.parallel.data_parallel import MultiChipEngine3d as JaxEngine3d
from empanada_tpu.parallel.mesh import create_mesh
from empanada_tpu_torch import api
from empanada_tpu_torch.api import Preprocessor
from empanada_tpu_torch.engine import PanopticDeepLabRenderEngine
from empanada_tpu_torch.models import MODEL_REGISTRY, blocks, create_model, decoders, regnet
from empanada_tpu_torch.parallel.data_parallel import MultiChipEngine3d
from empanada_tpu_torch.port.weights import flatten_variables, from_flax, load_flax
from test_torch_ortho import _volume, assert_same_trackers

TOL = 1e-5

# the mini's chain at narrow width: regnety_200mf, fpn_dim 32, 2 BiFPN layers
SMALL_MINI = dict(encoder="regnety_200mf", num_classes=1, fpn_dim=32, fpn_layers=2,
                  ins_decoder=False, depthwise=True, subdivision_num_points=256)
REGNET_DEEPLAB = dict(encoder="regnety_200mf", num_classes=1, decoder_channels=32,
                      low_level_stages=[1], low_level_channels_project=[16],
                      ins_decoder=True)
CFG = {
    "model_name": "mini",
    "class_names": {1: "mito"},
    "labels": [1],
    "thing_list": [1],
    "model": "unused",
    "padding_factor": 128,
    "norms": {"mean": 0.57571, "std": 0.12765},
}


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _jax_module(module, *inputs, seed=0):
    """(variables, output) of a flax module: seeded variables
    (``random_variables``), ``apply`` under ``jax.jit``."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.key(seed), *inputs))
    variables = random_variables(shapes, seed)
    out = jax.jit(module.apply)(variables, *inputs)
    return variables, jax.tree.map(np.asarray, out)


def _input(shape, seed=1):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def _close(got, want, tol=TOL):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


# ---- blocks -------------------------------------------------------------


def test_squeeze_excite_gates_per_pixel():
    x = _input((1, 6, 7, 16))
    variables, want = _jax_module(jblocks.SqueezeExcite(), x)
    se = load_flax(blocks.SqueezeExcite(16), variables)
    xt = _nchw(x)
    with torch.no_grad():
        got = _nhwc(se(xt))
        pooled_gate = se.excite(torch.relu(se.squeeze(xt.mean(dim=(2, 3), keepdim=True))))
        pooled = _nhwc(xt * torch.sigmoid(pooled_gate))
    _close(got, want)
    # the gate differs pixel by pixel: global pooling would give another map
    assert np.abs(pooled - want).max() > 1e-2


def test_resample2d_identity_has_no_parameters():
    x = _input((1, 5, 6, 8))
    ident = blocks.Resample2d(8, 8)
    assert not list(ident.parameters()) and not ident.state_dict()
    xt = _nchw(x)
    assert ident(xt) is xt
    variables, want = _jax_module(jblocks.Resample2d(8), x)
    assert flatten_variables(variables) == {}
    np.testing.assert_array_equal(want, x)
    for nout, stride in ((12, 1), (8, 2)):
        variables, want = _jax_module(jblocks.Resample2d(nout, stride=stride), x)
        res = load_flax(blocks.Resample2d(8, nout, stride=stride), variables)
        with torch.no_grad():
            _close(_nhwc(res(_nchw(x))), want)


@pytest.mark.parametrize("up_or_down", ["up", "down"])
def test_resize2d(up_or_down):
    x = _input((2, 7, 10, 3))
    _, want = _jax_module(jblocks.Resize2d(2, up_or_down), x)
    got = _nhwc(blocks.Resize2d(2, up_or_down)(_nchw(x)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["nearest", "bilinear"])
def test_interpolate2d(mode):
    x = _input((1, 5, 6, 3))
    for align in (False, True):
        _, want = _jax_module(jblocks.Interpolate2d(4, mode, align), x)
        _close(_nhwc(blocks.Interpolate2d(4, mode, align)(_nchw(x))), want)


def test_conv_transpose_through_the_bridge():
    """The flax kernel reaches torch flipped in space; without the flip the
    map is another one (the kernel is not symmetric)."""
    x = _input((1, 5, 6, 12))
    variables, want = _jax_module(jblocks.ConvTransposeBnAct(8, 2), x)
    tconv = load_flax(blocks.ConvTransposeBnAct(12, 8, 2), variables)
    with torch.no_grad():
        got = _nhwc(tconv(_nchw(x)))
        _close(got, want)
        kernel = variables["params"]["tconv"]["kernel"]
        tconv.tconv.weight.copy_(torch.from_numpy(np.transpose(kernel, (2, 3, 0, 1)).copy()))
        unflipped = _nhwc(tconv(_nchw(x)))
    assert np.abs(unflipped - want).max() > 0.1


# ---- RegNet -------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(regnet.regnet_configs))
def test_regnet_params_match_jax(name):
    got = regnet.RegNetParams(**regnet.regnet_configs[name])
    want = jregnet.RegNetParams(**jregnet.regnet_configs[name])
    assert (got.widths, got.depths, got.groups, got.use_se) == (
        want.widths, want.depths, want.groups, want.use_se)
    assert regnet.regnet_configs[name] == jregnet.regnet_configs[name]


def test_regnety_200mf_with_se_matches_jax():
    p = regnet.RegNetParams(**regnet.regnet_configs["regnety_200mf"])
    x = _input((1, 64, 64, 1))
    variables, want = _jax_module(jregnet.RegNet(tuple(p.widths), tuple(p.depths),
                                                 tuple(p.groups), use_se=True), x)
    assert any("se" in path for path in flatten_variables(variables))
    net = load_flax(regnet.RegNet(p.widths, p.depths, p.groups, use_se=True), variables)
    with torch.no_grad():
        got = net(_nchw(x))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        _close(_nhwc(g), w)


# ---- BiFPN --------------------------------------------------------------


@pytest.mark.parametrize("widths,depthwise", [((12, 20, 28), True), ((16, 16, 16), True),
                                              ((12, 20, 28), False)])
def test_bifpn_matches_jax(widths, depthwise):
    """Strides 8-32 of a 128 px image.  Widths equal to fpn_dim leave the
    identity resamples without parameters; each pass holds one shared
    ``after_combine``."""
    feats = [_input((1, 128 // s, 128 // s, c), seed=i)
             for i, (s, c) in enumerate(zip((8, 16, 32), widths))]
    variables, want = _jax_module(jdecoders.BiFPN(16, 2, depthwise), feats)
    names = ["/".join(p) for p in flatten_variables(variables)]
    per_pass = [n for n in names if n.startswith("params/") and "after_combine" in n
                and n.endswith("kernel")]
    assert len(per_pass) == 2 * 2 * (2 if depthwise else 1)  # layers x passes x convs
    net = load_flax(decoders.BiFPN(widths, 16, 2, depthwise), variables)
    with torch.no_grad():
        got = net([_nchw(f) for f in feats])
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        _close(_nhwc(g), w)


def test_bifpn_decoder_matches_jax():
    feats = [_input((1, 2 << i, 2 << i, 16), seed=i) for i in range(6)]
    variables, want = _jax_module(jdecoders.BiFPNDecoder(16), feats)
    net = load_flax(decoders.BiFPNDecoder(16), variables)
    with torch.no_grad():
        _close(_nhwc(net([_nchw(f) for f in feats])), want)


# ---- assemblies ---------------------------------------------------------


def _forward_both(arch, kw, size, seed=0):
    model, variables = jax_init(arch, kw, size=size, seed=seed)
    x = _input((1, size, size, 1), seed=seed + 5)
    want = jax.jit(lambda v, x: model.apply(v, x, train=False))(variables, x)
    tmodel = port_model(arch, kw, variables)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x))
    return got, jax.tree.map(np.asarray, want)


@pytest.mark.parametrize("arch,kw,size", [
    ("PanopticBiFPNPR", SMALL_MINI, 128),
    ("PanopticBiFPN", dict(SMALL_MINI, num_classes=2, ins_decoder=True,
                           subdivision_num_points=None), 128),
    ("PanopticDeepLab", REGNET_DEEPLAB, 64),
], ids=["bifpn-pr", "bifpn-ins-decoder", "deeplab-regnet"])
def test_assembly_matches_jax(arch, kw, size):
    kw = {k: v for k, v in kw.items() if v is not None}
    got, want = _forward_both(arch, kw, size)
    assert sorted(got) == sorted(want) == ["ctr_hmp", "offsets", "sem_logits"]
    for k in want:
        _close(got[k].numpy(), want[k])


ALL_ARCHS = {
    "PanopticDeepLab": (REGNET_DEEPLAB, 64),
    "PanopticDeepLabPR": (dict(REGNET_DEEPLAB, encoder="resnet18",
                               subdivision_num_points=256), 64),
    "PanopticDeepLabBC": (dict(REGNET_DEEPLAB, encoder="resnet18",
                               subdivision_num_points=256), 64),
    "PanopticBiFPN": ({k: v for k, v in SMALL_MINI.items()
                       if k != "subdivision_num_points"}, 128),
    "PanopticBiFPNPR": (SMALL_MINI, 128),
}


@pytest.mark.parametrize("arch", sorted(ALL_ARCHS))
def test_from_flax_sets_every_parameter(arch):
    """Every port parameter set, no flax leaf left over (``from_flax``
    raises on either), for each registered architecture."""
    assert sorted(MODEL_REGISTRY) == sorted(ALL_ARCHS)
    kw, size = ALL_ARCHS[arch]
    _, variables = jax_init(arch, kw, size=size)
    tmodel = create_model(arch, device="cpu", **kw)
    state = from_flax(variables, tmodel)
    assert sorted(state) == sorted(tmodel.state_dict())
    assert len(state) == len(flatten_variables(variables))


# ---- MitoNet_v1_mini at full width --------------------------------------


@pytest.fixture(scope="module")
def full_mini():
    cfg = api.load_config("MitoNet_v1_mini")
    model, variables = jax_init(cfg["arch"], cfg["model_kwargs"], size=128)
    return cfg, model, variables, port_model(cfg["arch"], cfg["model_kwargs"], variables)


def test_full_width_mini_forward_and_render(full_mini):
    """regnety_6p4gf, fpn_dim 160, 3 BiFPN layers, K = 8192 on one 128²
    input: every forward map within 1e-5 (measured: 5.4e-7), and the
    render engine's panoptic map equal."""
    cfg, model, variables, tmodel = full_mini
    x = _input((1, 128, 128, 1), seed=7)
    want = jax.jit(lambda v, x: model.apply(v, x, train=False))(variables, x)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x))
    for k in want:
        _close(got[k].numpy(), np.asarray(want[k]))
    img = make_blob_image((128, 128), n_blobs=6, seed=8)
    image = Preprocessor(**cfg["norms"])(img)["image"]
    kw = dict(thing_list=[1], padding_factor=128, nms_kernel=3, max_centers=32)
    pan = PanopticDeepLabRenderEngine(tmodel, device="cpu", **kw)(image, img.shape)
    want_pan = JaxRenderEngine(model, variables, **kw)(image, img.shape)
    np.testing.assert_array_equal(pan, want_pan)


# ---- the mini through the engines (narrow) -------------------------------


@pytest.fixture(scope="module")
def mini():
    model, variables = jax_init("PanopticBiFPNPR", SMALL_MINI, size=128)
    return model, variables, port_model("PanopticBiFPNPR", SMALL_MINI, variables)


KW2D = dict(nms_kernel=3, max_centers=32, confidence_thr=0.5)


def test_mini_render_engine_and_engine2d_match_jax(mini):
    model, variables, tmodel = mini
    img = make_blob_image((150, 170), n_blobs=10, seed=11)
    image = Preprocessor(**CFG["norms"])(img)["image"]
    kw = dict(thing_list=[1], padding_factor=128, nms_kernel=3, max_centers=32)
    pan = PanopticDeepLabRenderEngine(tmodel, device="cpu", **kw)(image, img.shape)
    np.testing.assert_array_equal(pan, JaxRenderEngine(model, variables, **kw)(image,
                                                                                img.shape))
    got = api.Engine2d(CFG, model=tmodel, device="cpu", **KW2D).infer(img)
    want = jax_api.Engine2d(CFG, model_and_variables=(model, variables), **KW2D).infer(img)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got[got > 0])) >= 1


def test_mini_multichip_xy_sweep_matches_jax(mini):
    model, variables, tmodel = mini
    vol = _volume((12, 100, 120), seed=12)
    kw = dict(median_kernel_size=3, min_size=10, min_extent=1, max_centers=32,
              confidence_thr=0.5, save_panoptic=True, batch_size=4)
    want = JaxEngine3d(CFG, model_and_variables=(model, variables), sweep_fused=False,
                       volume_resident=False, mesh=create_mesh(1), **kw).infer_on_axis(vol, "xy")
    got = MultiChipEngine3d(CFG, tmodel, device="cpu", **kw).infer_on_axis(vol, "xy")
    np.testing.assert_array_equal(got[0], want[0])
    assert_same_trackers(got[1], want[1])
    assert len(got[1][0].instances) >= 1
