"""The PointRend refine step of the PyTorch port
(empanada_tpu_torch/ops/pointrend_refine.py) against the JAX package's
Pallas kernel in interpret mode (empanada_tpu/ops/pallas_pointrend.py).

The refine mask and the copy-through pixels must be bit-exact; refined
pixels are held to the tolerance of tests/test_pointrend_fused.py, since
the two sum the point MLP's products in different orders."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from empanada_tpu.models.point_rend import PointRendSemSegHead as JaxHead
from empanada_tpu.models.point_rend import StandardPointHead as JaxPointHead
from empanada_tpu.ops import pallas_pointrend as ppr
from empanada_tpu.ops.interpolate import bilinear_resize as jax_resize
from empanada_tpu_torch.models.point_rend import PointRendSemSegHead, StandardPointHead
from empanada_tpu_torch.ops import pointrend_refine as prr
from empanada_tpu_torch.port.weights import load_flax

from _torch_port import to_numpy

BF16 = torch.bfloat16


def _inputs(seed, hc=64, wc=64, f=128, sf=2, n=2, fc_dim=64):
    """Seeded bf16 logits, coarse logits and features, and a point head's
    weights shared by the flax and torch heads."""
    rng = np.random.default_rng(seed)
    h, w = hc * sf // 2, wc * sf // 2
    sem = rng.normal(0, 1.5, (n, h, w, 1)).astype(np.float32)
    coarse = rng.normal(0, 1.5, (n, hc, wc, 1)).astype(np.float32)
    feats = rng.normal(0, 1, (n, hc, wc, f)).astype(np.float32)
    head = JaxPointHead(num_classes=1, fc_dim=fc_dim, num_fc=3, dtype=jnp.bfloat16)
    params = head.init(jax.random.key(seed), jnp.zeros((1, 4, f), jnp.bfloat16),
                       jnp.zeros((1, 4, 1), jnp.bfloat16))
    thead = StandardPointHead(f, 1, fc_dim, 3)
    load_flax(thead, to_numpy(params))
    return sem, coarse, feats, head, params, thead.to(BF16)


def _bf16(*arrays):
    return [torch.from_numpy(a).to(BF16) for a in arrays]


def _check(got, want, mask):
    """Bit-exact outside the mask, the stated tolerance inside."""
    assert np.array_equal(got[~mask], want[~mask])
    ref = want[mask]
    err = np.abs(got[mask] - ref)
    assert np.quantile(err, 0.99) <= 0.05 * (1 + np.quantile(np.abs(ref), 0.99))
    assert float(err.mean()) < 0.02 * (1 + float(np.abs(ref).mean()))


@pytest.mark.parametrize("sf", [2, 4])
def test_reference_matches_pallas_interpret(sf):
    sem, coarse, feats, head, params, thead = _inputs(3, sf=sf)
    num_points = 2048
    wts = head.apply(params, feats.shape[-1], method=head.fused_weights)
    jsem, jcoarse, jfeats = (jnp.asarray(a, jnp.bfloat16) for a in (sem, coarse, feats))
    want = ppr.fused_refine_step(jsem, ppr.pack_features(jfeats, jcoarse), wts,
                                 num_points, interpret=True)
    want = np.asarray(want, np.float32)

    tsem, tcoarse, tfeats = _bf16(sem, coarse, feats)
    got = prr.refine_step_reference(tsem, tfeats, tcoarse,
                                    thead.fused_weights(feats.shape[-1]), num_points)
    got = got.float().numpy()
    assert got.shape == want.shape == (2, 64 * sf, 64 * sf, 1)

    # the mask: |up| <= the exact K-th smallest |up|, with up bit-exact
    up = np.asarray(jax_resize(jsem, want.shape[1:3]), np.float32)
    thr = np.sort(np.abs(up).reshape(2, -1), axis=1)[:, num_points - 1]
    mask = np.abs(up) <= thr[:, None, None, None]
    t_up, t_thr = prr.step_inputs(tsem, num_points)
    np.testing.assert_array_equal(t_up.float().numpy(), up)
    np.testing.assert_array_equal(t_thr.numpy(), thr)
    assert 0 < mask.sum() < mask.size
    _check(got, want, mask)
    # the wrapper on CPU tensors is the plain version
    again = prr.fused_refine_step(tsem, tfeats, tcoarse,
                                  thead.fused_weights(feats.shape[-1]), num_points)
    assert torch.equal(again, prr.refine_step_reference(
        tsem, tfeats, tcoarse, thead.fused_weights(feats.shape[-1]), num_points))


def test_ragged_tiles_match_dense_oracle():
    # (h2, w2) = (40, 200) is no whole number of 16 x 128 tiles: the CUDA
    # kernel masks the ragged tiles, so the port takes this geometry (the
    # Pallas kernel does not); its plain version is held to the JAX dense path
    sem, coarse, feats, head, params, thead = _inputs(5, hc=20, wc=100, n=1)
    num_points = 512
    jsem, jcoarse, jfeats = (jnp.asarray(a, jnp.bfloat16) for a in (sem, coarse, feats))
    h2, w2 = 40, 200
    up = jax_resize(jsem, (h2, w2))
    u = -jnp.abs(up)
    kth = jax.lax.top_k(u.reshape(1, -1).astype(jnp.float32), num_points)[0][:, -1]
    mask = np.asarray(u.astype(jnp.float32) >= kth[:, None, None, None])
    dense = head.apply(
        params,
        jax_resize(jfeats, (h2, w2), zeros_padding=True).reshape(1, h2 * w2, -1),
        jax_resize(jcoarse, (h2, w2), zeros_padding=True).reshape(1, h2 * w2, 1),
    ).reshape(1, h2, w2, 1)
    want = np.asarray(jnp.where(mask, dense, up), np.float32)
    tsem, tcoarse, tfeats = _bf16(sem, coarse, feats)
    assert prr.fused_step_supported(h2, w2, 20, 100, 1, 128, BF16)
    got = prr.refine_step_reference(tsem, tfeats, tcoarse,
                                    thead.fused_weights(128), num_points)
    _check(got.float().numpy(), want, mask)


@pytest.mark.parametrize("thr,refined", [(-1.0, False), (float("inf"), True)])
def test_all_skip_and_all_refine(thr, refined):
    sem, coarse, feats, _, _, thead = _inputs(7, hc=16, wc=128, n=1)
    tsem, tcoarse, tfeats = _bf16(sem, coarse, feats)
    up, _ = prr.step_inputs(tsem, 64)
    got = prr.refine_reference(up, torch.tensor([thr]), tfeats, tcoarse,
                               thead.fused_weights(128))
    assert torch.equal(got, up) != refined
    if refined:
        assert (got != up).float().mean() > 0.9


class TestHead:
    def _heads(self, fc_dim=64, f=128):
        jh = {m: JaxHead(num_classes=1, fc_dim=fc_dim, num_fc=3,
                         subdivision_num_points=2048, dtype=jnp.bfloat16,
                         fused_render=m) for m in ("interpret", "never")}
        rng = np.random.default_rng(6)
        coarse = rng.normal(0, 1.5, (1, 64, 64, 1)).astype(np.float32)
        feats = rng.normal(0, 1, (1, 64, 64, f)).astype(np.float32)
        v = jh["interpret"].init(jax.random.key(0), jnp.asarray(coarse, jnp.bfloat16),
                                 jnp.asarray(feats, jnp.bfloat16), train=False,
                                 subdivision_steps=2)
        th = {m: load_flax(PointRendSemSegHead(f, 1, fc_dim, 3, 2048, fused_render=m),
                           to_numpy(v)).to(BF16) for m in ("auto", "never")}
        return jh, v, th, coarse, feats

    def test_two_step_subdivision_matches_pallas_and_torch_path(self):
        jh, v, th, coarse, feats = self._heads()
        jc, jf = jnp.asarray(coarse, jnp.bfloat16), jnp.asarray(feats, jnp.bfloat16)
        want = np.asarray(jh["interpret"].apply(v, jc, jf, train=False,
                                                subdivision_steps=2)["sem_seg_logits"],
                          np.float32)
        tc, tf = _bf16(coarse, feats)
        with torch.no_grad():
            fused = th["auto"](tc, tf, subdivision_steps=2)["sem_seg_logits"].float().numpy()
            plain = th["never"](tc, tf, subdivision_steps=2)["sem_seg_logits"].float().numpy()
        assert fused.shape == want.shape == plain.shape == (1, 256, 256, 1)
        # port kernel path against the Pallas kernel: step 2 starts from step
        # 1's refined logits, so a rounding difference there can move a few
        # step-2 mask pixels; nearly all pixels agree to bf16 rounding
        assert np.mean(np.isclose(fused, want, atol=0.11, rtol=0.15)) > 0.995
        # the fused path against the torch dense/sparse path, as
        # tests/test_pointrend_fused.py holds the two JAX paths
        assert np.mean(np.isclose(fused, plain, atol=0.11, rtol=0.15)) > 0.97

    def test_fused_render_values(self):
        with pytest.raises(ValueError, match="fused_render"):
            PointRendSemSegHead(128, 1, 64, fused_render="alway")
        head = PointRendSemSegHead(128, 1, 64, fused_render="always")
        with pytest.raises(ValueError, match="refine kernel"):
            head(torch.zeros(1, 8, 8, 1), torch.zeros(1, 8, 8, 128))  # f32
        # "interpret" runs the kernel's plain version on any device: on the
        # CPU it is what "auto" and "always" run
        gen = torch.Generator().manual_seed(0)
        coarse = torch.randn(1, 16, 64, 1, generator=gen).to(BF16)
        feats = torch.randn(1, 16, 64, 128, generator=gen).to(BF16)
        outs = {}
        for mode in ("interpret", "auto", "always"):
            head = PointRendSemSegHead(128, 1, 64, subdivision_num_points=256,
                                       fused_render=mode)
            torch.manual_seed(1)
            head.point_head = StandardPointHead(128, 1, 64, 3)
            with torch.no_grad():
                outs[mode] = head.to(BF16)(coarse, feats)["sem_seg_logits"]
        assert outs["interpret"].shape == (1, 64, 256, 1)
        assert torch.equal(outs["interpret"], outs["auto"])
        assert torch.equal(outs["interpret"], outs["always"])


def test_cuda_request_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the kernel would launch")
    sem, coarse, feats, _, _, thead = _inputs(8, hc=16, wc=128, n=1)
    tsem, tcoarse, tfeats = _bf16(sem, coarse, feats)
    up, thr = prr.step_inputs(tsem, 64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        prr.launch(up, thr, tfeats, tcoarse, thead.fused_weights(128))
    with pytest.raises(ValueError, match="no kernel"):
        prr.refine(up.to("meta"), thr.to("meta"), tfeats, tcoarse,
                   thead.fused_weights(128))
