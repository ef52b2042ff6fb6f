"""The refine kernel's host-side layouts (empanada_tpu_torch/ops/pointrend_refine.py):
the packed weight buffer that the kernel's weight slices are bulk-copied
from, the plain version of its select pass, the point head's cache of the
packed buffer, and the wrapper's refusals.  The kernel itself runs only on
the card (chip_smoke.py phases 3-7).

The select pass's list must hold exactly the pixels of the JAX package's
refine mask (|up| <= the exact K-th smallest |up|, empanada_tpu's
fused_refine_step), in any order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from empanada_tpu.ops.interpolate import bilinear_resize as jax_resize
from empanada_tpu_torch.models.point_rend import StandardPointHead
from empanada_tpu_torch.ops import pointrend_refine as prr

BF16 = torch.bfloat16


def _head(f, d, seed=0, num_fc=3):
    torch.manual_seed(seed)
    return StandardPointHead(f, 1, d, num_fc).to(BF16)


def _same(a, b):
    return a.shape == b.shape and torch.equal(a.float(), b.float())


@pytest.mark.parametrize("f,d", [(256, 256), (128, 64)], ids=["mitonet", "narrow"])
def test_pack_unpack_gives_back_every_weight(f, d):
    wts = _head(f, d).fused_weights(f)
    packed = prr.pack_weights(wts)
    assert packed.buf.dtype == BF16 and (packed.in_features, packed.fc_dim) == (f, d)
    # three layers of K-slices (HIDDEN rows of 64), then 2L + 1 vectors and 8 scalars
    assert packed.buf.numel() == (f + 2 * 256) * 256 + 7 * 256 + 8
    layers, (wp, wpc, bp) = prr.unpack_weights(packed)
    for (wf, wc, b), (wf2, wc2, b2) in zip(wts[0], layers):
        assert _same(wf, wf2) and _same(wc, wc2) and _same(b, b2)
    assert _same(wts[1][0], wp) and float(wts[1][1]) == float(wpc)
    assert float(wts[1][2]) == float(bp)


@pytest.mark.parametrize("f,d", [(256, 256), (128, 64)], ids=["mitonet", "narrow"])
def test_packed_slices_are_the_wgmma_swizzle(f, d):
    # element (k, n) of W_l sits in K-slice k // 64, row n, 16-byte chunk
    # (k % 64 // 8) XOR (n % 8), place k % 8; columns n >= D are zeros
    wts = _head(f, d, seed=1).fused_weights(f)
    buf = prr.pack_weights(wts).buf.float()
    rng = np.random.default_rng(0)
    off = 0
    for l, (wf, _, _) in enumerate(wts[0]):
        kp = f if l == 0 else 256
        for k, n in zip(rng.integers(0, wf.shape[0], 64), rng.integers(0, 256, 64)):
            s, kk = divmod(int(k), 64)
            at = off + s * 256 * 64 + n * 64 + ((kk // 8) ^ (n % 8)) * 8 + kk % 8
            want = float(wf[k, n]) if n < d else 0.0
            assert float(buf[at]) == want
        off += 256 * kp
    assert torch.equal(buf[off:off + 256][:d], wts[0][0][1].float().reshape(-1))
    assert not buf[off:off + 256][d:].any()


def test_reference_takes_packed_weights():
    rng = np.random.default_rng(4)
    up = torch.from_numpy(rng.normal(0, 1.5, (2, 32, 48, 1)).astype(np.float32)).to(BF16)
    feats = torch.from_numpy(rng.normal(0, 1, (2, 16, 24, 128)).astype(np.float32)).to(BF16)
    coarse = torch.from_numpy(rng.normal(0, 1.5, (2, 16, 24, 1)).astype(np.float32)).to(BF16)
    thr = torch.tensor([0.5, float("inf")])
    head = _head(128, 64, seed=2)
    want = prr.refine_reference(up, thr, feats, coarse, head.fused_weights(128))
    got = prr.refine_reference(up, thr, feats, coarse, head.packed_weights(128))
    assert torch.equal(got, want) and not torch.equal(got, up)


def _check_select(up, thr):
    points, count = prr.select_points_reference(up, thr)
    want = (up[..., 0].float().abs() <= thr.float()[:, None, None]).nonzero()
    assert count == len(want) == len(points)
    key = (points[:, 0] * up.shape[1] + points[:, 1]) * up.shape[2] + points[:, 2]
    assert torch.equal(points[torch.argsort(key)], want)
    return points


@pytest.mark.parametrize("case", ["all-skip", "all-refine", "ragged"])
def test_select_pass_lists_the_mask(case):
    rng = np.random.default_rng(1)
    shape = (3, 36, 52, 1) if case == "ragged" else (2, 32, 64, 1)  # 5616 px: no whole warp
    up = torch.from_numpy(rng.normal(0, 1.5, shape).astype(np.float32)).to(BF16)
    thr = {"all-skip": torch.full((shape[0],), -1.0),
           "all-refine": torch.full((shape[0],), float("inf")),
           "ragged": torch.tensor([0.2, -1.0, float("inf")])}[case]
    points = _check_select(up, thr)
    assert len(points) == {"all-skip": 0, "all-refine": up.numel()}.get(case, len(points))
    if case == "ragged":
        assert (points[:, 0] == 2).sum() == 36 * 52 and not (points[:, 0] == 1).any()
        # the kernel's order: within a warp's 256 pixels, place k of each
        # thread's 8 before place k + 1
        flat = (points[:, 0] * 36 + points[:, 1]) * 52 + points[:, 2]
        warp, k = flat // 256, flat % 8
        same = warp[1:] == warp[:-1]
        assert (k[1:][same] >= k[:-1][same]).all() and (warp[1:] >= warp[:-1]).all()


def test_select_pass_lists_the_jax_mask_at_the_kth_threshold():
    rng = np.random.default_rng(2)
    sem = rng.normal(0, 1.5, (2, 24, 40, 1)).astype(np.float32)
    num_points = 300
    jsem = jnp.asarray(sem, jnp.bfloat16)
    up_j = np.asarray(jax_resize(jsem, (48, 80)), np.float32)
    thr_j = np.sort(np.abs(up_j).reshape(2, -1), axis=1)[:, num_points - 1]
    mask = np.abs(up_j[..., 0]) <= thr_j[:, None, None]
    up, thr = prr.step_inputs(torch.from_numpy(sem).to(BF16), num_points)
    points = _check_select(up, thr)
    np.testing.assert_array_equal(np.sort(points[:, 0] * 10**6 + points[:, 1] * 1000
                                          + points[:, 2]),
                                  np.sort(np.stack(np.nonzero(mask)).T
                                          @ np.array([10**6, 1000, 1])))
    assert len(points) >= 2 * num_points


def test_point_head_caches_packed_weights():
    head = _head(128, 64, seed=3)
    first = head.packed_weights(128)
    assert head.packed_weights(128) is first
    with torch.no_grad():
        head.fc2.weight.add_(1.0)  # in place: the parameter's version moves
    second = head.packed_weights(128)
    assert second is not first and not torch.equal(second.buf, first.buf)
    assert torch.equal(prr.unpack_weights(second)[0][1][0].float(),
                       head.fc2.weight.detach().t()[:-1].float())
    head.predictor.bias = torch.nn.Parameter(torch.ones(1, dtype=BF16))  # replaced
    third = head.packed_weights(128)
    assert third is not second and float(prr.unpack_weights(third)[1][2]) == 1.0


def _launch_inputs(d):
    up, _ = prr.step_inputs(torch.zeros(1, 16, 16, 1, dtype=BF16), 8)
    feats = torch.zeros(1, 16, 16, 128, dtype=BF16)
    coarse = torch.zeros(1, 16, 16, 1, dtype=BF16)
    return up, torch.zeros(1), feats, coarse, _head(128, d).fused_weights(128)


def test_wrapper_raises_without_card_and_on_unsupported_widths(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the kernel would launch")
    args = _launch_inputs(64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        prr.launch(*args)
    # past the device check, the widths are refused before any build
    monkeypatch.setattr(prr.torch.cuda, "is_available", lambda: True)
    for d in (40, 272):
        with pytest.raises(ValueError, match="D % 16 == 0, D <= 256"):
            prr.launch(*_launch_inputs(d))
    up, thr, feats, coarse, wts = args
    with pytest.raises(ValueError, match="contiguous bf16"):
        prr.launch(up, thr, feats.float(), coarse, wts)
