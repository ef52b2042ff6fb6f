"""Panoptic postprocess of the PyTorch port (empanada_tpu_torch/ops/postprocess.py)
against the JAX package's (empanada_tpu/ops/postprocess.py): on identical
(sem, ctr, off) inputs the centers, counts and every id map must be exactly
equal.  The port builds its histograms with ``scatter_add_`` and integer id
tables where the JAX package uses bf16 one-hot matmuls."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_blob_image
from empanada_tpu.ops import postprocess as jpp
from empanada_tpu_torch.ops import postprocess as tpp


def _t(a):
    return torch.from_numpy(np.array(a))


def _peaks_and_offsets(rng, h, w, n_centers, step):
    """A center heatmap (1, h, w, 1) with ``n_centers`` Gaussian peaks and
    offsets (1, h, w, 2) in full-resolution units pointing each pixel at its
    nearest peak, plus noise."""
    cy = rng.uniform(0, h - 1, n_centers)
    cx = rng.uniform(0, w - 1, n_centers)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    d2 = (yy[..., None] - cy) ** 2 + (xx[..., None] - cx) ** 2
    hmp = np.exp(-d2 / (2 * 1.5**2)).max(-1) + rng.uniform(0, 0.05, (h, w))
    near = d2.argmin(-1)
    off = np.stack([cy[near] - yy, cx[near] - xx], -1) * step
    off += rng.normal(0, 0.7, off.shape)
    return (hmp[None, :, :, None].astype(np.float32),
            off[None].astype(np.float32))


def em_density_inputs(seed=0, size=512, n_centers=160, step=4):
    """The EM-density regime of tests/test_em_density.py (O(100) instances
    in a 512 x 512 slice): blob-image logits at full resolution, center
    heatmap and offsets at 1/``step``."""
    rng = np.random.default_rng(seed)
    img = make_blob_image((size, size), n_blobs=n_centers, seed=seed).astype(np.float32)
    sem = (0.55 - img / 255.0) * 12.0 + rng.normal(0, 0.3, img.shape)
    hmp, off = _peaks_and_offsets(rng, size // step, size // step, n_centers, step)
    return sem[None, :, :, None].astype(np.float32), hmp, off


def test_em_density_fused_post_exact():
    sem, hmp, off = em_density_inputs()
    kw = dict(coarse_boundaries=True, upsampling=1, threshold=0.1, nms_kernel=7,
              max_centers=2048, return_overflow=True, keep_coarse=True)
    jcells, jover = jpp.get_instance_cells(jnp.asarray(hmp), jnp.asarray(off), **kw)
    tcells, tover = tpp.get_instance_cells(_t(hmp), _t(off), **kw)
    np.testing.assert_array_equal(tcells.numpy(), np.asarray(jcells))
    assert int(tover) == int(jover) == 0
    merge = dict(label_divisor=1000, thing_list=(1,), stuff_area=64, void_label=0,
                 num_classes=2, max_centers=2048, step=4)
    jsem = jpp.harden_median_space(jnp.asarray(sem), 0.5)
    tsem = tpp.harden_median_space(_t(sem), 0.5)
    np.testing.assert_array_equal(tsem.numpy(), np.asarray(jsem))
    want = np.asarray(jpp.merge_semantic_and_instance_coarse(jsem, jcells, **merge))
    got = tpp.merge_semantic_and_instance_coarse(tsem, tcells, **merge).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got[got > 0])) >= 100  # the density the fixture is for


def test_find_instance_center_overflow_count():
    # 25 isolated peaks, cap at 16: the first 16 in scanline order and 9 dropped
    hmp = np.zeros((1, 40, 40, 1), np.float32)
    hmp[0, 4::8, 4::8, 0] = 0.9
    for k in (16, 32):
        jc, jv, jn = jpp.find_instance_center(jnp.asarray(hmp), 0.1, 3, k,
                                              return_count=True)
        tc, tv, tn = tpp.find_instance_center(_t(hmp), 0.1, 3, k, return_count=True)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        assert int(tn) == int(jn) == 25
        _, jover = jpp.get_instance_cells(jnp.asarray(hmp), jnp.zeros((1, 40, 40, 2)),
                                          False, threshold=0.1, nms_kernel=3,
                                          max_centers=k, return_overflow=True)
        _, tover = tpp.get_instance_cells(_t(hmp), torch.zeros(1, 40, 40, 2), False,
                                          threshold=0.1, nms_kernel=3, max_centers=k,
                                          return_overflow=True)
        assert int(tover) == int(jover) == max(25 - k, 0)


@pytest.mark.parametrize("nms_kernel,shape,max_centers", [
    (7, (48, 56), 64), (4, (33, 47), 64), (3, (5, 7), 256), (7, (24, 24), 8),
])
def test_find_instance_center(nms_kernel, shape, max_centers):
    rng = np.random.default_rng(nms_kernel)
    hmp, _ = _peaks_and_offsets(rng, *shape, n_centers=12, step=1)
    want = jpp.find_instance_center(jnp.asarray(hmp), 0.1, nms_kernel, max_centers,
                                    return_count=True)
    got = tpp.find_instance_center(_t(hmp), 0.1, nms_kernel, max_centers,
                                   return_count=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("step", [1, 4])
def test_group_pixels(step):
    rng = np.random.default_rng(step)
    hmp, off = _peaks_and_offsets(rng, 37, 45, n_centers=20, step=step)
    centers, valid = jpp.find_instance_center(jnp.asarray(hmp), max_centers=32)
    want = np.asarray(jpp.group_pixels(centers, valid, jnp.asarray(off), step=step))
    got = tpp.group_pixels(_t(np.asarray(centers)), _t(np.asarray(valid)), _t(off),
                           step=step, pixel_chunk=500)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # no valid center -> all zeros
    none = tpp.group_pixels(_t(np.asarray(centers)), torch.zeros(32, dtype=torch.bool),
                            _t(off), step=step)
    assert not none.any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_dense_with_stuff_classes(seed):
    # three classes, things {1, 2}, class 0 and 3 are stuff
    rng = np.random.default_rng(seed)
    sem = rng.integers(0, 4, (1, 32, 40)).astype(np.int32)
    ins = rng.integers(0, 9, (1, 32, 40)).astype(np.int32)
    ins = np.where(np.isin(sem, (1, 2)), ins, 0)
    kw = dict(label_divisor=1000, thing_list=(1, 2), stuff_area=150, void_label=7,
              num_classes=4, max_centers=8)
    want = np.asarray(jpp.merge_semantic_and_instance(jnp.asarray(sem), jnp.asarray(ins),
                                                      **kw))
    got = tpp.merge_semantic_and_instance(_t(sem), _t(ins), **kw).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("step", [2, 4, 8])
def test_merge_coarse(step):
    rng = np.random.default_rng(step)
    cells = rng.integers(0, 9, (1, 12, 10)).astype(np.int32)
    sem = rng.integers(0, 3, (1, 12 * step, 10 * step)).astype(np.int32)
    kw = dict(label_divisor=100, thing_list=(1,), stuff_area=40, void_label=0,
              num_classes=3, max_centers=8, step=step)
    want = np.asarray(jpp.merge_semantic_and_instance_coarse(
        jnp.asarray(sem), jnp.asarray(cells), **kw))
    got = tpp.merge_semantic_and_instance_coarse(_t(sem), _t(cells), **kw).numpy()
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="step"):
        tpp.merge_semantic_and_instance_coarse(_t(sem), _t(cells[:, :-1]), **kw)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("thr", [0.5, 0.3, 0.9])
def test_harden_logits(dtype, thr):
    x = np.random.default_rng(5).normal(0, 2, (1, 20, 30, 1)).astype(np.float32)
    lt = np.float32(np.log(thr / (1 - thr)))
    # one ulp either side of the threshold (a normal number: XLA on the CPU
    # flushes subnormals to zero, torch does not)
    ulp = max(np.spacing(abs(lt)), np.finfo(np.float32).tiny)
    x[0, 0, :5, 0] = [lt, lt - ulp, lt + ulp, 0, -0.0]
    if dtype == "bfloat16":
        jx, tx = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    else:
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
    np.testing.assert_array_equal(tpp.harden_logits(tx, thr).numpy(),
                                  np.asarray(jpp.harden_logits(jx, thr)))
    with pytest.raises(ValueError):
        tpp.harden_logits(tx, 1.0)


def test_median_space_multiclass():
    x = np.random.default_rng(6).normal(0, 2, (1, 10, 12, 3)).astype(np.float32)
    np.testing.assert_allclose(tpp.to_median_space(_t(x)).numpy(),
                               np.asarray(jpp.to_median_space(jnp.asarray(x))),
                               atol=1e-6, rtol=0)
    np.testing.assert_array_equal(
        tpp.harden_median_space(tpp.to_median_space(_t(x))).numpy(),
        np.asarray(jpp.harden_median_space(jpp.to_median_space(jnp.asarray(x)))))
    np.testing.assert_array_equal(tpp.to_median_space(_t(x[..., :1])).numpy(), x[..., :1])


@pytest.mark.parametrize("buckets", [False, True])
@pytest.mark.parametrize("hw", [(150, 173), (16, 16), (600, 700), (1, 2049)])
def test_factor_pad(buckets, hw):
    x = np.ones((1, *hw, 1), np.float32)
    want = np.asarray(jpp.factor_pad(jnp.asarray(x), 16, buckets=buckets))
    got = tpp.factor_pad(_t(x), 16, buckets=buckets).numpy()
    np.testing.assert_array_equal(got, want)
    for n in (1, 17, 300, 2100, 9000):
        assert tpp.bucket_dim(n, 16) == jpp.bucket_dim(n, 16)
