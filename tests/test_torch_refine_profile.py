"""Plain versions of the refine profiling kernels
(``empanada_tpu_torch/ops/refine_profile.py``) against the functions they
stand for: the tile copy and the gated tile copy against the TPU kernels'
``k_copy`` / ``k_when`` semantics written in ``jnp`` (per 16 x 128 tile
here, the port's tiling), and the refine cuts against the port's
``sample_points`` (held to JAX by tests/test_torch_refine.py) and a numpy
top-left tap.  The CUDA kernels themselves run only on the card
(chip_smoke.py phase "refine profile"); here the wrappers must take the
plain version on CPU tensors and refuse to fall back otherwise."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from empanada_tpu_torch.ops import pointrend_refine as prr
from empanada_tpu_torch.ops import refine_profile as rp


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _jnp_k_when(s, thr, th=16, tw=128):
    """k_when over every tile of (N, H, W): s * 2 where any |s| <= thr[n]."""
    n, h, w = s.shape
    out = []
    for b in range(n):
        rows = []
        for r0 in range(0, h, th):
            cols = []
            for c0 in range(0, w, tw):
                t = s[b, r0:r0 + th, c0:c0 + tw]
                m = jnp.any(jnp.abs(t.astype(jnp.float32)) <= thr[b])
                cols.append(jnp.where(m, t * 2, t))
            rows.append(jnp.concatenate(cols, axis=1))
        out.append(jnp.concatenate(rows, axis=0))
    return jnp.stack(out)


@pytest.mark.parametrize("shape", [(2, 32, 256), (3, 40, 300)], ids=["tiles", "ragged"])
def test_copy_and_gated_copy(shape):
    rng = np.random.default_rng(0)
    s = rng.normal(0, 1, shape).astype(np.float32)
    s[0] += 3.0 * np.sign(s[0])  # image 0: |s| >= 3 except where the gate fires
    s[0, 20, 200 % shape[2]] = 0.01
    x = _bf16(s)
    np.testing.assert_array_equal(rp.tile_copy(x).float().numpy(), x.float().numpy())
    thr = np.array([0.5] * shape[0], np.float32)
    thr[-1] = -1.0  # all skip
    want = _jnp_k_when(jnp.asarray(s, jnp.bfloat16), jnp.asarray(thr))
    got = rp.gated_tile_copy(x, torch.from_numpy(thr), reserve=(256, 256))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    assert (got[0] != x[0]).any() and (got[0] == x[0]).any()  # some tiles gate, some not
    assert torch.equal(got[-1], x[-1])


def _step(seed, n=2, hc=12, wc=20, fdim=32, sf=2):
    rng = np.random.default_rng(seed)
    feats = _bf16(rng.normal(0, 1, (n, hc, wc, fdim)))
    coarse = _bf16(rng.normal(0, 1.5, (n, hc, wc, 1)))
    up = _bf16(rng.normal(0, 1.5, (n, sf * hc, sf * wc, 1)))
    thr = torch.tensor([0.3, float("inf")][:n], dtype=torch.float32)
    return up, thr, feats, coarse


@pytest.mark.parametrize("sf", [2, 4])
def test_refine_cuts(sf):
    up, thr, feats, coarse = _step(sf, sf=sf)
    n, h2, w2, _ = up.shape
    mask = up[..., 0].float().abs() <= thr[:, None, None]
    b, r, c = mask.nonzero(as_tuple=True)
    hc, wc = feats.shape[1:3]
    # gather: the top-left tap, zero outside the map, summed over channels
    f = feats.float().numpy()
    want_g = up[..., 0].float().numpy().copy()
    for bi, ri, ci in zip(b.tolist(), r.tolist(), c.tolist()):
        y0 = int(np.floor((ri + 0.5) / sf - 0.5))
        x0 = int(np.floor((ci + 0.5) / sf - 0.5))
        tap = f[bi, y0, x0] if 0 <= y0 < hc and 0 <= x0 < wc else np.zeros(f.shape[-1])
        want_g[bi, ri, ci] = float(torch.tensor(tap.sum(dtype=np.float32)).to(torch.bfloat16))
    got_g = rp.refine_gather(up, thr, feats, coarse, None)
    np.testing.assert_array_equal(got_g[..., 0].float().numpy(), want_g)
    # interp: the sampled feature of refine_reference's own sampler
    x, _ = prr.sample_points(feats, coarse, b, r, c, h2, w2)
    got_i = rp.refine_interp(up, thr, feats, coarse, None)[..., 0]
    np.testing.assert_array_equal(got_i[b, r, c].float().numpy(),
                                  x.float().sum(-1).to(torch.bfloat16).float().numpy())
    # skipped pixels copy through; image 1 (thr = inf) refines everywhere
    for got in (got_g[..., 0], got_i):
        assert torch.equal(got[~mask], up[..., 0][~mask])
    assert mask[1].all() and not mask[0].all()


def test_wrappers_never_fall_back(monkeypatch):
    up, thr, feats, coarse = _step(0)
    x = up[..., 0]
    with pytest.raises(ValueError, match="no kernel for device"):
        rp.tile_copy(x.to("meta"))
    with pytest.raises(ValueError, match="no kernel for device"):
        rp.refine_gather(up.to("meta"), thr, feats, coarse, None)
    # as on a CUDA tensor without a card: the wrappers raise
    monkeypatch.setattr(rp, "_device", lambda name, t: "cuda")
    for call in (lambda: rp.tile_copy(x), lambda: rp.gated_tile_copy(x, thr),
                 lambda: rp.refine_interp(up, thr, feats, coarse, None)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    with pytest.raises(ValueError, match="phase"):
        rp.refine_phase_reference("full", up, thr, feats, coarse)
