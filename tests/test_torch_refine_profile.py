"""Plain versions of the refine profiling kernels
(``empanada_tpu_torch/ops/refine_profile.py``) against the functions they
stand for: the tile copy and the gated tile copy against the TPU kernels'
``k_copy`` / ``k_when`` semantics written in ``jnp`` (per 16 x 128 tile
here, the port's tiling), and the refine cuts against the port's
``sample_points`` (held to JAX by tests/test_torch_refine.py) and a numpy
top-left tap.  The CUDA kernels themselves run only on the card
(chip_smoke.py phase "refine profile"); here the wrappers must take the
plain version on CPU tensors and refuse to fall back otherwise.  The gated
copy's persistent grid is planned in Python (``gated_plan``, the rule its
launcher follows): the plan must cover every tile exactly once and,
walked as the kernel walks it, give ``gated_tile_copy_reference``."""

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


@pytest.mark.parametrize("shape", [(2, 32, 256), (3, 40, 300), (2, 1, 300), (2, 40, 1)],
                         ids=["tiles", "ragged", "one-row", "one-column"])
def test_copy_and_gated_copy(shape):
    rng = np.random.default_rng(0)
    s = rng.normal(0, 1, shape).astype(np.float32)
    s[0] += 3.0 * np.sign(s[0])  # image 0: |s| >= 3 except where the gate fires
    s[0, 20 % shape[1], 200 % shape[2]] = 0.01
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


# (blocks a SM, SMs): H100 with the refine kernel's reservation, H100
# without it, and a grid of fewer blocks than tile groups
OCCUPANCY = {"reserved": (2, 132), "unreserved": (8, 132), "short-grid": (1, 2)}
PLAN_SHAPES = {"mitonet": (512, 512), "ragged": (40, 300), "ragged-odd": (33, 701),
               "one-row": (1, 129), "one-column": (300, 1)}


@pytest.mark.parametrize("occupancy", list(OCCUPANCY), ids=list(OCCUPANCY))
@pytest.mark.parametrize("hw", list(PLAN_SHAPES.values()), ids=list(PLAN_SHAPES))
@pytest.mark.parametrize("n", [1, 8])
def test_gated_plan_covers_every_tile_once(n, hw, occupancy):
    h, w = hw
    per_sm, sms = OCCUPANCY[occupancy]
    grid, blocks = rp.gated_plan(n, h, w, per_sm, sms)
    k = rp.GATED_TILES
    tiles = n * -(-h // 16) * -(-w // 128)
    groups = -(-tiles // k)
    assert grid == len(blocks) == min(groups, per_sm * sms)
    assert sorted(q for b in blocks for q in b) == list(range(tiles))
    # every pixel of every image lies in exactly one tile of the plan
    seen = np.zeros((n, h, w), np.int32)
    for q in (q for b in blocks for q in b):
        image, r0, c0 = rp.tile_origin(q, h, w)
        assert 0 <= image < n and 0 <= r0 < h and 0 <= c0 < w
        seen[image, r0:r0 + 16, c0:c0 + 128] += 1
    assert (seen == 1).all()
    # block b takes groups b, b + grid, ... of k consecutive tiles: one
    # group a block (one wave) when the groups fit on the card at once
    for b, qs in enumerate(blocks):
        assert qs == sorted(qs)
        assert sorted({q // k for q in qs}) == list(range(b, groups, grid))
    if groups <= per_sm * sms:
        assert all(len(qs) <= k for qs in blocks)
    if occupancy == "short-grid" and groups > 2:
        assert grid < groups


@pytest.mark.parametrize("sms", [1, 2, 3, 7])
def test_gated_plan_walk_is_the_gated_copy(sms):
    """The kernel's walk, in numpy: each block takes its groups in turn,
    gates each tile of a group on its image's threshold and doubles it."""
    rng = np.random.default_rng(sms)
    n, h, w = 3, 40, 300  # 27 tiles, 7 groups of 4
    s = rng.normal(0, 1, (n, h, w)).astype(np.float32)
    s[0] += 3.0 * np.sign(s[0])
    s[0, 33, 290] = 0.01
    thr = np.array([0.5, 0.05, -1.0], np.float32)
    x = _bf16(s)
    want = rp.gated_tile_copy_reference(x, torch.from_numpy(thr)).float().numpy()
    got = x.float().numpy().copy()
    grid, blocks = rp.gated_plan(n, h, w, 1, sms)
    assert grid == sms
    if sms < 7:  # blocks walk several groups
        assert max(len(b) for b in blocks) > rp.GATED_TILES
    for qs in blocks:
        for q in qs:
            image, r0, c0 = rp.tile_origin(q, h, w)
            tile = got[image, r0:r0 + 16, c0:c0 + 128]
            if (np.abs(tile) <= thr[image]).any():
                tile *= 2
    np.testing.assert_array_equal(got, want)


def test_gated_plan_refuses_no_room():
    with pytest.raises(ValueError, match="no block fits"):
        rp.gated_plan(8, 512, 512, 0, 132)
    with pytest.raises(ValueError, match="no block fits"):
        rp.gated_plan(8, 512, 512, 2, 0)


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
