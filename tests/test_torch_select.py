"""ROADMAP fault C4: the JAX package's packed top-k
(``empanada_tpu/models/point_rend.py:55``, taken for bf16 maps of a
multiple of 65536 pixels) assumes non-positive uncertainties.  The port's
``get_uncertain_point_coords_on_grid`` carries no such precondition: on a
positive bf16 map it selects what a full sort selects, where the JAX fast
path selects other points."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread  # noqa: F401
from empanada_tpu.models.point_rend import (
    get_uncertain_point_coords_on_grid as jax_uncertain_points,
)
from empanada_tpu_torch.models.point_rend import get_uncertain_point_coords_on_grid


@pytest.mark.parametrize("k", [1024, 8192])
def test_c4_positive_bf16_map_selects_the_top_k(k):
    rng = np.random.default_rng(k)
    u = torch.from_numpy(rng.uniform(0.01, 4.0, (2, 256, 256, 1)).astype(np.float32))
    u = u.to(torch.bfloat16)
    values = u.float().numpy().reshape(2, -1)
    idx, coords = get_uncertain_point_coords_on_grid(u, k)
    jidx, _ = jax_uncertain_points(jnp.asarray(u.float().numpy(), jnp.bfloat16), k)
    jidx = np.asarray(jidx)
    assert idx.shape == (2, k) and coords.shape == (2, k, 2)
    for b in range(2):
        top = np.sort(values[b])[-k:]  # the full sort's K largest, ties as values
        np.testing.assert_array_equal(np.sort(values[b][idx[b].numpy()]), top)
        assert len(np.unique(idx[b].numpy())) == k
        # the JAX fast path (its fault C4) picks other points on this map
        assert not np.array_equal(np.sort(values[b][jidx[b]]), top)
