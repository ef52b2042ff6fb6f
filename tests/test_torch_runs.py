"""Run-length packing of the 3D path: the port's ``encode_runs_packed``
against the JAX package's, byte for byte, and the port's
``decode_runs_packed`` round trip against ``extract_runs``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from empanada_tpu.ops.postprocess import encode_runs_packed as jax_encode
from empanada_tpu_torch.core import native
from empanada_tpu_torch.core.labeling import decode_runs_packed, extract_runs
from empanada_tpu_torch.ops.postprocess import encode_runs_packed


def _maps(seed):
    """Seeded (B, H, W) panoptic maps with stuff, instances, ids above
    32767, a row of alternating ids (row overflow at small R) and the
    full width of one id."""
    rng = np.random.default_rng(seed)
    pan = np.zeros((3, 24, 40), np.int32)
    pan[0, 2:10, 3:17] = 1001
    pan[0, 4:8, 20:33] = 1002
    pan[0, 12:20, 1:39] = 1
    pan[1] = rng.integers(0, 3, (24, 40)) * 1001
    pan[2, 1, 2:9] = 40001
    pan[2, 2, :] = 65535
    pan[2, 3] = np.tile([0, 33000], 20)
    pan[2, 5:9, 10:30] = rng.integers(32760, 32780, (4, 20))
    return pan


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("max_runs", [1, 8, 20, 40])
def test_encode_byte_identical(seed, max_runs):
    pan = _maps(seed)
    want = np.asarray(jax_encode(jnp.asarray(pan), max_runs))
    got = encode_runs_packed(torch.from_numpy(pan), max_runs)
    assert got.dtype == torch.int16 and want.dtype == np.int16
    assert got.numpy().tobytes() == want.tobytes()


def test_encode_width_one_rows():
    pan = np.array([[[0], [7], [7], [65535]]], np.int32)  # (1, 4, 1)
    want = np.asarray(jax_encode(jnp.asarray(pan), 1))
    got = encode_runs_packed(torch.from_numpy(pan), 1).numpy()
    assert got.tobytes() == want.tobytes()
    vals, rows, cs, ce = decode_runs_packed(got[0], width=1)
    np.testing.assert_array_equal(rows, [1, 2, 3])
    np.testing.assert_array_equal(vals, [7, 7, 65535])
    np.testing.assert_array_equal(ce - cs, [1, 1, 1])


@pytest.mark.parametrize("use_native", [True, False])
def test_decode_round_trip(monkeypatch, use_native):
    """Decoded runs equal the runs of the dense map (native and numpy
    ``extract_runs``); a slice with an overflowed row decodes to None."""
    monkeypatch.setattr(native, "use_native", use_native)
    pan = _maps(3)
    packed = encode_runs_packed(torch.from_numpy(pan), 20).numpy()
    for b in range(len(pan)):
        decoded = decode_runs_packed(packed[b], width=pan.shape[-1])
        if packed[b][:, -1].max() > 20:
            assert decoded is None
            continue
        for got, want in zip(decoded, extract_runs(pan[b])):
            np.testing.assert_array_equal(got, want)
    assert decode_runs_packed(packed[1], width=40) is None  # 24 x 40 random ids


def test_packed_build_flat_overflow_flag():
    pan = np.tile(np.array([0, 1001], np.int32), 32)[None, None, :]  # 64 runs
    packed = encode_runs_packed(torch.from_numpy(pan), 8).numpy()
    assert native.packed_build_flat(packed[0], 64, 1000, 2000, True) == "overflow"
