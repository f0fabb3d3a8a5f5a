"""The port's RNG lattice is bit-equal to pathtrace_tpu.rng.

torch has no uint32 arithmetic and ``>>`` on int32 is an arithmetic shift,
so a naive port of the mixer agrees on a small share of inputs; the port
works in int64 masked to 32 bits. Every check here is exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtrace_tpu import rng as jrng
from pathtrace_tpu_torch import rng


def test_mix32_bit_equal_on_random_int32():
    x = np.random.default_rng(0).integers(-2**31, 2**31, 100_000, dtype=np.int64)
    x = np.concatenate([x, [0, 1, -1, 2**31 - 1, -2**31]]).astype(np.int32)
    ref = np.asarray(jrng.mix32(jnp.asarray(x)))
    got = rng.mix32(torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("seed,frame", [(0, 0), (7, 3), (2**31 - 1, -5), (-12345, 2**30)])
def test_base_key_bit_equal(seed, frame):
    assert int(rng.base_key(seed, frame)) == int(jrng.base_key(seed, frame))


def test_pixel_keys_bit_equal_with_offsets():
    ref = np.asarray(jrng.pixel_keys(9, 13, 40, 7))
    np.testing.assert_array_equal(rng.pixel_keys(9, 13, 40, 7).numpy(), ref)


def test_draw_key_bit_equal():
    bkey = jrng.base_key(11, 2)
    for s, slot, n in [(0, 0, 12), (5, 3, 12), (1000, 26, 27), (2**20, 1, 27)]:
        assert int(rng.draw_key(int(bkey), s, slot, n)) == int(jrng.draw_key(bkey, s, slot, n))


@pytest.mark.parametrize("slots_per_bounce", [2, 5])
def test_sample_uniforms_bit_equal(slots_per_bounce):
    kw = dict(sample_offset=3, row_offset=16, col_offset=5, slots_per_bounce=slots_per_bounce)
    ref = np.asarray(jrng.sample_uniforms(4, 1, 3, 6, 10, 5, **kw))
    got = rng.sample_uniforms(4, 1, 3, 6, 10, 5, **kw)
    assert got.dtype == torch.float32
    assert got.shape == ref.shape == (3, 6, 10, 2 + slots_per_bounce * 5)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert float(got.min()) >= 0.0 and float(got.max()) < 1.0
