"""Device bit pricing of the PyTorch port against the JAX package:
exp-Golomb lengths and RLE block costs are bit-identical."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basic_video_codec_tpu.ops import bitlen as JB
from basic_video_codec_tpu_torch.ops import bitlen as B


def test_golomb_len_identical():
    v = np.arange(-70000, 70000, 7, dtype=np.int32)
    ours = B.golomb_len(torch.from_numpy(v)).numpy()
    assert ours.dtype == np.int32
    assert np.array_equal(ours, np.asarray(JB.golomb_len(jnp.asarray(v))))


def _quantized_blocks(bs, seed):
    """Sparse quantized blocks with the hard cases: all-zero blocks, a
    non-zero last coefficient, long zero runs and dense blocks."""
    rng = np.random.default_rng(seed)
    q = rng.integers(-40, 41, size=(7, 9, bs, bs)).astype(np.int16)
    q[rng.random(q.shape) < 0.8] = 0
    q[0, 0] = 0                      # all-zero block
    q[0, 1] = 0
    q[0, 1, -1, -1] = 5              # only the last coefficient
    q[0, 2] = 0
    q[0, 2, 0, 0] = -3               # one DC then a run to the end
    q[0, 3] = rng.integers(1, 300, size=(bs, bs))  # dense, large values
    return q


@pytest.mark.parametrize("bs", [8, 16])
def test_rle_block_bits_identical(bs):
    q = _quantized_blocks(bs, seed=bs)
    flat = q.reshape(7, 9, bs * bs)
    zz = B.zigzag_rows(torch.from_numpy(flat), bs)
    zz_ref = JB.zigzag_rows(jnp.asarray(flat), bs)
    assert np.array_equal(zz.numpy(), np.asarray(zz_ref))
    ours = B.rle_block_bits(zz).numpy()
    assert ours.dtype == np.int32
    assert np.array_equal(ours, np.asarray(JB.rle_block_bits(zz_ref)))


def test_intra_mode_bits_identical():
    m = np.array([[0, 1, 1], [1, 0, 0]], np.int32)
    assert np.array_equal(B.intra_mode_bits(torch.from_numpy(m)).numpy(),
                          np.asarray(JB.intra_mode_bits(jnp.asarray(m))))
