"""I-frame and P-frame codecs of the PyTorch port against the JAX package,
bit-identical under the integer-exact transform on a 64x48 frame at block
size 8 (per-row QPs differ, to exercise every row's quantizer)."""

import jax.numpy as jnp
import numpy as np
import torch

from basic_video_codec_tpu.models import pframe as JP
from basic_video_codec_tpu.ops import intra as JI
from basic_video_codec_tpu.tools import ygen
from basic_video_codec_tpu_torch.models import pframe as P
from basic_video_codec_tpu_torch.ops import intra as I

BS, QP0 = 8, 4
_TBL = (jnp.zeros(1, jnp.int32), jnp.zeros(1, jnp.float32))


def _frames():
    seq = ygen.moving_sequence(64, 48, 3, seed=5)
    rng = np.random.default_rng(1)
    noisy = np.clip(seq.astype(np.int32)
                    + rng.integers(-6, 7, size=seq.shape), 0, 255)
    row_qps = rng.integers(0, 11, size=48 // BS).astype(np.int32)
    return noisy.astype(np.uint8), row_qps


def _same(ours, ref):
    for k, (a, b) in enumerate(zip(ours, ref)):
        if b is None:
            assert a is None
            continue
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b), k


def test_intra_encode_decode_bit_identical():
    exact = True
    frames, row_qps = _frames()
    ours = I.intra_encode_frame(torch.from_numpy(frames[0]),
                                torch.from_numpy(row_qps), QP0, BS, exact)
    ref = JI.intra_encode_frame(jnp.asarray(frames[0]), jnp.asarray(row_qps),
                                jnp.float32(0), *_TBL, jnp.int32(QP0), BS,
                                False, exact=exact)
    _same(ours, ref)
    nb = (48 // BS) * (64 // BS)
    modes = ours[4][:nb].reshape(48 // BS, 64 // BS)
    assert 0 < int(modes.sum()) < nb  # both predictors occur
    dec = I.intra_decode_frame(ours[3], modes, torch.from_numpy(row_qps), BS,
                               exact)
    _same(dec, JI.intra_decode_frame(jnp.asarray(ours[3].numpy()),
                                     jnp.asarray(modes.numpy()),
                                     jnp.asarray(row_qps), BS, exact=exact))
    assert torch.equal(dec[0], ours[0])  # decode == recon


def test_pframe_encode_decode_bit_identical():
    exact = True
    frames, row_qps = _frames()
    ref = frames[1]
    ours = P.pframe_encode(torch.from_numpy(frames[2]), torch.from_numpy(ref),
                           torch.from_numpy(row_qps), QP0, BS, 2, exact)
    jref = JP.pframe_encode(jnp.asarray(frames[2]), (jnp.asarray(ref),), (),
                            jnp.asarray(row_qps), jnp.float32(0), *_TBL,
                            jnp.int32(QP0), BS, 2, False, False, False, False,
                            exact=exact)
    _same(ours, jref)
    nb = (48 // BS) * (64 // BS)
    mvs = ours[4][: 3 * nb].reshape(48 // BS, 64 // BS, 3)
    assert mvs[..., :2].abs().sum() > 0  # real motion was found
    dec = P.pframe_decode(ours[3], mvs, torch.from_numpy(row_qps),
                          torch.from_numpy(ref), BS, exact)
    _same(dec, JP.pframe_decode(jnp.asarray(ours[3].numpy()),
                                jnp.asarray(mvs.numpy()), jnp.asarray(row_qps),
                                (jnp.asarray(ref),), (), BS, False,
                                exact=exact))
    assert torch.equal(dec[0], ours[0])  # decode == recon


def test_wrap_int8_bits_matches():
    x = np.array([-300.7, -129.5, -1.2, -0.5, 0.0, 0.9, 127.9, 255.5, 300.2],
                 np.float32)
    assert np.array_equal(P._wrap_int8_bits(torch.from_numpy(x)).numpy(),
                          np.asarray(JP._wrap_int8_bits(jnp.asarray(x))))
