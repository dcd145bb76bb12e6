"""Full-search ME of the PyTorch port against the JAX package: the plain
version (``ops/me.full_search``, the CPU path and the kernel's reference) is
bit-identical to ``basic_video_codec_tpu.ops.me.full_search`` and to the
Pallas kernel in interpret mode.  The CUDA kernel is held against the plain
version on the card by tests/test_torch_kernels_cuda.py."""

import numpy as np
import pytest
import torch

from basic_video_codec_tpu.golden.interp import build_pre_interpolated_buffer
from basic_video_codec_tpu.ops import me as jme
from basic_video_codec_tpu.ops.pallas_me import full_search_pallas
from basic_video_codec_tpu_torch.ops import full_search_cuda, me


def _inputs(W, H, n_ref, seed):
    """A textured-noise frame, references shifted from it, half-pel planes."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, size=(H, W), dtype=np.uint8)
    base = ((base.astype(np.int32) + np.roll(base, 1, 1)) // 2).astype(np.uint8)
    refs = np.stack([np.roll(base, (k + 1, -k), (0, 1)) for k in range(n_ref)])
    curr = np.roll(base, (2, 1), (0, 1))
    hps = np.stack([build_pre_interpolated_buffer(r) for r in refs])
    return curr, refs, hps


def _jax(fn, curr, refs, hps, bs, r, frac, **kw):
    import jax.numpy as jnp

    return [np.asarray(x) for x in
            fn(jnp.asarray(curr), jnp.asarray(refs), jnp.asarray(hps), bs, r,
               frac, **kw)]


def _torch(curr, refs, hps, bs, r, frac, n_valid=None, device="cpu"):
    def t(a):
        return None if a is None else torch.from_numpy(a).to(device)

    out = full_search_cuda.full_search(t(curr), t(refs), t(hps), bs, r, frac,
                                       n_valid=n_valid)
    return [x.cpu().numpy() for x in out]


def _same(a, b):
    for x, y, name in zip(a, b, ("mvs", "sads", "preds")):
        assert x.dtype == y.dtype == np.int32, name
        assert np.array_equal(x, y), name


@pytest.mark.parametrize("frac", [False, True])
@pytest.mark.parametrize("n_ref", [1, 2])
@pytest.mark.parametrize("r", [1, 2])
@pytest.mark.parametrize("bs", [8, 16])
def test_plain_matches_jax_and_pallas(bs, r, n_ref, frac):
    """Half-pel search at r 2 has 81 candidates a reference, which the Pallas
    kernel unrolls: minutes in interpret mode.  Those cases are held against
    the XLA version only, which tests/test_pallas_me.py holds against the
    Pallas kernel at that window."""
    curr, refs, hps = _inputs(48, 32, n_ref, seed=bs + 10 * r + 100 * n_ref)
    ours = _torch(curr, refs, hps, bs, r, frac)
    _same(ours, _jax(jme.full_search, curr, refs, hps, bs, r, frac))
    if not (frac and r == 2):
        _same(ours, _jax(full_search_pallas, curr, refs, hps, bs, r, frac,
                         interpret=True))


@pytest.mark.parametrize("n_valid", [1, 2])
def test_plain_matches_jax_n_valid(n_valid):
    """Rolling-stack masking: slots at or past n_valid never win (the Pallas
    kernel takes no n_valid, so only the XLA version is the reference)."""
    import jax.numpy as jnp

    curr, refs, hps = _inputs(64, 48, 3, seed=7)
    ours = _torch(curr, refs, hps, 8, 2, False, n_valid=n_valid)
    _same(ours, _jax(jme.full_search, curr, refs, hps, 8, 2, False,
                     n_valid=jnp.int32(n_valid)))
    assert (ours[0][..., 2] < n_valid).all()


def test_tie_break_on_constant_frame():
    """Every SAD ties on flat content: the winner follows the L1 tie-break
    (all-zero MVs) identically in all three versions."""
    flat = np.full((32, 48), 77, np.uint8)
    refs, hps = flat[None], build_pre_interpolated_buffer(flat)[None]
    ours = _torch(flat, refs, hps, 8, 2, False)
    _same(ours, _jax(jme.full_search, flat, refs, hps, 8, 2, False))
    _same(ours, _jax(full_search_pallas, flat, refs, hps, 8, 2, False,
                     interpret=True))
    assert (ours[0] == 0).all() and (ours[1] == 0).all()


def test_frame_edge_blocks_keep_in_frame():
    """Content moved towards the edges: edge blocks whose best match lies
    outside the frame must pick an in-frame candidate, as the reference."""
    curr, refs, hps = _inputs(48, 32, 1, seed=3)
    refs = np.roll(curr, (-3, 3), (0, 1))[None]
    ours = _torch(curr, refs, None, 8, 3, False)
    _same(ours, _jax(jme.full_search, curr, refs, hps, 8, 3, False))
    mvx, mvy = ours[0][..., 0], ours[0][..., 1]
    xs = np.arange(6)[None, :] * 8 + mvx
    ys = np.arange(4)[:, None] * 8 + mvy
    assert (xs >= 0).all() and (xs + 8 <= 48).all()
    assert (ys >= 0).all() and (ys + 8 <= 32).all()


def test_candidate_order_matches():
    assert np.array_equal(me.candidate_offsets(3, 2),
                          np.asarray(jme.candidate_offsets(3, 2)))


def test_bad_arguments_raise():
    curr = torch.zeros((16, 16), dtype=torch.uint8)
    with pytest.raises(ValueError):
        full_search_cuda.full_search(curr, curr[None], None, 8, 128, False)
    with pytest.raises(TypeError):
        full_search_cuda.full_search(curr.int(), curr[None].int(), None, 8, 2,
                                     False)
    with pytest.raises(ValueError):
        full_search_cuda.full_search(curr, curr[None], None, 8, 2, True)
    with pytest.raises(ValueError):
        full_search_cuda.full_search(curr, curr[None], None, 8, 2, False,
                                     n_valid=0)
