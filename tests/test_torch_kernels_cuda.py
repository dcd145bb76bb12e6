"""The PyTorch port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA card and skip without one.  This file imports
neither JAX nor the JAX package, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from basic_video_codec_tpu_torch.ops import full_search_cuda, me


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("bs,r,n_ref,frac,n_valid", [
    (8, 2, 1, False, None), (16, 4, 1, False, None), (16, 4, 4, True, 2),
    (8, 1, 3, False, 3), (8, 110, 1, False, None)])
def test_full_search_kernel_matches_plain(card, bs, r, n_ref, frac, n_valid):
    """Bit-identical MVs, SADs and predictions at CIF, including the largest
    window the packed key allows (dynamic shared memory above 48 KB)."""
    rng = np.random.default_rng(bs + r + n_ref)
    H, W = 288, 352
    base = rng.integers(0, 256, size=(H, W), dtype=np.uint8)
    refs = np.stack([np.roll(base, (k + 1, -k), (0, 1)) for k in range(n_ref)])
    curr = torch.from_numpy(np.roll(base, (2, 1), (0, 1))).to(card)
    refs = torch.from_numpy(refs).to(card)
    hps = (torch.from_numpy(rng.integers(0, 256, size=(n_ref, 2 * H, 2 * W),
                                         dtype=np.uint8)).to(card)
           if frac else None)
    before = full_search_cuda.LAUNCHES["full_search"]
    got = full_search_cuda.full_search(curr, refs, hps, bs, r, frac, n_valid)
    torch.cuda.synchronize()
    assert full_search_cuda.LAUNCHES["full_search"] == before + 1
    want = me.full_search(curr, refs, hps, bs, r, frac, n_valid)
    for a, b, name in zip(got, want, ("mvs", "sads", "preds")):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_full_search_kernel_rejects_bad_input(card):
    curr = torch.zeros((32, 32), dtype=torch.uint8, device=card)
    with pytest.raises(ValueError):
        full_search_cuda.full_search(curr.t(), curr[None], None, 8, 2, False)
