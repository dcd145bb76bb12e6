"""Transform stack of the PyTorch port against the JAX package: the tables
are identical, the float DCT agrees to float32 summation error, and the
integer-exact mode is bit-identical."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basic_video_codec_tpu.ops import transform as JT
from basic_video_codec_tpu_torch.ops import transform as T


@pytest.mark.parametrize("bs", [4, 8, 16])
def test_tables_identical(bs):
    for name in ("dct_matrix", "dct_matrix_int", "quant_matrices"):
        a, b = getattr(T, name)(bs), getattr(JT, name)(bs)
        assert a.dtype == b.dtype and np.array_equal(a, b), name


def _blocks(bs, seed, lo=-255, hi=256):
    rng = np.random.default_rng(seed)
    return rng.integers(lo, hi, size=(6, 5, bs, bs)).astype(np.int32)


@pytest.mark.parametrize("bs", [8, 16])
def test_float_dct_within_summation_error(bs):
    """Both sides are float32 products of the same matrices, summed in
    different orders: forward and inverse agree to 4 ULP of the largest
    coefficient (1-2 ULP measured; at 16x16 that is above 1e-4 absolute)."""
    x = _blocks(bs, seed=bs)
    d = torch.from_numpy(T.dct_matrix(bs))
    ref = np.asarray(JT.dct2(jnp.asarray(x), jnp.asarray(T.dct_matrix(bs))))
    ours = T.dct2(torch.from_numpy(x), d).numpy()
    tol = 4 * np.spacing(np.abs(ref).max())
    assert np.abs(ours - ref).max() <= tol
    back = T.idct2(torch.from_numpy(ref.copy()), d).numpy()
    ref_back = np.asarray(JT.idct2(jnp.asarray(ref),
                                   jnp.asarray(T.dct_matrix(bs))))
    assert np.abs(back - ref_back).max() <= tol


@pytest.mark.parametrize("bs", [8, 16])
def test_exact_transform_bit_identical(bs):
    x = _blocks(bs, seed=3 * bs)
    d_int = JT.dct_matrix_int(bs)
    d64 = torch.from_numpy(d_int).to(torch.float64)
    fwd = T.dct2_exact(torch.from_numpy(x), d64).numpy()
    assert np.array_equal(fwd, np.asarray(JT.dct2_exact(jnp.asarray(x),
                                                        jnp.asarray(d_int))))
    qm = T.quant_matrices(bs)
    for qp in (0, 3, 7):
        q = T.quantize(torch.from_numpy(fwd), torch.from_numpy(qm[qp])).numpy()
        q_ref = np.asarray(JT.quantize(jnp.asarray(fwd), jnp.asarray(qm[qp])))
        assert np.array_equal(q, q_ref)
        rescaled = (q.astype(np.int32) * qm[qp].astype(np.int32))
        core = T.idct2_exact_core(torch.from_numpy(rescaled), d64).numpy()
        assert np.array_equal(core, np.asarray(JT.idct2_exact_core(
            jnp.asarray(rescaled), jnp.asarray(d_int))))
        pred = _blocks(bs, seed=qp, lo=0)
        ours = T.reconstruct_mode(torch.from_numpy(q), torch.from_numpy(qm[qp]),
                                  torch.from_numpy(pred), bs, True)
        ref = JT.reconstruct_mode(jnp.asarray(q), jnp.asarray(qm[qp]),
                                  jnp.asarray(pred), bs, True)
        for a, b in zip(ours, ref):
            assert np.array_equal(a.numpy(), np.asarray(b))


def test_exact_core_wraps_like_int32():
    """Inputs whose second-stage partial sums leave int32: the float64 route
    must reproduce the JAX package's two's-complement result."""
    bs = 8
    d_int = JT.dct_matrix_int(bs)
    y = np.full((2, bs, bs), 8000, np.int32)
    y[1, ::2] = -8000
    ours = T.idct2_exact_core(torch.from_numpy(y),
                              torch.from_numpy(d_int).to(torch.float64)).numpy()
    assert np.array_equal(ours, np.asarray(JT.idct2_exact_core(
        jnp.asarray(y), jnp.asarray(d_int))))
