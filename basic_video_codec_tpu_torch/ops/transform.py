"""Transform stack: batched 2D DCT/IDCT + quantize / rescale / reconstruct
over ``[..., bs, bs]`` blocks (port of ``basic_video_codec_tpu/ops/transform.py``).

These are plain batched products, computed with ``torch.matmul``.

Float mode computes ``D @ X @ D.T`` in float32.  The JAX package runs the
same products at ``Precision.HIGHEST``; a float32 product on the card only
matches that when TF32 is off, so this module pins full float32 below.  Sums
still run in another order than XLA's, so a quantized coefficient can differ
by ±1 where ``dct/Q`` lands within float error of a rounding boundary.

Exact mode (``exact_transform``) uses a fixed-point integer basis.  Its
products are computed in float64, where every product and partial sum is an
integer below 2^53 and therefore exact in any summation order, and the
float64 -> int64 -> int32 cast reproduces the JAX package's int32
wrap-around.  The same route runs on the CPU and on the card (CUDA has no
int32 matmul), so exact-mode outputs agree bit for bit across devices.
"""

from functools import lru_cache

import numpy as np
import torch

# Full float32 products everywhere: TF32 keeps ~10 mantissa bits and would
# push the float DCT outside the JAX package's tolerance class.
torch.set_float32_matmul_precision("highest")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@lru_cache(maxsize=None)
def dct_matrix(n: int) -> np.ndarray:
    """Orthonormal DCT-II matrix, computed in float64 and rounded to float32:
    ``D[k, m] = s_k * cos(pi * (2m + 1) * k / (2n))`` with
    ``s_0 = sqrt(1/n)``, ``s_k = sqrt(2/n)``."""
    k = np.arange(n)[:, None].astype(np.float64)
    m = np.arange(n)[None, :].astype(np.float64)
    d = np.cos(np.pi * (2 * m + 1) * k / (2 * n))
    d[0] *= np.sqrt(1.0 / n)
    d[1:] *= np.sqrt(2.0 / n)
    return d.astype(np.float32)


EXACT_SHIFT = 13  # fixed-point scale of the integer DCT basis
IDCT_GUARD = 6  # guard bits kept through the exact-IDCT mid stage


@lru_cache(maxsize=None)
def dct_matrix_int(n: int, shift: int = EXACT_SHIFT) -> np.ndarray:
    """Fixed-point DCT-II basis ``round(D * 2^shift)`` (int32)."""
    k = np.arange(n)[:, None].astype(np.float64)
    m = np.arange(n)[None, :].astype(np.float64)
    d = np.cos(np.pi * (2 * m + 1) * k / (2 * n))
    d[0] *= np.sqrt(1.0 / n)
    d[1:] *= np.sqrt(2.0 / n)
    return np.round(d * (1 << shift)).astype(np.int32)


@lru_cache(maxsize=None)
def quant_matrices(bs: int, max_qp: int | None = None) -> np.ndarray:
    """``[n_qp, bs, bs]`` float32 stack of power-of-two quant matrices:
    2^qp under the anti-diagonal, 2^(qp+1) on it, 2^(qp+2) above."""
    if max_qp is None:
        max_qp = int(np.log2(bs)) + 7
    xy = np.add.outer(np.arange(bs), np.arange(bs))
    exp = np.where(xy < bs - 1, 0, np.where(xy == bs - 1, 1, 2))
    qps = np.arange(max_qp + 1)[:, None, None]
    return (2.0 ** (qps + exp[None])).astype(np.float32)


@lru_cache(maxsize=None)
def _dev(table: str, bs: int, device: torch.device) -> torch.Tensor:
    """A table as a device tensor, uploaded once per (table, bs, device)."""
    if table == "d":
        return torch.from_numpy(dct_matrix(bs)).to(device)
    if table == "d_int":  # exact-mode basis, as float64 for the exact products
        return torch.from_numpy(dct_matrix_int(bs)).to(device, torch.float64)
    if table == "q":
        return torch.from_numpy(quant_matrices(bs)).to(device)
    raise KeyError(table)


def quant_table(bs: int, device) -> torch.Tensor:
    """:func:`quant_matrices` on ``device``."""
    return _dev("q", bs, torch.device(device))


def _to_i32(x64: torch.Tensor) -> torch.Tensor:
    """Integral float64 -> int32 with two's-complement wrap (via int64)."""
    return x64.to(torch.int64).to(torch.int32)


def _rshift_round(x: torch.Tensor, s: int) -> torch.Tensor:
    """Deterministic round-half-up ``x / 2^s`` for signed int32."""
    return (x + (1 << (s - 1))) >> s


def dct2_exact(blocks_i32: torch.Tensor, d_int: torch.Tensor) -> torch.Tensor:
    """Integer-exact 2D DCT with a mid-stage rescale (2 guard bits); returns
    float32 coefficient values.  ``d_int`` is the float64 basis."""
    x = blocks_i32.to(torch.float64)
    t1 = _rshift_round(_to_i32(d_int @ x), EXACT_SHIFT - 2)   # ~t1_true * 4
    y = _to_i32(t1.to(torch.float64) @ d_int.T)               # true <= 2^27
    return y.to(torch.float32) / float(1 << (EXACT_SHIFT + 2))


def idct2_exact_core(rescaled_i32: torch.Tensor, d_int: torch.Tensor) -> torch.Tensor:
    """Integer core of the exact inverse ``D^T Y D``: the residual scaled by
    ``2^EXACT_SHIFT`` as int32.  The mid stage keeps ``IDCT_GUARD``
    fractional bits."""
    y = rescaled_i32.to(torch.float64)
    t1 = _rshift_round(_to_i32(d_int.T @ y), EXACT_SHIFT - IDCT_GUARD)
    x = _to_i32(t1.to(torch.float64) @ d_int)
    return _rshift_round(x, IDCT_GUARD)


def idct2_exact(rescaled_i32: torch.Tensor, d_int: torch.Tensor) -> torch.Tensor:
    """Integer-exact inverse, as float32 residual values."""
    x = idct2_exact_core(rescaled_i32, d_int)
    return x.to(torch.float32) / float(1 << EXACT_SHIFT)


def dct2(blocks: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Batched 2D DCT-II: ``D @ X @ D.T`` over ``[..., bs, bs]``."""
    return (d @ blocks.to(torch.float32)) @ d.T


def idct2(coeffs: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Batched inverse: ``D.T @ Y @ D``."""
    return (d.T @ coeffs.to(torch.float32)) @ d


def quantize(dct_coeffs: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    """``round(dct / Q)``, half to even.  Division by a power of two is
    exact in float32."""
    return torch.round(dct_coeffs / Q)


def rescale(qcoeffs: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    """``q * Q``; magnitudes stay < 2^14, exact in float32."""
    return qcoeffs.to(torch.float32) * Q


def reconstruct(qcoeffs, Q, pred_blocks, d):
    """rescale -> IDCT -> + pred -> round -> clip -> uint8.
    Returns ``(recon uint8, idct_residual float32)``."""
    idct_res = idct2(rescale(qcoeffs, Q), d)
    recon = torch.round(idct_res + pred_blocks.to(torch.float32))
    return torch.clamp(recon, 0, 255).to(torch.uint8), idct_res


def forward_coeffs(residual_blocks: torch.Tensor, bs: int, exact: bool) -> torch.Tensor:
    """Mode dispatch: float32 DCT or integer-exact DCT."""
    dev = residual_blocks.device
    if exact:
        return dct2_exact(residual_blocks.to(torch.int32), _dev("d_int", bs, dev))
    return dct2(residual_blocks, _dev("d", bs, dev))


def reconstruct_mode(qcoeffs, Q, pred_blocks, bs: int, exact: bool):
    """Mode dispatch for rescale -> IDCT -> + pred -> round -> clip."""
    dev = qcoeffs.device
    if exact:
        rescaled = qcoeffs.to(torch.int32) * Q.to(torch.int32)
        idct_res = idct2_exact(rescaled, _dev("d_int", bs, dev))
        recon = torch.round(idct_res + pred_blocks.to(torch.float32))
        return torch.clamp(recon, 0, 255).to(torch.uint8), idct_res
    return reconstruct(qcoeffs, Q, pred_blocks, _dev("d", bs, dev))
