"""I-frame encode/decode as a wavefront over block anti-diagonals (port of
the fixed-QP branch of ``basic_video_codec_tpu/ops/intra.py``).

Block (r, c) predicts from the reconstructed right column of (r, c-1) and
bottom row of (r-1, c), and both lie on anti-diagonal r+c-1.  So a Python
loop over the nbr+nbc-1 diagonals encodes each diagonal's blocks as one
batch, one lane per block row: lane l's left predictor is its own previous
right column, its top predictor lane l-1's previous bottom row.

Quirks kept from the JAX package: transposed predictors (``H[a,b] =
left[b]``, ``V[a,b] = top[a]``), the mode decision on ``(curr - pred) & 255``
at interior blocks and plain ``|curr - 128|`` at borders, and
``sad_h < sad_v`` choosing H.
"""

import torch

from . import bitlen
from . import transform as T


def _skew(a: torch.Tensor, nbr: int, nbc: int) -> torch.Tensor:
    """Blocks ``[nbr, nbc, ...]`` -> diagonals ``[nbr+nbc-1, nbr, ...]`` with
    ``out[l+c, l] = a[l, c]`` (pad + reshape); other positions are zeros."""
    ndiag = nbr + nbc - 1
    f = a.shape[2:]
    pad = torch.zeros((nbr, nbr) + f, dtype=a.dtype, device=a.device)
    flat = torch.cat([a, pad], dim=1).reshape((nbr * (nbc + nbr),) + f)
    return flat[: nbr * ndiag].reshape((nbr, ndiag) + f).movedim(0, 1)


def _unskew(s: torch.Tensor, nbr: int, nbc: int) -> torch.Tensor:
    """Inverse of :func:`_skew`: ``out[l, c] = s[l+c, l]``."""
    f = s.shape[2:]
    flat = s.movedim(0, 1).reshape((nbr * (nbr + nbc - 1),) + f)
    pad = torch.zeros((nbr,) + f, dtype=s.dtype, device=s.device)
    return torch.cat([flat, pad]).reshape((nbr, nbc + nbr) + f)[:, :nbc]


def blocks_to_plane(blocks: torch.Tensor) -> torch.Tensor:
    """``[nbr, nbc, bs, bs]`` -> ``[H, W]``."""
    nbr, nbc, bs, _ = blocks.shape
    return blocks.transpose(1, 2).reshape(nbr * bs, nbc * bs)


def _predictors(right_cols, bottom_rows, c, lanes, bs):
    """Transposed H/V predictors of one diagonal's lanes, 128 at borders."""
    nbr = right_cols.shape[0]
    pred_h = right_cols[:, None, :].expand(nbr, bs, bs)
    top = torch.roll(bottom_rows, 1, dims=0)  # lane l-1's block
    pred_v = top[:, :, None].expand(nbr, bs, bs)
    pred_h = torch.where((c > 0)[:, None, None], pred_h, 128)
    pred_v = torch.where((lanes > 0)[:, None, None], pred_v, 128)
    return pred_h, pred_v


def _update(right_cols, bottom_rows, recon_b, active, bs):
    am = active[:, None]
    return (torch.where(am, recon_b[:, :, bs - 1], right_cols),
            torch.where(am, recon_b[:, bs - 1, :], bottom_rows))


def intra_encode_frame(curr: torch.Tensor, row_qps: torch.Tensor,
                       initial_qp: int, bs: int, exact: bool = False):
    """Fixed-QP intra encode of a uint8 ``[H, W]`` frame with int32 ``[nbr]``
    row QPs.  Returns ``(recon_u8 [H, W], None, art_u8 [H, W] residual-wrap
    plane, qdct_i16 [H, W], smalls_i32)`` — smalls pack (modes, mae_sums,
    row_qps, row_bits)."""
    h, w = curr.shape
    nbr, nbc = h // bs, w // bs
    ndiag = nbr + nbc - 1
    dev = curr.device
    Qr = T.quant_table(bs, dev)[row_qps.long()]            # [nbr, bs, bs]
    blocks = curr.to(torch.int32).reshape(nbr, bs, nbc, bs).transpose(1, 2)
    cdiag = _skew(blocks, nbr, nbc)                        # [ndiag, nbr, bs, bs]
    lanes = torch.arange(nbr, dtype=torch.int32, device=dev)
    cols = torch.arange(ndiag, dtype=torch.int32, device=dev)[:, None] - lanes
    right_cols = torch.zeros((nbr, bs), dtype=torch.int32, device=dev)
    bottom_rows = torch.zeros((nbr, bs), dtype=torch.int32, device=dev)
    outs = []
    for d in range(ndiag):
        c, cblk = cols[d], cdiag[d]
        pred_h, pred_v = _predictors(right_cols, bottom_rows, c, lanes, bs)
        sad_border = (cblk - 128).abs().sum(dim=(1, 2), dtype=torch.int32)
        sad_h = torch.where(
            c > 0, ((cblk - pred_h) & 255).sum(dim=(1, 2), dtype=torch.int32),
            sad_border)
        sad_v = torch.where(
            lanes > 0, ((cblk - pred_v) & 255).sum(dim=(1, 2), dtype=torch.int32),
            sad_border)
        mode = (sad_h >= sad_v).to(torch.int32)   # H (0) iff sad_h < sad_v
        is_h = (mode == 0)[:, None, None]
        pred = torch.where(is_h, pred_h, pred_v)
        mae = torch.where(mode == 0, sad_h, sad_v)
        q = T.quantize(T.forward_coeffs(cblk - pred, bs, exact), Qr)
        recon_blk, _ = T.reconstruct_mode(q, Qr, pred, bs, exact)
        recon_b = recon_blk.to(torch.int32)
        right_cols, bottom_rows = _update(right_cols, bottom_rows, recon_b,
                                          (c >= 0) & (c < nbc), bs)
        res_u8 = ((cblk - pred) & 255).to(torch.uint8)
        outs.append((q.to(torch.int16), mode, mae, res_u8, recon_b))
    qrows, modes, maes, res, recon = (
        _unskew(torch.stack(x), nbr, nbc) for x in zip(*outs))
    zz_rows = bitlen.zigzag_rows(qrows.reshape(nbr, nbc, bs * bs), bs)
    row_bits = (bitlen.rle_block_bits(zz_rows).sum(dim=1, dtype=torch.int32)
                + bitlen.golomb_len(row_qps - initial_qp)
                + bitlen.intra_mode_bits(modes).sum(dim=1, dtype=torch.int32))
    smalls = torch.cat([modes.reshape(-1), maes.reshape(-1),
                        row_qps.to(torch.int32), row_bits.to(torch.int32)])
    return (blocks_to_plane(recon).to(torch.uint8), None,
            blocks_to_plane(res), blocks_to_plane(qrows), smalls)


def intra_decode_frame(qdct: torch.Tensor, modes: torch.Tensor,
                       row_qps: torch.Tensor, bs: int, exact: bool = False):
    """Decoder-side intra reconstruction: the encoder's wavefront with the
    predictor chosen by the decoded mode.  Returns ``(decoded_u8, None)``."""
    h, w = qdct.shape
    nbr, nbc = h // bs, w // bs
    ndiag = nbr + nbc - 1
    dev = qdct.device
    Qr = T.quant_table(bs, dev)[row_qps.long()]
    qblocks = qdct.to(torch.int32).reshape(nbr, bs, nbc, bs).transpose(1, 2)
    qdiag = _skew(qblocks, nbr, nbc)
    mdiag = _skew(modes.to(torch.int32), nbr, nbc)
    lanes = torch.arange(nbr, dtype=torch.int32, device=dev)
    cols = torch.arange(ndiag, dtype=torch.int32, device=dev)[:, None] - lanes
    right_cols = torch.zeros((nbr, bs), dtype=torch.int32, device=dev)
    bottom_rows = torch.zeros((nbr, bs), dtype=torch.int32, device=dev)
    outs = []
    for d in range(ndiag):
        c = cols[d]
        pred_h, pred_v = _predictors(right_cols, bottom_rows, c, lanes, bs)
        pred = torch.where((mdiag[d] == 0)[:, None, None], pred_h, pred_v)
        blk, _ = T.reconstruct_mode(qdiag[d], Qr, pred, bs, exact)
        recon_b = blk.to(torch.int32)
        right_cols, bottom_rows = _update(right_cols, bottom_rows, recon_b,
                                          (c >= 0) & (c < nbc), bs)
        outs.append(recon_b)
    recon = _unskew(torch.stack(outs), nbr, nbc)
    return blocks_to_plane(recon).to(torch.uint8), None
