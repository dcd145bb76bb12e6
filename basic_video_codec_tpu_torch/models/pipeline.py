"""Encode/decode entry points: the full-plane lane of
``basic_video_codec_tpu/models/pipeline.py``.

Encode is a simple loop: one GOP chunk at a time runs on the device
(models/chunk.py), its outputs come back in one device-to-host copy, and
the host entropy-codes and writes the frames in order.  Two invariants are
checked at run time: the device's priced row bits equal the host coder's
bits for every frame, and (in the tests and ``chip_smoke.py``) the decoded
frames equal the encoder's reconstruction.

This slice covers fixed QP (RC off), full-search ME, one reference frame
and integer-pel search; other configurations raise ``NotImplementedError``.
"""

import csv
import time

import numpy as np
import torch

from ..config import InputParameters
from ..entropy import EOB_MARKER
from ..entropy.native import (
    decode_dct_scans,
    decode_symbols_np,
    encode_dct_plane_bytes,
    encode_symbols_bytes,
    format_mv_lines,
    wrap_diff,
)
from ..entropy.zigzag import zigzag_indices
from ..io.fileio import FileIOHelper, overwrite_open, write_y_only_frame
from ..metrics.frame_metrics import FrameMetrics
from ..utils.frame_utils import pad_frame, padded_dims, psnr
from ..utils.logger import get_logger
from .chunk import decode_chunk, encode_chunk

logger = get_logger()

INTER, INTRA = 0, 1
# Frames per device chunk: chunks never cross an I-frame, and a GOP longer
# than this is split, which bounds the device and host memory of a chunk.
MAX_CHUNK = 24


def resolve_device(device) -> torch.device:
    """The torch device to run on; a CUDA device must exist (no fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the codec "
            "on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _check_slice(ec):
    unsupported = [name for name, on in (
        ("rate control (RCflag != 0)", ec.RCflag != 0),
        ("fastME", ec.fastME),
        ("fractional ME", ec.fracMeEnabled),
        ("nRefFrames > 1", ec.nRefFrames != 1),
    ) if on]
    if unsupported:
        raise NotImplementedError(
            "the PyTorch port does not run " + ", ".join(unsupported)
            + " yet; use basic_video_codec_tpu for these configurations")


def _fetch(*tensors):
    """Copy device tensors to the host in ONE transfer (bytes concatenated on
    the device, split on the host); returns numpy arrays."""
    flat = [t.contiguous().view(torch.uint8).reshape(-1) for t in tensors]
    host = torch.cat(flat).cpu().numpy()
    out, pos = [], 0
    for t, f in zip(tensors, flat):
        n = f.numel()
        dt = torch.empty(0, dtype=t.dtype).numpy().dtype
        out.append(host[pos : pos + n].view(dt).reshape(tuple(t.shape)))
        pos += n
    return out


class _Finalized:
    __slots__ = (
        "index", "mode", "recon", "qdct", "res_w_mc", "res_wo_mc", "mv_line",
        "pred_bytes", "pred_bits", "dct_bytes", "dct_bits", "avg_mae",
        "comparisons", "host_dt", "psnr",
    )

    def is_iframe(self):
        return self.mode == INTRA


def _host_entropy(mode, aux, row_qps, qdct, ec, nbr, nbc, bs):
    """Host entropy coder -> ``(pred_bytes, pred_bits, dct_bytes, dct_bits)``."""
    qp_diffs = row_qps.astype(np.int64) - ec.quantization_factor
    if mode == INTRA:
        syms = np.hstack([qp_diffs[:, None], aux.astype(np.int64)]).ravel()
    else:
        flat = aux.reshape(-1, 3).astype(np.int64)
        prev = np.vstack([np.zeros(3, np.int64), flat[:-1]])
        diffs = (flat - prev)[:, :2].reshape(nbr, nbc * 2)
        syms = np.hstack([qp_diffs[:, None], diffs]).ravel()
    pred_bytes, pred_bits = encode_symbols_bytes(syms)
    dct_bytes, dct_bits = encode_dct_plane_bytes(
        qdct, bs, zigzag_indices(bs), EOB_MARKER)
    return pred_bytes, pred_bits, dct_bytes, dct_bits


def _finalize_arrays(index, mode, curr, recon, art, qdct, smalls, ec,
                     prev_recon=None) -> _Finalized:
    """Entropy-pack one frame from its host copies.  Intra smalls =
    (modes, maes, row_qps, row_bits); inter smalls = (mvs, sads, comps,
    row_qps, row_bits).  ``prev_recon`` is the reference of a P-frame."""
    t0 = time.time()
    bs = ec.block_size
    h, w = qdct.shape
    nbr, nbc = h // bs, w // bs
    nb = nbr * nbc
    f = _Finalized()
    f.index, f.mode, f.recon, f.qdct = index, mode, recon, qdct
    f.psnr = psnr(curr, recon)
    f.res_w_mc = art
    if mode == INTRA:
        aux = smalls[:nb].reshape(nbr, nbc)
        metric_sum = smalls[nb : 2 * nb].astype(np.float64).sum()
        f.comparisons = 2 * nb
        row_qps, row_bits = smalls[2 * nb : 2 * nb + nbr], smalls[2 * nb + nbr :]
        f.res_wo_mc = art
        f.mv_line = "\n"
    else:
        aux = smalls[: 3 * nb].reshape(nbr, nbc, 3)
        metric_sum = smalls[3 * nb : 4 * nb].astype(np.float64).sum()
        f.comparisons = int(smalls[4 * nb : 5 * nb].astype(np.int64).sum())
        row_qps, row_bits = smalls[5 * nb : 5 * nb + nbr], smalls[5 * nb + nbr :]
        f.res_wo_mc = wrap_diff(curr, prev_recon)
        f.mv_line = format_mv_lines(aux, bs)
    f.avg_mae = float(metric_sum) / (bs * bs) / nb
    f.pred_bytes, f.pred_bits, f.dct_bytes, f.dct_bits = _host_entropy(
        mode, aux, row_qps, qdct, ec, nbr, nbc, bs)
    priced = int(row_bits.astype(np.int64).sum())
    if f.dct_bits + f.pred_bits != priced:
        raise RuntimeError(
            f"frame {index}: device bit pricing ({priced}) diverged from the "
            f"host entropy coder ({f.dct_bits + f.pred_bits})")
    f.host_dt = time.time() - t0
    return f


class _EncodeSink:
    """Per-run artifact writer: the seven output files, the metrics rows and
    the bitstream framing.  ``write`` is called in frame order."""

    def __init__(self, params: InputParameters):
        from contextlib import ExitStack

        file_io = FileIOHelper(params)
        self._stack = ExitStack()
        en = self._stack.enter_context
        self.mv_fh = en(overwrite_open(file_io.get_mv_file_name(), text=True))
        self.qdct_fh = en(overwrite_open(
            file_io.get_quant_dct_coff_fh_file_name()))
        self.res_w_fh = en(overwrite_open(
            file_io.get_residual_w_mc_file_name()))
        self.res_wo_fh = en(overwrite_open(
            file_io.get_residual_wo_mc_file_name()))
        self.recon_fh = en(overwrite_open(
            file_io.get_mc_reconstructed_file_name()))
        self.encoded_fh = en(overwrite_open(file_io.get_encoded_file_name()))
        metrics_fh = en(overwrite_open(
            file_io.get_metrics_csv_file_name(), text=True, newline=""))
        self.metrics_writer = csv.writer(metrics_fh)
        self.metrics_writer.writerow(FrameMetrics.get_header())
        self.start_time = time.time()

    def write(self, f: _Finalized, dispatch_dt: float):
        encoded_fh = self.encoded_fh
        start_idx = encoded_fh.tell()
        encoded_fh.write(f.mode.to_bytes(1))
        encoded_fh.write(((f.pred_bits + 7) // 8).to_bytes(2))
        encoded_fh.write(f.pred_bytes)
        encoded_fh.write(((f.dct_bits + 7) // 8).to_bytes(3))
        encoded_fh.write(f.dct_bytes)
        frame_bytes = encoded_fh.tell() - start_idx
        self.metrics_writer.writerow(
            FrameMetrics(
                f.index, f.mode, f.avg_mae, f.comparisons, f.psnr,
                frame_bytes, encoded_fh.tell() * 8,
                dispatch_dt + f.host_dt, time.time() - self.start_time,
            ).to_csv_row()
        )
        logger.info(
            f"{f.index:2}: {'INTRA' if f.is_iframe() else 'INTER'} "
            f" mae [{round(f.avg_mae, 2):6.2f}] psnr [{round(f.psnr, 2):6.2f}], "
            f"size: [{frame_bytes:6}]"
        )
        write_y_only_frame(self.res_w_fh, f.res_w_mc)
        write_y_only_frame(self.res_wo_fh, f.res_wo_mc)
        write_y_only_frame(self.qdct_fh, np.asarray(f.qdct, np.int16))
        write_y_only_frame(self.recon_fh, f.recon)
        self.mv_fh.write(f.mv_line)

    def close(self):
        self._stack.close()


def _append_throughput(params, elapsed, results_csv_path):
    """Whole-run throughput line, appended to ``results_csv_path``."""
    ec = params.encoder_config
    num_blocks = (params.height // ec.block_size) * (params.width // ec.block_size)
    num_comparisons = num_blocks * (2 * ec.search_range + 1) ** 2
    n = params.frames_to_process
    result = (
        f"{num_comparisons / elapsed:9.3f} | {num_comparisons:7d} | "
        f"{num_blocks / elapsed:7.3f} |  {num_blocks:5d} | {n / elapsed:6.2f} | "
        f"{n:3d} | {elapsed:6.3f} | {ec.block_size:2d} | {ec.search_range:2d} |\n"
    )
    logger.info(result)
    if results_csv_path:
        with open(results_csv_path, "at") as f:
            f.write(result)


def encode_video(params: InputParameters, results_csv_path: str | None = "results.csv",
                 *, device=None):
    """Encode ``params.y_only_file`` into the artifact tree beside it.

    Runs on ``device`` if given, else on ``params.encoder_config.device``
    (``"cuda"`` by default); raises if that is a CUDA device and none is
    available."""
    ec = params.encoder_config
    _check_slice(ec)
    dev = resolve_device(device if device is not None else ec.device)
    bs = ec.block_size
    y_size = params.width * params.height
    pw, ph = padded_dims(params.width, params.height, bs)
    exact = ec.exact_transform
    row_qps = torch.full((ph // bs,), ec.quantization_factor, dtype=torch.int32,
                         device=dev)
    ref = torch.full((ph, pw), 128, dtype=torch.uint8, device=dev)
    last_recon = None  # host copy of the previous frame's reconstruction

    sink = _EncodeSink(params)
    n_read, truncated = 0, 0
    try:
        with open(params.y_only_file, "rb") as f_in:
            while n_read < params.frames_to_process:
                k = min(MAX_CHUNK, ec.I_Period - n_read % ec.I_Period,
                        params.frames_to_process - n_read)
                raw = f_in.read(y_size * k)
                n, truncated = len(raw) // y_size, len(raw) % y_size
                if n == 0:
                    break
                t0 = time.time()
                frames_np = np.stack([
                    pad_frame(np.frombuffer(
                        raw[i * y_size : (i + 1) * y_size], dtype=np.uint8
                    ).reshape(params.height, params.width), bs)
                    for i in range(n)
                ])
                first_is_intra = n_read % ec.I_Period == 0
                intra_out, p_out, ref = encode_chunk(
                    torch.from_numpy(frames_np).to(dev), ref, row_qps,
                    ec.quantization_factor, bs, max(ec.search_range, 0),
                    first_is_intra, exact)
                fields = _fetch(*(intra_out or ()), *(p_out or ()))
                dispatch_dt = (time.time() - t0) / n
                pos = 0
                if intra_out is not None:
                    recon, art, qdct, smalls = fields[:4]
                    fields = fields[4:]
                    sink.write(_finalize_arrays(
                        n_read + 1, INTRA, frames_np[0], recon, art, qdct,
                        smalls, ec), dispatch_dt)
                    last_recon, pos = recon, 1
                recons, arts, qdcts, smalls = fields or ((),) * 4
                for j in range(len(recons)):
                    sink.write(_finalize_arrays(
                        n_read + pos + j + 1, INTER, frames_np[pos + j],
                        recons[j], arts[j], qdcts[j], smalls[j], ec,
                        prev_recon=last_recon), dispatch_dt)
                    last_recon = recons[j]
                n_read += n
                if truncated:
                    break
    finally:
        sink.close()
    if truncated:
        raise ValueError(f"truncated frame: read {truncated} of {y_size} bytes")
    _append_throughput(params, time.time() - sink.start_time, results_csv_path)


def _parse_prediction(data, ec, params, is_intra):
    """Entropy-decode one frame's prediction payload into planes."""
    bs = ec.block_size
    pw, ph = padded_dims(params.width, params.height, bs)
    nbc, nbr = pw // bs, ph // bs
    per_row = 1 + nbc * (1 if is_intra else 2)
    syms = decode_symbols_np(data, nbr * per_row).reshape(nbr, per_row)
    row_qps = (ec.quantization_factor + syms[:, 0]).astype(np.int32)
    if is_intra:
        return row_qps, syms[:, 1:].astype(np.int32), None
    diffs = syms[:, 1:].reshape(-1, 2)
    diffs = np.hstack([diffs, np.zeros((diffs.shape[0], 1), np.int64)])
    mvs = np.cumsum(diffs, axis=0).reshape(nbr, nbc, 3).astype(np.int32)
    return row_qps, None, mvs


def _parse_dct(data, ec, params):
    bs = ec.block_size
    pw, ph = padded_dims(params.width, params.height, bs)
    nbc, nbr = pw // bs, ph // bs
    scans = decode_dct_scans(data, nbr * nbc, bs * bs, EOB_MARKER)
    out = np.zeros((nbr * nbc, bs * bs), dtype=np.int16)
    out[:, zigzag_indices(bs)] = scans  # flat[zz[k]] = scan[k]
    return out.reshape(nbr, nbc, bs, bs).swapaxes(1, 2).reshape(nbr * bs, nbc * bs)


def _parse_frames(encoded_fh, ec, params):
    """Yield (index, mode, row_qps, modes|None, mvs|None, qdct) per frame.

    Stops at end-of-stream and at a stream truncated mid-frame: the last
    complete frame is the final one decoded."""
    frame_index = 0
    while True:
        frame_index += 1
        mode_byte = encoded_fh.read(1)
        if frame_index > params.frames_to_process or not mode_byte:
            return
        mode = int.from_bytes(mode_byte)
        len2 = encoded_fh.read(2)
        pred_data = encoded_fh.read(int.from_bytes(len2)) if len(len2) == 2 else b""
        if len(len2) < 2 or len(pred_data) < int.from_bytes(len2):
            logger.warning(f"encoded stream truncated mid-frame {frame_index}; stopping")
            return
        row_qps, modes, mvs = _parse_prediction(pred_data, ec, params, mode == INTRA)
        len3 = encoded_fh.read(3)
        dct_data = encoded_fh.read(int.from_bytes(len3)) if len(len3) == 3 else b""
        if len(len3) < 3 or len(dct_data) < int.from_bytes(len3):
            logger.warning(f"encoded stream truncated mid-frame {frame_index}; stopping")
            return
        yield frame_index, mode, row_qps, modes, mvs, _parse_dct(dct_data, ec, params)


def decode_video(params: InputParameters, *, device=None):
    """Decode the run's ``encoded.bin`` into ``mc_decoded.yuv``, logging each
    frame's PSNR against the encoder's ``mc_reconstructed.yuv``.  Device
    selection as in :func:`encode_video`."""
    ec = params.encoder_config
    _check_slice(ec)
    dev = resolve_device(device if device is not None else ec.device)
    file_io = FileIOHelper(params)
    bs = ec.block_size
    width, height = padded_dims(params.width, params.height, bs)
    nbr, nbc = height // bs, width // bs
    ref = torch.full((height, width), 128, dtype=torch.uint8, device=dev)

    with open(file_io.get_mc_reconstructed_file_name(), "rb") as recon_fh, \
         open(file_io.get_encoded_file_name(), "rb") as encoded_fh, \
         overwrite_open(file_io.get_mc_decoded_file_name()) as decoded_fh:

        def flush(buf):
            nonlocal ref
            first_is_intra = buf[0][1] == INTRA
            mvs = np.stack([b[4] if b[4] is not None
                            else np.zeros((nbr, nbc, 3), np.int32) for b in buf])
            modes0 = (buf[0][3] if first_is_intra
                      else np.zeros((nbr, nbc), np.int32))
            decoded, ref = decode_chunk(
                torch.from_numpy(np.stack([b[5] for b in buf])).to(dev),
                torch.from_numpy(mvs).to(dev),
                torch.from_numpy(np.stack([b[2] for b in buf])).to(dev),
                torch.from_numpy(modes0).to(dev), ref, bs, first_is_intra,
                ec.exact_transform)
            for b, plane in zip(buf, decoded.cpu().numpy()):
                recon = np.frombuffer(recon_fh.read(width * height), dtype=np.uint8)
                frame_psnr = psnr(plane, recon.reshape(height, width))
                logger.info(f"{b[0]:2}: psnr [{round(frame_psnr, 2):6.2f}]")
                write_y_only_frame(decoded_fh, plane)

        # chunks mirror the encoder's: [I P..P] or [P..P], never across an I
        buf = []
        for rec in _parse_frames(encoded_fh, ec, params):
            if buf and (rec[1] == INTRA or len(buf) >= MAX_CHUNK):
                flush(buf)
                buf = []
            buf.append(rec)
        if buf:
            flush(buf)
    logger.info("End decoding")
