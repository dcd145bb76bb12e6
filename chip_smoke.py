#!/usr/bin/env python3
"""Smoke run of the PyTorch port (basic_video_codec_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if it fails:

1. device and build: prints the card's name and power limit and builds the
   host entropy library (g++) and the CUDA kernel (nvcc, sm_90a) from the
   sources in the checkout;
2. kernel against plain version: the full-search ME kernel is held bit for
   bit against its plain PyTorch version on the card at the slice's shape
   (CIF, block 8, r 2, one reference) and two larger windows, and both are
   timed with CUDA events;
3. the slice at full width: a 30-frame CIF clip is encoded and decoded on
   the card at the bench config (block 8, r 2, I_Period 10, QP 5, one
   reference, RC off); decode must equal the encoder's reconstruction and
   the kernel must have been launched once per P-frame;
4. card against CPU: with the integer-exact transform, 12 frames encoded on
   the card and on the CPU give byte-identical artifact trees.

The last line is ``{"ok": true, "device": {...}}``; the line before it is the
kernels' JSON record (launches on the main path, error, times, bound).
It needs a CUDA card and exits non-zero without one.
"""

import csv
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
SCALAR_OPS_PER_S = 67e12    # H100 SXM float32 rate outside the tensor cores

W, H = 352, 288
BENCH = dict(block_size=8, search_range=2, I_Period=10, quantization_factor=5)
N_FRAMES, N_EXACT = 30, 12
ARTIFACTS = ("encoded.bin", "mv.txt", "mc_reconstructed.yuv",
             "residuals_w_mc.yuv", "residuals_wo_mc.yuv",
             "mc_quant_dct_coff.bin", "metrics.csv")


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def _time_ms(fn, reps: int, batches: int = 9) -> float:
    """Median over ``batches`` of the mean time per call in a batch of
    ``reps`` back-to-back calls, from CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def _device_ms(fn, kernel: str, reps: int = 50) -> tuple[float, str]:
    """Median device time of one launch of ``kernel`` over ``reps`` calls,
    from the profiler's CUDA trace (the wrapper's host time excluded), and
    how it was taken. The trace may drop a launch now and then; the median
    is over the launches it kept. If it kept fewer than half, the time is
    the CUDA-event time per call instead, which includes the wrapper."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = [e.device_time_total for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and kernel in e.name]
    if len(times) < reps // 2:
        return _time_ms(fn, reps), (f"CUDA events (the trace kept "
                                    f"{len(times)} of {reps} launches)")
    return (float(np.median(times)) / 1e3,
            f"on the device, trace of {len(times)} of {reps} launches")


def _me_case(rng, bs, r, n_ref, frac):
    """Card inputs for one ME case: a smooth random frame, references shifted
    from it, random half-pel planes when frac."""
    base = rng.integers(0, 256, size=(H, W), dtype=np.uint8)
    base = ((base.astype(np.int32) + np.roll(base, 1, 0) + np.roll(base, 1, 1))
            // 3).astype(np.uint8)
    refs = np.stack([np.roll(base, (k + 1, -k), (0, 1)) for k in range(n_ref)])
    curr = np.roll(base, (2, 1), (0, 1))
    hps = (rng.integers(0, 256, size=(n_ref, 2 * H, 2 * W), dtype=np.uint8)
           if frac else None)

    def dev(a):
        return None if a is None else torch.from_numpy(a).cuda()

    return dev(curr), dev(refs), dev(hps), bs, r, frac


def _bound_ms(args, n_valid):
    """Least time for the work of one call: bytes (each input read once,
    each output written once) over the memory rate, and the SAD operations
    of this input's in-frame candidates over the scalar rate."""
    curr, refs, hps, bs, r, frac = args
    planes = hps if frac else refs
    nv = planes.shape[0] if n_valid is None else n_valid
    sr, s = (2 * r, 2) if frac else (r, 1)
    nbr, nbc = H // bs, W // bs
    nbytes = (curr.numel() + nv * planes[0].numel()
              + 4 * (nbr * nbc * 4 + H * W))
    off = np.arange(-sr, sr + 1)

    def in_frame(n, lim):  # in-frame candidate offsets per block origin
        o = np.arange(n)[:, None] * bs * s + off[None, :]
        return ((o >= 0) & (o + bs * s <= lim)).sum(axis=1)

    n_cand = nv * np.outer(in_frame(nbr, H * s), in_frame(nbc, W * s)).sum()
    ops = 3 * bs * bs * int(n_cand)  # subtract, absolute, add per pixel
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / SCALAR_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase_kernels(full_search_cuda, me, card):
    """Kernel vs plain version on the card; returns the slice case's record."""
    rng = np.random.default_rng(0)
    cases = [(8, 2, 1, False, None), (16, 4, 1, False, None),
             (16, 4, 4, True, 2)]
    record = None
    for bs, r, n_ref, frac, nv in cases:
        args = _me_case(rng, bs, r, n_ref, frac)

        def call():
            return full_search_cuda.full_search(*args, n_valid=nv)

        def plain():
            return me.full_search(*args, n_valid=nv)

        got, want = call(), plain()
        torch.cuda.synchronize()
        err = max(int((a.long() - b.long()).abs().max()) for a, b in zip(got, want))
        if err != 0:
            raise AssertionError(f"kernel != plain at bs {bs} r {r} n_ref "
                                 f"{n_ref} frac {frac}: max abs err {err}")
        ms, how = _device_ms(call, "full_search_kernel")
        call_ms = _time_ms(call, 50)
        plain_ms = _time_ms(plain, 1, 5)
        bound_ms, bound_by = _bound_ms(args, nv)
        print(f"[{card}] full_search bs={bs} r={r} n_ref={n_ref} frac={frac} "
              f"n_valid={nv}: bit-identical; kernel {ms:.4f} ms ({how}; "
              f"{call_ms:.4f} ms a call with the wrapper), plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.6f} ms ({bound_by})")
        if record is None:
            record = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by)
    return record


def _params(P, path, n, **kw):
    ec = P.EncoderConfig(**BENCH, resolution=(W, H), **kw)
    return P.InputParameters(path, W, H, ec, frames_to_process=n)


def _tree(params):
    from basic_video_codec_tpu_torch.io.fileio import FileIOHelper

    return os.path.dirname(FileIOHelper(params).get_file_name("x"))


def _read(path, name):
    if name == "metrics.csv":  # all but the enc_time / elapsed_time columns
        with open(os.path.join(path, name), newline="") as f:
            return [row[:7] for row in csv.reader(f)]
    with open(os.path.join(path, name), "rb") as f:
        return f.read()


def phase_slice(P, ygen, work):
    """Encode + decode 30 CIF frames on the card; returns the launch counts."""
    from basic_video_codec_tpu_torch.ops.full_search_cuda import LAUNCHES

    frames = ygen.moving_sequence(W, H, N_FRAMES, seed=1)
    for name in ("warm", "run"):
        os.makedirs(os.path.join(work, name))
        ygen.write_y_file(os.path.join(work, name, "seq.y"), frames)
    # warm-up on 3 frames: CUDA context, cuBLAS and the kernel libraries
    P.encode_video(_params(P, os.path.join(work, "warm", "seq.y"), 3),
                   results_csv_path=None)
    params = _params(P, os.path.join(work, "run", "seq.y"), N_FRAMES)
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    t0 = time.perf_counter()
    P.encode_video(params, results_csv_path=None)
    t_enc = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    t0 = time.perf_counter()
    P.decode_video(params)
    t_dec = time.perf_counter() - t0

    tree = _tree(params)
    n_p = N_FRAMES - -(-N_FRAMES // BENCH["I_Period"])
    if launches["full_search"] != n_p:
        raise AssertionError(f"full_search launched {launches['full_search']} "
                             f"times on the main path, expected {n_p}")
    recon = _read(tree, "mc_reconstructed.yuv")
    if len(recon) != N_FRAMES * W * H or recon != _read(tree, "mc_decoded.yuv"):
        raise AssertionError("decode != encoder reconstruction")
    psnrs = [float(row[4]) for row in _read(tree, "metrics.csv")[1:]]
    # QP 5 at block 8 quantizes coarsely (~25 dB on this clip); a broken
    # reconstruction lands far lower
    if len(psnrs) != N_FRAMES or not all(np.isfinite(psnrs)) or min(psnrs) < 20:
        raise AssertionError(f"implausible per-frame PSNR: {psnrs}")
    print(f"slice CIF x {N_FRAMES} frames (bs 8, r 2, I_Period 10, QP 5): "
          f"encode {N_FRAMES / t_enc:.2f} fps ({t_enc:.3f} s), decode "
          f"{N_FRAMES / t_dec:.2f} fps ({t_dec:.3f} s), PSNR "
          f"{min(psnrs):.2f}-{max(psnrs):.2f} dB, decode == recon, "
          f"full_search launches {launches['full_search']}")
    return launches


def phase_card_vs_cpu(P, ygen, work):
    frames = ygen.moving_sequence(W, H, N_EXACT, seed=2)
    trees = []
    for device in ("cuda", "cpu"):
        os.makedirs(os.path.join(work, device))
        path = os.path.join(work, device, "seq.y")
        ygen.write_y_file(path, frames)
        params = _params(P, path, N_EXACT, exact_transform=True, device=device)
        P.encode_video(params, results_csv_path=None)
        trees.append(_tree(params))
    for name in ARTIFACTS:
        if _read(trees[0], name) != _read(trees[1], name):
            raise AssertionError(f"exact mode: {name} differs card vs CPU")
    print(f"exact mode, {N_EXACT} CIF frames: card and CPU artifact trees "
          f"byte-identical")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import basic_video_codec_tpu_torch as P
    from basic_video_codec_tpu_torch.entropy import native
    from basic_video_codec_tpu_torch.ops import full_search_cuda, me
    from basic_video_codec_tpu_torch.tools import ygen

    kind = torch.cuda.get_device_name(0)
    card = _card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        libs = [f.result() for f in [pool.submit(native.build),
                                     pool.submit(full_search_cuda.build)]]
    print(f"built {', '.join(os.path.basename(x) for x in libs)} in "
          f"{time.perf_counter() - t0:.1f} s")

    record = phase_kernels(full_search_cuda, me, card)
    with tempfile.TemporaryDirectory() as work:
        launches = phase_slice(P, ygen, os.path.join(work, "slice"))
        phase_card_vs_cpu(P, ygen, os.path.join(work, "exact"))

    kernels = [dict(
        name="full_search", route="cuda",
        source="basic_video_codec_tpu_torch/csrc/full_search.cu",
        replaces="basic_video_codec_tpu/ops/pallas_me.py:53",
        launches=launches["full_search"], library_ms=None, **record)]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
