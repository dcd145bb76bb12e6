#!/usr/bin/env python3
"""Where the PyTorch port's encode time goes, on one CUDA card.

    python3 scripts/profile_torch_slice.py [--frames 30]

Encodes a CIF ``moving_sequence`` clip at the bench config (block 8, r 2,
I_Period 10, QP 5, one reference, RC off) after a warm-up:

1. five times plain, for the end-to-end wall time and its spread;
2. with host timers around the pipeline's stages (device chunk dispatch,
   the one device-to-host fetch per chunk, host entropy finalize, artifact
   writes), and with a synchronize after every I-frame and P-frame so
   the device work of each frame type is attributed to it;
3. under ``torch.profiler``, for the device busy time, its share of the
   wall time and the kernels that take it.

Prints one JSON line per measurement, each with the card's name and power
limit.  Needs a CUDA card.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from collections import defaultdict

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

W, H = 352, 288


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=30)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_slice: no CUDA device", file=sys.stderr)
        return 1
    import basic_video_codec_tpu_torch as P
    from basic_video_codec_tpu_torch.models import chunk, pipeline
    from basic_video_codec_tpu_torch.tools import ygen

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    n = args.frames

    def run(work, name):
        d = os.path.join(work, name)
        os.makedirs(d)
        path = ygen.write_y_file(os.path.join(d, "seq.y"),
                                 ygen.moving_sequence(W, H, n, seed=1))
        ec = P.EncoderConfig(8, 2, 10, 5, resolution=(W, H))
        t0 = time.perf_counter()
        P.encode_video(P.InputParameters(path, W, H, ec, n),
                       results_csv_path=None)
        return time.perf_counter() - t0

    def emit(**kw):
        print(json.dumps(dict(card=card, frames=n, **kw)))

    with tempfile.TemporaryDirectory() as work:
        run(work, "warm")
        walls = [run(work, f"plain{i}") for i in range(5)]
        emit(measure="end_to_end", wall_s=walls,
             fps=[n / w for w in walls], fps_median=n / sorted(walls)[2])

        # 2. stage timers: wrap the pipeline's stages in place for one run
        totals, counts = defaultdict(float), defaultdict(int)

        def timed(name, fn, sync=False):
            def inner(*a, **k):
                t0 = time.perf_counter()
                out = fn(*a, **k)
                if sync:
                    torch.cuda.synchronize()
                totals[name] += time.perf_counter() - t0
                counts[name] += 1
                return out
            return inner

        saved = {(m, f): getattr(m, f) for m, f in (
            (chunk, "intra_encode_frame"), (chunk, "pframe_encode"),
            (pipeline, "_fetch"), (pipeline, "_finalize_arrays"),
            (pipeline._EncodeSink, "write"))}
        try:
            chunk.intra_encode_frame = timed(
                "device: intra frame (synchronized)", saved[chunk, "intra_encode_frame"], True)
            chunk.pframe_encode = timed(
                "device: P-frame (synchronized)", saved[chunk, "pframe_encode"], True)
            pipeline._fetch = timed("fetch: device to host", saved[pipeline, "_fetch"])
            pipeline._finalize_arrays = timed(
                "host: entropy finalize", saved[pipeline, "_finalize_arrays"])
            pipeline._EncodeSink.write = timed(
                "host: artifact write", saved[pipeline._EncodeSink, "write"])
            wall_staged = run(work, "staged")
        finally:
            for (m, f), fn in saved.items():
                setattr(m, f, fn)
        emit(measure="stages", wall_s=wall_staged,
             stages={k: dict(total_s=v, calls=counts[k], ms_per_call=1e3 * v / counts[k])
                     for k, v in totals.items()})

        # 3. device busy time under the profiler
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wall_prof = run(work, "profiled")
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_s = sum(e.self_device_time_total for e in kernels) / 1e6
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
        emit(measure="device", wall_s=wall_prof, device_busy_s=busy_s,
             idle_share=1 - busy_s / wall_prof,
             launches=sum(e.count for e in kernels),
             top=[dict(kernel=e.key[:80], calls=e.count,
                       device_ms=e.self_device_time_total / 1e3) for e in top])
    return 0


if __name__ == "__main__":
    sys.exit(main())
