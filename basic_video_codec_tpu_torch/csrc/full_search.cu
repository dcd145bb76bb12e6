// Full-search block motion estimation with motion-compensated prediction,
// for Hopper (sm_90a).
//
// Replaces basic_video_codec_tpu/ops/pallas_me.py::_me_kernel.  Computes
// exactly what ops/me.py::full_search (its plain PyTorch twin) computes:
// for every bs x bs block, the SAD of each candidate (ref k, dy, dx) of the
// n_valid * (2sr+1)^2 window; out-of-frame candidates are excluded; the
// winner is the first strict minimum of SAD*256 + |dx|+|dy| in enumeration
// order (ref-major, then dy, then dx).  With half-pel search (scale 2) the
// planes are the [2H, 2W] interpolated buffers and the block's pixels are
// read with stride 2.
//
// Bound: it moves few bytes.  At CIF (352x288, block 8, r 2, one reference)
// it reads the u8 current frame and reference (2 x 101 KB) and writes the
// i32 prediction plane (405 KB) plus 25 KB of MVs and SADs: about 0.63 MB,
// 0.19 us at the H100's 3.35 TB/s.  The SAD work is 1584 blocks x 25
// candidates x 64 pixels, about 7.6 M integer operations.  In practice one
// launch is bound by launch latency and by the tail of 1584 small CTAs.
//
// Design: one CTA per block.  The CTA stages its current block and, one
// reference at a time, the reference window that all its candidates read
// ((scale*(bs-1) + 1 + 2sr)^2 bytes) in shared memory, so each reference
// pixel is read from device memory once per block.  Threads take
// candidates and keep a running minimum of the packed 64-bit value
// (key << 32 | candidate index); the minimum over the CTA is then the
// smallest key with the smallest index among equal keys, which is the
// first-strict-minimum tie-break of the reference exactly.  The winner's
// pixels are copied from the reference plane into the prediction.  There is
// no cap on the candidate count: the window is dynamic shared memory, up to
// the 227 KB a block may use (sr <= 127 keeps it below that for bs <= 16).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__global__ void full_search_kernel(const uint8_t* __restrict__ curr,
                                   const uint8_t* __restrict__ planes,
                                   int n_valid, int h, int w, int bs, int sr,
                                   int scale, int win,
                                   int32_t* __restrict__ mvs,
                                   int32_t* __restrict__ sad_out,
                                   int32_t* __restrict__ pred) {
  extern __shared__ uint8_t smem[];
  uint8_t* s_curr = smem;            // [bs * bs]
  uint8_t* s_win = smem + bs * bs;   // [win * win]
  __shared__ unsigned long long s_best;

  const int bi = blockIdx.y, bj = blockIdx.x, nbc = gridDim.x;
  const int ph = h * scale, pw = w * scale;              // plane dims
  const int oy = bi * bs * scale, ox = bj * bs * scale;  // block origin
  const int bspan = bs * scale;
  const int span = 2 * sr + 1, per_ref = span * span;
  const int tid = threadIdx.x;

  for (int p = tid; p < bs * bs; p += blockDim.x)
    s_curr[p] = curr[(bi * bs + p / bs) * w + bj * bs + p % bs];
  if (tid == 0) s_best = ~0ull;

  unsigned long long best = ~0ull;
  for (int k = 0; k < n_valid; ++k) {
    __syncthreads();  // the previous reference's window is no longer read
    const uint8_t* plane = planes + size_t(k) * ph * pw;
    for (int p = tid; p < win * win; p += blockDim.x) {
      const int y = oy - sr + p / win, x = ox - sr + p % win;
      s_win[p] = (y >= 0 && y < ph && x >= 0 && x < pw)
                     ? plane[size_t(y) * pw + x] : uint8_t(0);
    }
    __syncthreads();
    for (int c = tid; c < per_ref; c += blockDim.x) {
      const int dy = c / span - sr, dx = c % span - sr;
      if (ox + dx < 0 || ox + dx + bspan > pw || oy + dy < 0 ||
          oy + dy + bspan > ph)
        continue;  // out of frame: never a winner
      const uint8_t* base = s_win + (sr + dy) * win + (sr + dx);
      int sad = 0;
      for (int a = 0; a < bs; ++a) {
        const uint8_t* row = base + scale * a * win;
        const uint8_t* crow = s_curr + a * bs;
        for (int b = 0; b < bs; ++b)
          sad += abs(int(crow[b]) - int(row[scale * b]));
      }
      const unsigned long long key =
          (unsigned long long)(sad * 256 + abs(dx) + abs(dy));
      const unsigned long long packed =
          (key << 32) | (unsigned long long)(k * per_ref + c);
      if (packed < best) best = packed;
    }
  }

  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long other = __shfl_down_sync(0xffffffffu, best, off);
    if (other < best) best = other;
  }
  if ((tid & 31) == 0) atomicMin(&s_best, best);
  __syncthreads();

  const int idx = int(s_best & 0xffffffffu);
  const int k = idx / per_ref, rem = idx % per_ref;
  const int dy = rem / span - sr, dx = rem % span - sr;
  const int blk = bi * nbc + bj;
  if (tid == 0) {
    mvs[blk * 3 + 0] = dx;
    mvs[blk * 3 + 1] = dy;
    mvs[blk * 3 + 2] = k;
    sad_out[blk] = int(s_best >> 40);  // key >> 8: |dx|+|dy| < 256
  }
  const uint8_t* src = planes + size_t(k) * ph * pw +
                       size_t(oy + dy) * pw + (ox + dx);
  for (int p = tid; p < bs * bs; p += blockDim.x)
    pred[size_t(blk) * bs * bs + p] =
        src[size_t(scale) * (p / bs) * pw + scale * (p % bs)];
}

}  // namespace

// curr: u8 [h, w]; planes: u8 [n_ref, h*scale, w*scale] (scale 2 when frac);
// only the first n_valid planes are searched.  Outputs: mvs i32
// [nbr, nbc, 3] as (dx, dy, ref), sad i32 [nbr, nbc], pred i32
// [nbr, nbc, bs, bs].  Launches on `stream` and returns cudaGetLastError().
extern "C" int bvc_full_search(const void* curr, const void* planes,
                               int n_valid, int h, int w, int bs, int sr,
                               int frac, void* mvs, void* sad, void* pred,
                               void* stream) {
  const int scale = frac ? 2 : 1;
  const int win = scale * (bs - 1) + 1 + 2 * sr;
  const size_t smem = size_t(bs) * bs + size_t(win) * win;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        full_search_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (e != cudaSuccess) return int(e);
  }
  const int per_ref = (2 * sr + 1) * (2 * sr + 1);
  int threads = (per_ref + 31) / 32 * 32;
  if (threads > 256) threads = 256;
  const dim3 grid(w / bs, h / bs);
  full_search_kernel<<<grid, threads, smem, cudaStream_t(stream)>>>(
      static_cast<const uint8_t*>(curr), static_cast<const uint8_t*>(planes),
      n_valid, h, w, bs, sr, scale, win, static_cast<int32_t*>(mvs),
      static_cast<int32_t*>(sad), static_cast<int32_t*>(pred));
  return int(cudaGetLastError());
}
