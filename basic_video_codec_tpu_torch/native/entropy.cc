// Host entropy codec of basic_video_codec_tpu_torch.
//
// Exp-Golomb bit packing/parsing and RLE block expansion are the only
// inherently sequential, variable-length parts of the codec; everything
// else runs on the device.  They run on the host as tight C loops behind a
// plain C ABI for ctypes (entropy/native.py builds and loads this file).
//
// Bitstream format:
//   signed map: v <= 0 -> -2v, v > 0 -> 2v-1; codeword for mapped m is
//   (n-1) zero bits + n-bit binary of (m+1), MSB first.
//   RLE symbols per block scan: +n = n zeros, -n = n literals follow,
//   0 = rest-of-block zeros; EOB marker terminates each block.

#include <cstdint>

namespace {

// Streaming MSB-first bit writer: codewords accumulate left-aligned in a
// 64-bit register and flush whole bytes.  Codewords here are <= 33 bits
// (int16 coefficient -> mapped+1 <= 2^17 -> 2*17-1), so
// nacc + nbits <= 7 + 33 < 64 always.
struct BitWriter {
  uint8_t* out;
  int64_t cap_bytes;
  int64_t nbytes = 0;
  uint64_t acc = 0;
  int nacc = 0;
  inline bool put(uint64_t value, int nbits) {
    acc |= value << (64 - nacc - nbits);
    nacc += nbits;
    while (nacc >= 8) {
      if (nbytes >= cap_bytes) return false;
      out[nbytes++] = uint8_t(acc >> 56);
      acc <<= 8;
      nacc -= 8;
    }
    return true;
  }
  // zero-pads the final partial byte; returns the BIT length or -1.
  inline int64_t finish() {
    const int64_t bits = nbytes * 8 + nacc;
    if (nacc) {
      if (nbytes >= cap_bytes) return -1;
      out[nbytes++] = uint8_t(acc >> 56);
    }
    return bits;
  }
};

inline int bit_at(const uint8_t* buf, int64_t pos) {
  return (buf[pos >> 3] >> (7 - (pos & 7))) & 1;
}

// Decode one exp-Golomb symbol at `pos`; returns false on end-of-stream
// (trailing byte padding).  Advances pos past the codeword.
inline bool get_symbol(const uint8_t* buf, int64_t n_bits, int64_t& pos, int64_t& out) {
  int64_t m = 0;
  while (pos + m < n_bits && !bit_at(buf, pos + m)) ++m;
  if (pos + m >= n_bits) return false;  // padding tail
  uint64_t value = 1;
  for (int64_t i = 1; i <= m; ++i) value = (value << 1) | uint64_t(bit_at(buf, pos + m + i));
  value -= 1;
  out = (value % 2 == 0) ? -int64_t(value / 2) : int64_t((value + 1) / 2);
  pos += 2 * m + 1;
  return true;
}

}  // namespace

extern "C" {

// Encode n signed symbols; out must be zeroed, cap_bytes its capacity.
// Returns the bit length, or -1 if out of capacity.
int64_t bvc_encode_symbols(const int64_t* syms, int64_t n, uint8_t* out,
                           int64_t cap_bytes) {
  BitWriter bw{out, cap_bytes};
  for (int64_t i = 0; i < n; ++i) {
    int64_t v = syms[i];
    uint64_t mapped = v <= 0 ? uint64_t(-2 * v) : uint64_t(2 * v - 1);
    uint64_t x = mapped + 1;
    int nbits = 64 - __builtin_clzll(x);
    // (nbits-1) leading zeros + nbits value bits
    if (!bw.put(x, 2 * nbits - 1)) return -1;
  }
  return bw.finish();
}

// Decode consecutive symbols until the stream (n_bits) is exhausted or cap
// symbols are produced.  Returns the symbol count.
int64_t bvc_decode_symbols(const uint8_t* buf, int64_t n_bits, int64_t* out,
                           int64_t cap) {
  int64_t pos = 0, count = 0, v;
  while (count < cap && get_symbol(buf, n_bits, pos, v)) out[count++] = v;
  return count;
}

// Decode a frame's DCT payload straight into zigzag scans:
// exp-Golomb symbols -> RLE expansion, blocks delimited by `eob`.
// out must be a zeroed int32 buffer of n_blocks * scan_len.
// Returns the number of completed blocks.
int64_t bvc_decode_dct_blocks(const uint8_t* buf, int64_t n_bits,
                              int32_t* out, int64_t n_blocks,
                              int64_t scan_len, int64_t eob) {
  int64_t pos = 0, blk = 0, idx = 0, v;
  while (blk < n_blocks && get_symbol(buf, n_bits, pos, v)) {
    if (v == eob) {
      ++blk;
      idx = 0;
    } else if (idx >= scan_len) {
      // malformed run past the block end; ignore until EOB
    } else if (v == 0) {
      idx = scan_len;  // rest of block is zeros
    } else if (v > 0) {
      idx += v;  // run of zeros
    } else {
      int64_t cnt = -v;
      for (int64_t k = 0; k < cnt && get_symbol(buf, n_bits, pos, v); ++k) {
        if (idx < scan_len) out[blk * scan_len + idx++] = int32_t(v);
      }
    }
  }
  return blk;
}

// Encode a frame's quantized-DCT plane straight to bits:
// raster blocks -> zigzag gather -> RLE -> exp-Golomb -> EOB per block,
// all in one pass with no intermediate symbol buffer.
// qdct: int16 [h, w]; zz: zigzag flat indices [bs*bs]; out: zeroed buffer.
// Returns the bit length, or -1 if out of capacity.
int64_t bvc_encode_dct_plane(const int16_t* qdct, int64_t h, int64_t w,
                             int64_t bs, const int64_t* zz, int64_t eob,
                             uint8_t* out, int64_t cap_bytes) {
  const int64_t scan_len = bs * bs;
  BitWriter bw{out, cap_bytes};

  auto emit = [&](int64_t v) -> bool {
    uint64_t mapped = v <= 0 ? uint64_t(-2 * v) : uint64_t(2 * v - 1);
    uint64_t x = mapped + 1;
    int nbits = 64 - __builtin_clzll(x);
    return bw.put(x, 2 * nbits - 1);
  };

  // plane offsets of the zigzag scan, computed once (no div/mod per access)
  int64_t zoff[64 * 64];
  for (int64_t i = 0; i < scan_len; ++i)
    zoff[i] = (zz[i] / bs) * w + (zz[i] % bs);
  int16_t scan[64 * 64];

  for (int64_t by = 0; by < h; by += bs) {
    for (int64_t bx = 0; bx < w; bx += bs) {
      const int16_t* blk = qdct + by * w + bx;
      // gather the block's zigzag scan once, then RLE over the flat copy
      int64_t last_nz = -1;
      for (int64_t i = 0; i < scan_len; ++i) {
        scan[i] = blk[zoff[i]];
        if (scan[i]) last_nz = i;
      }
      int64_t i = 0;
      while (i < scan_len) {
        if (i > last_nz) {  // rest-of-block zeros terminator
          if (!emit(0)) return -1;
          break;
        }
        if (scan[i] == 0) {
          int64_t run = 0;
          while (scan[i] == 0) { ++run; ++i; }  // last_nz bounds the walk
          if (!emit(run)) return -1;
        } else {
          int64_t start = i;
          while (i < scan_len && scan[i] != 0) ++i;
          if (!emit(-(i - start))) return -1;
          for (int64_t k = start; k < i; ++k)
            if (!emit(scan[k])) return -1;
        }
      }
      if (!emit(eob)) return -1;
    }
  }
  return bw.finish();
}

// Render the mv.txt line for one frame: entries sorted by (x, y) — x-major —
// formatted "x,y:mvx,mvy|", newline-terminated.
// mvs: int32 [nbr*nbc*3] raster order (mv_x, mv_y, ref).
// Returns the byte length written, or -1 if out of capacity.
int64_t bvc_format_mv_lines(const int32_t* mvs, int64_t nbr, int64_t nbc,
                            int64_t bs, char* out, int64_t cap) {
  int64_t n = 0;
  auto put_int = [&](int64_t v) {
    if (v < 0) { out[n++] = '-'; v = -v; }
    char tmp[20]; int t = 0;
    do { tmp[t++] = char('0' + v % 10); v /= 10; } while (v);
    while (t) out[n++] = tmp[--t];
  };
  for (int64_t j = 0; j < nbc; ++j) {
    for (int64_t i = 0; i < nbr; ++i) {
      if (n + 64 > cap) return -1;
      const int32_t* mv = mvs + (i * nbc + j) * 3;
      put_int(j * bs); out[n++] = ',';
      put_int(i * bs); out[n++] = ':';
      put_int(mv[0]); out[n++] = ',';
      put_int(mv[1]); out[n++] = '|';
    }
  }
  out[n++] = '\n';
  return n;
}

// res_wo_mc plane: (curr - prev) mod 256.
void bvc_wrap_diff(const uint8_t* curr, const uint8_t* prev, uint8_t* out,
                   int64_t n_px) {
  for (int64_t p = 0; p < n_px; ++p) out[p] = uint8_t(curr[p] - prev[p]);
}

// Sum of squared differences of two u8 planes (PSNR numerator).
int64_t bvc_sse(const uint8_t* a, const uint8_t* b, int64_t n_px) {
  int64_t acc = 0;
  for (int64_t p = 0; p < n_px; ++p) {
    const int32_t d = int32_t(a[p]) - int32_t(b[p]);
    acc += d * d;
  }
  return acc;
}

int64_t bvc_version() { return 1; }

}  // extern "C"
