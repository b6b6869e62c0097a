// blosclz (c-blosc 1.x codec 0) block decompressor.
//
// Native decoder for WIM-preprocessed ZJU caches, whose per-frame image and
// mask arrays are blosc.pack_array() payloads (reference
// lib/load_zju.py:108-110). The surrounding blosc1 frame (16-byte header,
// block starts, split streams, byte unshuffle) is parsed in Python
// (apnerf_torch/data/bloscdec.py); this file implements only the hot inner
// codec: the FastLZ-derived blosclz token stream.
//
// Token grammar (ctrl = first byte of each token):
//   ctrl < 32   : literal run of (ctrl + 1) bytes follows
//   ctrl >= 32  : match; len_code = ctrl >> 5, ofs_hi = ctrl & 31
//     len = len_code - 1; if len_code == 7: extend with 255-terminated bytes
//     code = next byte; ref = op - (ofs_hi << 8) - code - 1
//     if code == 255 and ofs_hi == 31: 16-bit far match,
//        ofs = next two bytes (big-endian); ref = op - ofs - MAX_DISTANCE - 1
//     copy (len + 3) bytes from ref (overlap allowed; ofs 0 = RLE of last)
//
// Exposed as a C ABI for ctypes.

#include <cstdint>
#include <cstring>

namespace {
constexpr int64_t kMaxDistance = 8191;
}

extern "C" {

// Decompress one blosclz stream. Returns the number of bytes written to
// dst, or -1 if the stream is malformed / would overrun either buffer.
int64_t apnerf_blosclz_decompress(const uint8_t* src, int64_t srclen,
                                  uint8_t* dst, int64_t dstcap) {
  if (srclen <= 0) return 0;
  const uint8_t* ip = src;
  const uint8_t* ip_limit = src + srclen;
  uint8_t* op = dst;
  uint8_t* op_limit = dst + dstcap;

  int32_t ctrl = (*ip++) & 31;
  bool loop = true;
  do {
    if (ctrl >= 32) {
      int64_t len = (ctrl >> 5) - 1;
      int64_t ofs = (ctrl & 31) << 8;
      if (len == 7 - 1) {
        uint8_t code;
        do {
          if (ip >= ip_limit) return -1;
          code = *ip++;
          len += code;
        } while (code == 255);
      }
      if (ip >= ip_limit) return -1;
      uint8_t code = *ip++;
      const uint8_t* ref = op - ofs - code;
      if (code == 255 && ofs == (31 << 8)) {
        if (ip + 2 > ip_limit) return -1;
        ofs = (int64_t(ip[0]) << 8) + ip[1];
        ip += 2;
        ref = op - ofs - kMaxDistance;
      }
      if (ip < ip_limit)
        ctrl = *ip++;
      else
        loop = false;
      len += 3;
      ref -= 1;  // distances are stored off by one
      if (ref < dst || op + len > op_limit) return -1;
      // byte-wise copy: overlapping refs (incl. ofs 0 = RLE) must replicate
      for (; len; --len) *op++ = *ref++;
    } else {
      int64_t run = ctrl + 1;
      if (ip + run > ip_limit || op + run > op_limit) return -1;
      std::memcpy(op, ip, run);
      ip += run;
      op += run;
      loop = ip < ip_limit;
      if (loop) ctrl = *ip++;
    }
  } while (loop);
  return op - dst;
}

}  // extern "C"
