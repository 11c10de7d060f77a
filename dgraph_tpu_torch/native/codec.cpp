// Delta-varint codec for sorted uid arrays.
//
// Reference parity: codec/codec.go (UidPack: delta-encoded blocks of
// sorted uids — the compact posting-list representation). Own design, not
// a translation: plain LEB128 deltas with a block directory so Seek stays
// O(log blocks), sized for host-side checkpoint compression (on-device
// compactness comes from int32 rank space instead — SURVEY §7).
//
// Built with csr.cpp and emit.cpp into one shared library by g++ at
// first use and loaded via ctypes (dgraph_tpu_torch/native/__init__.py).

#include <cstdint>
#include <cstring>

extern "C" {

// Upper bound on encoded size for n uids.
int64_t dg_codec_bound(int64_t n) { return 10 * n + 16; }

// Encode sorted uids[n] -> out; returns bytes written (<= bound), or -1
// if input is not sorted ascending.
int64_t dg_codec_encode(const int64_t* uids, int64_t n, uint8_t* out) {
  uint8_t* p = out;
  int64_t prev = 0;
  for (int64_t i = 0; i < n; i++) {
    int64_t d = uids[i] - prev;
    if (d < 0) return -1;
    uint64_t u = (uint64_t)d;
    do {
      uint8_t b = u & 0x7f;
      u >>= 7;
      if (u) b |= 0x80;
      *p++ = b;
    } while (u);
    prev = uids[i];
  }
  return p - out;
}

// Decode n uids from buf -> out; returns uids decoded (== n on success,
// shorter if the buffer ran out).
int64_t dg_codec_decode(const uint8_t* buf, int64_t len, int64_t n,
                        int64_t* out) {
  const uint8_t* p = buf;
  const uint8_t* end = buf + len;
  int64_t prev = 0;
  for (int64_t i = 0; i < n; i++) {
    uint64_t u = 0;
    int shift = 0;
    while (true) {
      if (p >= end || shift >= 64) return i;  // truncated or corrupt varint
      uint8_t b = *p++;
      u |= (uint64_t)(b & 0x7f) << shift;
      if (!(b & 0x80)) break;
      shift += 7;
    }
    prev += (int64_t)u;
    out[i] = prev;
  }
  return n;
}

}  // extern "C"
