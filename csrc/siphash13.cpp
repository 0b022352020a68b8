// Batch SipHash-1-3 (Rust DefaultHasher) — native fast path for k-mer
// hashing. Bit-compatible with allwave/hashing/siphash.py (which is
// the test oracle): keys k0=k1=0, standard SipHash padding, and the Rust
// `Hash for [u8]` discipline (8-byte LE usize length prefix + bytes).
//
// Build: make -C csrc

#include <cstdint>
#include <cstring>

namespace {

inline uint64_t rotl(uint64_t x, int b) { return (x << b) | (x >> (64 - b)); }

struct Sip13 {
  uint64_t v0 = 0x736f6d6570736575ULL;
  uint64_t v1 = 0x646f72616e646f6dULL;
  uint64_t v2 = 0x6c7967656e657261ULL;
  uint64_t v3 = 0x7465646279746573ULL;

  inline void round() {
    v0 += v1; v1 = rotl(v1, 13); v1 ^= v0; v0 = rotl(v0, 32);
    v2 += v3; v3 = rotl(v3, 16); v3 ^= v2;
    v0 += v3; v3 = rotl(v3, 21); v3 ^= v0;
    v2 += v1; v1 = rotl(v1, 17); v1 ^= v2; v2 = rotl(v2, 32);
  }
  inline void compress(uint64_t m) { v3 ^= m; round(); v0 ^= m; }
  inline uint64_t finish(uint64_t b) {
    compress(b);
    v2 ^= 0xff;
    round(); round(); round();
    return v0 ^ v1 ^ v2 ^ v3;
  }
};

inline uint64_t load_le(const uint8_t* p, int n) {
  uint64_t w = 0;
  std::memcpy(&w, p, static_cast<size_t>(n));  // little-endian host
  return w;
}

}  // namespace

extern "C" {

// Hash a single byte stream (raw, no prefix/terminator).
uint64_t siphash13_raw(const uint8_t* data, int64_t len) {
  Sip13 s;
  int64_t nwords = len / 8;
  for (int64_t w = 0; w < nwords; ++w) s.compress(load_le(data + w * 8, 8));
  int tail = static_cast<int>(len % 8);
  uint64_t b = (static_cast<uint64_t>(len & 0xff) << 56) |
               (tail ? load_le(data + nwords * 8, tail) : 0);
  return s.finish(b);
}

// Hash every k-mer window of `seq` with the Rust [u8] discipline:
// stream = le64(k) || window. out has len - k + 1 entries.
void siphash13_kmers(const uint8_t* seq, int64_t len, int32_t k,
                     uint64_t* out) {
  int64_t n = len - k + 1;
  if (n <= 0) return;
  const uint64_t prefix = static_cast<uint64_t>(k);
  const int64_t msg_len = 8 + k;
  const int64_t nwords = msg_len / 8;  // full words incl. the prefix word
  const int tail = static_cast<int>(msg_len % 8);
  const uint64_t len_hi = static_cast<uint64_t>(msg_len & 0xff) << 56;

  for (int64_t i = 0; i < n; ++i) {
    Sip13 s;
    s.compress(prefix);
    const uint8_t* w = seq + i;
    for (int64_t j = 1; j < nwords; ++j) s.compress(load_le(w + (j - 1) * 8, 8));
    uint64_t b = len_hi | (tail ? load_le(w + (nwords - 1) * 8, tail) : 0);
    out[i] = s.finish(b);
  }
}

// Sparsification pair filter (reference: iterator.rs:256-284): for each
// pair p, hash the message  id[qi[p]] ++ ':' ++ id[ti[p]] ++ 0xff  with
// the raw-stream discipline above and keep iff
// (double)hash / (double)UINT64_MAX < keep_fraction — bit-identical
// decisions to the NumPy path (hashing/siphash.py pair_keep_mask*).
// idmat is (n, lmax) row-major zero-padded id bytes; lens holds each
// id's true length.
void siphash13_pair_filter(const uint8_t* idmat, int64_t n, int64_t lmax,
                           const int64_t* lens, const int64_t* qi,
                           const int64_t* ti, int64_t m,
                           double keep_fraction, uint8_t* out) {
  (void)n;
  const double inv_max = 1.0 / static_cast<double>(UINT64_MAX);
  // scratch message buffer: la + ':' + lb + 0xff, padded to whole words
  const int64_t cap = 2 * lmax + 2 + 8;
  uint8_t* buf = new uint8_t[static_cast<size_t>(cap)];
  for (int64_t p = 0; p < m; ++p) {
    const int64_t a = qi[p], b = ti[p];
    const int64_t la = lens[a], lb = lens[b];
    const int64_t len = la + lb + 2;
    std::memcpy(buf, idmat + a * lmax, static_cast<size_t>(la));
    buf[la] = ':';
    std::memcpy(buf + la + 1, idmat + b * lmax, static_cast<size_t>(lb));
    buf[len - 1] = 0xff;
    std::memset(buf + len, 0, 8);  // zero word tail for load_le
    Sip13 s;
    const int64_t nwords = len / 8;
    for (int64_t w = 0; w < nwords; ++w) s.compress(load_le(buf + w * 8, 8));
    const int tail = static_cast<int>(len % 8);
    uint64_t last = (static_cast<uint64_t>(len & 0xff) << 56) |
                    (tail ? load_le(buf + nwords * 8, tail) : 0);
    out[p] = (static_cast<double>(s.finish(last)) * inv_max < keep_fraction)
                 ? 1
                 : 0;
  }
  delete[] buf;
}

}  // extern "C"
