// Native arithmetic (range) coder for RVQ token bitstreams.
//
// Bit-identical C++ backend for hilcodec_tpu/ops/entropy_coding.py (the
// Witten-Neal-Cleary coder with E1/E2/E3 renormalization, 32-bit
// registers, MSB-first bit packing, two-bit finish): the Python classes
// define the format; this file makes the per-symbol hot loop native so
// bitstream encode/decode keeps up with the chip in serving paths. The
// reference ships no coder at all (models/encodec/models.py defines the
// LM entropy model but never uses it).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 rangecoder.cpp -o librangecoder.so

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr uint64_t kBits = 32;
constexpr uint64_t kFull = (1ull << kBits) - 1;
constexpr uint64_t kHalf = 1ull << (kBits - 1);
constexpr uint64_t kQuarter = 1ull << (kBits - 2);

struct BitWriter {
  uint8_t* out;
  int64_t cap;       // capacity in bytes
  int64_t nbytes = 0;
  uint32_t acc = 0;
  int nbits = 0;
  bool overflow = false;

  void write(int bit) {
    acc = (acc << 1) | static_cast<uint32_t>(bit);
    if (++nbits == 8) {
      if (nbytes >= cap) { overflow = true; nbits = 0; acc = 0; return; }
      out[nbytes++] = static_cast<uint8_t>(acc);
      acc = 0;
      nbits = 0;
    }
  }

  int64_t finish_bytes() {
    if (nbits) {
      if (nbytes >= cap) { overflow = true; return -1; }
      out[nbytes++] = static_cast<uint8_t>(acc << (8 - nbits));
    }
    return overflow ? -1 : nbytes;
  }
};

struct BitReader {
  const uint8_t* data;
  int64_t nbytes;
  int64_t pos = 0;   // bit position

  int read() {
    int64_t byte_i = pos >> 3;
    int bit_i = static_cast<int>(pos & 7);
    ++pos;
    if (byte_i >= nbytes) return 0;  // zero-padding past the end
    return (data[byte_i] >> (7 - bit_i)) & 1;
  }
};

}  // namespace

extern "C" {

// symbols[n]; cdfs[n * (card+1)] int64 (one quantized cdf per symbol);
// out[out_cap] receives the bitstream. Returns byte length, or -1 if
// out_cap is too small.
int64_t rc_encode(const int32_t* symbols, int64_t n, const int64_t* cdfs,
                  int64_t card, uint8_t* out, int64_t out_cap) {
  BitWriter w{out, out_cap};
  uint64_t low = 0, high = kFull;
  int64_t pending = 0;
  auto emit = [&](int bit) {
    w.write(bit);
    const int inv = 1 - bit;
    while (pending) { w.write(inv); --pending; }
  };
  const int64_t stride = card + 1;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t* cdf = cdfs + i * stride;
    const uint64_t total = static_cast<uint64_t>(cdf[card]);
    const int64_t s = symbols[i];
    const uint64_t span = high - low + 1;
    high = low + span * static_cast<uint64_t>(cdf[s + 1]) / total - 1;
    low = low + span * static_cast<uint64_t>(cdf[s]) / total;
    for (;;) {
      if (high < kHalf) {
        emit(0);
      } else if (low >= kHalf) {
        emit(1);
        low -= kHalf;
        high -= kHalf;
      } else if (low >= kQuarter && high < 3 * kQuarter) {
        ++pending;
        low -= kQuarter;
        high -= kQuarter;
      } else {
        break;
      }
      low <<= 1;
      high = ((high << 1) | 1) & kFull;
      low &= kFull;
    }
  }
  ++pending;
  emit(low < kQuarter ? 0 : 1);
  return w.finish_bytes();
}

// data[nbytes]; cdfs[n * (card+1)]; writes n symbols into out[n].
// Returns 0 on success.
int rc_decode(const uint8_t* data, int64_t nbytes, const int64_t* cdfs,
              int64_t card, int64_t n, int32_t* out) {
  BitReader r{data, nbytes};
  uint64_t low = 0, high = kFull, code = 0;
  for (uint64_t i = 0; i < kBits; ++i)
    code = (code << 1) | static_cast<uint64_t>(r.read());
  const int64_t stride = card + 1;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t* cdf = cdfs + i * stride;
    const uint64_t total = static_cast<uint64_t>(cdf[card]);
    const uint64_t span = high - low + 1;
    const int64_t value =
        static_cast<int64_t>(((code - low + 1) * total - 1) / span);
    const int64_t* it = std::upper_bound(cdf, cdf + card + 1, value);
    const int64_t s = (it - cdf) - 1;
    out[i] = static_cast<int32_t>(s);
    high = low + span * static_cast<uint64_t>(cdf[s + 1]) / total - 1;
    low = low + span * static_cast<uint64_t>(cdf[s]) / total;
    for (;;) {
      if (high < kHalf) {
        // pass
      } else if (low >= kHalf) {
        low -= kHalf;
        high -= kHalf;
        code -= kHalf;
      } else if (low >= kQuarter && high < 3 * kQuarter) {
        low -= kQuarter;
        high -= kQuarter;
        code -= kQuarter;
      } else {
        break;
      }
      low <<= 1;
      high = ((high << 1) | 1) & kFull;
      code = ((code << 1) | static_cast<uint64_t>(r.read())) & kFull;
      low &= kFull;
    }
  }
  return 0;
}

}  // extern "C"
