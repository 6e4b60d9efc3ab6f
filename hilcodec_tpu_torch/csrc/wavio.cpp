// Native WAV reader: RIFF/PCM parsing + random-access segment reads.
//
// The reference's data pipeline random-seeks PCM16 segments with Python's
// `wave` module inside DataLoader worker processes
// (utils/data/directories.py:173-193). Here the hot path is C++: header
// parse, fseek, int->float conversion, and a thread-pool batched reader
// that fills a whole training batch in one call (the loader threads stay
// GIL-free). Exposed via a plain C ABI for ctypes.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread wavio.cpp -o libwavio.so

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct WavHeader {
  uint16_t format = 0;        // 1 = PCM, 3 = IEEE float
  uint16_t channels = 0;
  uint32_t sample_rate = 0;
  uint16_t bits = 0;
  long data_offset = 0;       // byte offset of sample data
  uint32_t data_bytes = 0;
};

bool parse_header(FILE* f, WavHeader* h) {
  char tag[4];
  uint32_t size;
  if (fread(tag, 1, 4, f) != 4 || memcmp(tag, "RIFF", 4) != 0) return false;
  if (fread(&size, 4, 1, f) != 1) return false;
  if (fread(tag, 1, 4, f) != 4 || memcmp(tag, "WAVE", 4) != 0) return false;
  // walk chunks
  while (fread(tag, 1, 4, f) == 4) {
    if (fread(&size, 4, 1, f) != 1) return false;
    if (memcmp(tag, "fmt ", 4) == 0) {
      uint8_t buf[40];
      uint32_t n = size < sizeof(buf) ? size : (uint32_t)sizeof(buf);
      if (fread(buf, 1, n, f) != n) return false;
      if (size > n) fseek(f, size - n, SEEK_CUR);
      memcpy(&h->format, buf + 0, 2);
      memcpy(&h->channels, buf + 2, 2);
      memcpy(&h->sample_rate, buf + 4, 4);
      memcpy(&h->bits, buf + 14, 2);
      if (h->format == 0xFFFE && size >= 26) {  // WAVE_FORMAT_EXTENSIBLE
        memcpy(&h->format, buf + 24, 2);
      }
    } else if (memcmp(tag, "data", 4) == 0) {
      h->data_offset = ftell(f);
      h->data_bytes = size;
      return h->format != 0 && h->channels > 0 && h->bits > 0;
    } else {
      fseek(f, (size + 1) & ~1u, SEEK_CUR);  // chunks are word-aligned
    }
  }
  return false;
}

// Read `frames` frames starting at `start`; mono-mix into out[0..frames).
// Returns frames actually read, or -1 on error.
int64_t read_segment(const char* path, int64_t start, int64_t frames,
                     float* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavHeader h;
  if (!parse_header(f, &h)) { fclose(f); return -1; }
  const int bytes_per = h.bits / 8;
  const int64_t frame_bytes = (int64_t)bytes_per * h.channels;
  const int64_t total = h.data_bytes / frame_bytes;
  if (start < 0) start = 0;
  if (start > total) start = total;
  int64_t n = frames < 0 ? total - start : frames;
  if (start + n > total) n = total - start;
  if (n <= 0) { fclose(f); return 0; }

  fseek(f, h.data_offset + start * frame_bytes, SEEK_SET);
  std::vector<uint8_t> buf((size_t)(n * frame_bytes));
  int64_t got = (int64_t)fread(buf.data(), frame_bytes, (size_t)n, f);
  fclose(f);

  const int C = h.channels;
  for (int64_t i = 0; i < got; ++i) {
    float acc = 0.f;
    for (int c = 0; c < C; ++c) {
      const uint8_t* p = buf.data() + (i * C + c) * bytes_per;
      float v;
      if (h.format == 3 && h.bits == 32) {        // IEEE float
        memcpy(&v, p, 4);
      } else if (h.bits == 16) {
        int16_t s; memcpy(&s, p, 2);
        v = (float)s / 32768.f;
      } else if (h.bits == 32) {
        int32_t s; memcpy(&s, p, 4);
        v = (float)s / 2147483648.f;
      } else if (h.bits == 24) {
        int32_t s = (int32_t)((uint32_t)p[0] << 8 | (uint32_t)p[1] << 16 |
                              (uint32_t)p[2] << 24) >> 8;
        v = (float)s / 8388608.f;
      } else if (h.bits == 8) {
        v = ((float)p[0] - 128.f) / 128.f;
      } else {
        return -1;
      }
      acc += v;
    }
    out[i] = acc / (float)C;
  }
  return got;
}

}  // namespace

extern "C" {

// frames/sample_rate/channels via out-params; returns 0 on success.
int wav_info(const char* path, int64_t* frames, int32_t* sample_rate,
             int32_t* channels) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavHeader h;
  bool ok = parse_header(f, &h);
  fclose(f);
  if (!ok) return -1;
  *frames = h.data_bytes / ((int64_t)(h.bits / 8) * h.channels);
  *sample_rate = (int32_t)h.sample_rate;
  *channels = (int32_t)h.channels;
  return 0;
}

int64_t wav_read_segment(const char* path, int64_t start, int64_t frames,
                         float* out) {
  return read_segment(path, start, frames, out);
}

// Batched reader: fill out[i*frames .. (i+1)*frames) from paths[i] at
// starts[i] using `threads` worker threads. Short reads are zero-padded.
// Returns the number of successful items.
int wav_read_batch(const char** paths, const int64_t* starts, int64_t frames,
                   int n, float* out, int threads) {
  if (threads < 1) threads = 1;
  std::vector<int> ok(n, 0);
  auto work = [&](int tid) {
    for (int i = tid; i < n; i += threads) {
      float* dst = out + (int64_t)i * frames;
      memset(dst, 0, sizeof(float) * (size_t)frames);
      int64_t got = read_segment(paths[i], starts[i], frames, dst);
      ok[i] = got >= 0 ? 1 : 0;
    }
  };
  std::vector<std::thread> pool;
  for (int t = 1; t < threads; ++t) pool.emplace_back(work, t);
  work(0);
  for (auto& th : pool) th.join();
  int good = 0;
  for (int v : ok) good += v;
  return good;
}

}  // extern "C"
