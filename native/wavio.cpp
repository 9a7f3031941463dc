// Native WAV corpus loader for mfcc_tpu.
//
// Host-side IO is the one part of this framework where native code buys real
// throughput (the device compute path is JAX; SURVEY.md §2b): corpus
// ingestion decodes millions of PCM samples per second and feeds pinned host
// buffers for device transfer.  This translation unit provides:
//
//   - mfcc_read_wav:   parse+decode one RIFF/WAVE file to float32 mono
//   - mfcc_read_wavs:  thread-pooled batch decode straight into a caller-
//                      provided padded (B, L) matrix + length vector (zero
//                      copies on the Python side, rows ready for jax.device_put)
//   - mfcc_free:       release buffers allocated by mfcc_read_wav
//
// Decoding matches mfcc_tpu/utils/wav.py exactly (PCM16 -> x/32768, etc.);
// the Python parser remains the reference and fallback.  Exposed via ctypes
// (no pybind11 in this image).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Chunk {
  const uint8_t* p;
  uint32_t size;
};

struct Fmt {
  uint16_t format = 0;
  uint16_t channels = 0;
  uint32_t sample_rate = 0;
  uint16_t bits = 0;
  bool ok = false;
};

uint32_t rd32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;  // WAV is little-endian; all supported targets are LE
}
uint16_t rd16(const uint8_t* p) {
  uint16_t v;
  std::memcpy(&v, p, 2);
  return v;
}

// Returns 0 on success; negative error codes otherwise.
//   -1 io error, -2 not a wav, -3 missing chunks, -4 unsupported encoding
int parse_wav(const uint8_t* data, size_t len, Fmt* fmt, Chunk* payload) {
  if (len < 12 || std::memcmp(data, "RIFF", 4) != 0 ||
      std::memcmp(data + 8, "WAVE", 4) != 0)
    return -2;
  size_t pos = 12;
  payload->p = nullptr;
  while (pos + 8 <= len) {
    const uint8_t* cid = data + pos;
    uint32_t csz = rd32(data + pos + 4);
    pos += 8;
    if (pos + csz > len) csz = static_cast<uint32_t>(len - pos);
    if (std::memcmp(cid, "fmt ", 4) == 0 && csz >= 16) {
      fmt->format = rd16(data + pos);
      fmt->channels = rd16(data + pos + 2);
      fmt->sample_rate = rd32(data + pos + 4);
      fmt->bits = rd16(data + pos + 14);
      // WAVE_FORMAT_EXTENSIBLE: treat integer widths as PCM (matches wav.py)
      if (fmt->format == 0xFFFE &&
          (fmt->bits == 8 || fmt->bits == 16 || fmt->bits == 24 ||
           fmt->bits == 32))
        fmt->format = 1;
      fmt->ok = true;
    } else if (std::memcmp(cid, "data", 4) == 0) {
      payload->p = data + pos;
      payload->size = csz;
    }
    pos += csz + (csz & 1);  // chunks are word-aligned
  }
  if (!fmt->ok || payload->p == nullptr) return -3;
  return 0;
}

// Decode interleaved samples to float32, mono-mixing or selecting a channel.
// channel < 0 -> average all channels.  Returns frame count.
int64_t decode(const Fmt& fmt, const Chunk& payload, int channel, float* out) {
  const int nch = fmt.channels ? fmt.channels : 1;
  const uint8_t* p = payload.p;
  int64_t frames = 0;
  const float inv_nch = 1.0f / static_cast<float>(nch);

  auto mix = [&](auto sample_at, int64_t n_frames) {
    if (nch == 1) {
      for (int64_t i = 0; i < n_frames; ++i) out[i] = sample_at(i);
    } else if (channel >= 0) {
      for (int64_t i = 0; i < n_frames; ++i)
        out[i] = sample_at(i * nch + channel) ;
    } else {
      for (int64_t i = 0; i < n_frames; ++i) {
        float acc = 0.f;
        for (int c = 0; c < nch; ++c) acc += sample_at(i * nch + c);
        out[i] = acc * inv_nch;
      }
    }
  };
  // note for the `channel >= 0` branch above: index is per-sample, frames
  // below already divide by nch, so sample_at sees interleaved indices.

  if (fmt.format == 1 && fmt.bits == 16) {
    frames = payload.size / (2 * nch);
    const int16_t* s = reinterpret_cast<const int16_t*>(p);
    mix([&](int64_t i) { int16_t v; std::memcpy(&v, s + i, 2);
                         return static_cast<float>(v) * (1.0f / 32768.0f); },
        frames);
  } else if (fmt.format == 1 && fmt.bits == 8) {
    frames = payload.size / (1 * nch);
    mix([&](int64_t i) { return (static_cast<float>(p[i]) - 128.0f) *
                                (1.0f / 128.0f); },
        frames);
  } else if (fmt.format == 1 && fmt.bits == 24) {
    frames = payload.size / (3 * nch);
    mix([&](int64_t i) {
          const uint8_t* b = p + 3 * i;
          int32_t v = static_cast<int32_t>(b[0]) |
                      (static_cast<int32_t>(b[1]) << 8) |
                      (static_cast<int32_t>(b[2]) << 16);
          if (v >= (1 << 23)) v -= (1 << 24);
          return static_cast<float>(v) * (1.0f / 8388608.0f);
        },
        frames);
  } else if (fmt.format == 1 && fmt.bits == 32) {
    frames = payload.size / (4 * nch);
    mix([&](int64_t i) { int32_t v; std::memcpy(&v, p + 4 * i, 4);
                         return static_cast<float>(v) *
                                (1.0f / 2147483648.0f); },
        frames);
  } else if (fmt.format == 3 && fmt.bits == 32) {
    frames = payload.size / (4 * nch);
    mix([&](int64_t i) { float v; std::memcpy(&v, p + 4 * i, 4); return v; },
        frames);
  } else {
    return -4;
  }
  return frames;
}

int read_file(const char* path, std::vector<uint8_t>* buf) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  long sz = std::ftell(f);
  if (sz < 0) { std::fclose(f); return -1; }
  std::fseek(f, 0, SEEK_SET);
  buf->resize(static_cast<size_t>(sz));
  size_t got = sz ? std::fread(buf->data(), 1, static_cast<size_t>(sz), f) : 0;
  std::fclose(f);
  if (got != static_cast<size_t>(sz)) return -1;
  return 0;
}

}  // namespace

extern "C" {

// Single file.  On success (*out, *n_samples, *sample_rate) are set; the
// caller owns *out and must release it with mfcc_free.
int mfcc_read_wav(const char* path, int channel, float** out,
                  int64_t* n_samples, int32_t* sample_rate) {
  std::vector<uint8_t> buf;
  if (int rc = read_file(path, &buf)) return rc;
  Fmt fmt;
  Chunk payload;
  if (int rc = parse_wav(buf.data(), buf.size(), &fmt, &payload)) return rc;
  const int nch = fmt.channels ? fmt.channels : 1;
  int64_t max_frames = payload.size / ((fmt.bits / 8) * nch);
  float* dst = static_cast<float*>(std::malloc(sizeof(float) * (max_frames ? max_frames : 1)));
  if (!dst) return -5;
  int64_t frames = decode(fmt, payload, channel, dst);
  if (frames < 0) { std::free(dst); return static_cast<int>(frames); }
  *out = dst;
  *n_samples = frames;
  *sample_rate = static_cast<int32_t>(fmt.sample_rate);
  return 0;
}

void mfcc_free(float* p) { std::free(p); }

// Batch decode into a caller-provided padded matrix.
//   paths:      array of n C strings
//   out:        (n, max_len) float32, rows zero-padded past each length
//   lengths:    (n,) int64 decoded sample counts (truncated to max_len)
//   rates:      (n,) int32 sample rates (0 on failure)
//   errors:     (n,) int32 per-file status (0 ok; negative = error code,
//               quarantined — row left zeroed, job continues)
//   n_threads:  <=0 means hardware concurrency
void mfcc_read_wavs(const char** paths, int64_t n, int channel,
                    float* out, int64_t max_len, int64_t* lengths,
                    int32_t* rates, int32_t* errors, int n_threads) {
  if (n_threads <= 0)
    n_threads = static_cast<int>(std::thread::hardware_concurrency());
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = static_cast<int>(n);
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    std::vector<uint8_t> buf;
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n) return;
      float* row = out + i * max_len;
      std::memset(row, 0, sizeof(float) * max_len);
      lengths[i] = 0;
      rates[i] = 0;
      buf.clear();
      int rc = read_file(paths[i], &buf);
      if (rc == 0) {
        Fmt fmt;
        Chunk payload;
        rc = parse_wav(buf.data(), buf.size(), &fmt, &payload);
        if (rc == 0) {
          const int nch = fmt.channels ? fmt.channels : 1;
          int64_t max_frames = payload.size / ((fmt.bits / 8) * nch);
          std::vector<float> tmp(static_cast<size_t>(max_frames ? max_frames : 1));
          int64_t frames = decode(fmt, payload, channel, tmp.data());
          if (frames < 0) {
            rc = static_cast<int>(frames);
          } else {
            int64_t keep = frames < max_len ? frames : max_len;
            std::memcpy(row, tmp.data(), sizeof(float) * keep);
            lengths[i] = keep;
            rates[i] = static_cast<int32_t>(fmt.sample_rate);
          }
        }
      }
      errors[i] = rc;
    }
  };
  std::vector<std::thread> pool;
  for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

// Raw PCM16 batch loader: like mfcc_read_wavs but emits int16 samples
// untouched (pure memcpy of the interleaved payload for mono files).
// Halves host->device transfer; the pipeline casts to float on-device.
// Only 16-bit integer PCM mono sources qualify; anything else gets error
// -6 so the caller falls back to the float path for that file.
void mfcc_read_wavs_i16(const char** paths, int64_t n,
                        int16_t* out, int64_t max_len, int64_t* lengths,
                        int32_t* rates, int32_t* errors, int n_threads) {
  if (n_threads <= 0)
    n_threads = static_cast<int>(std::thread::hardware_concurrency());
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = static_cast<int>(n);
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    std::vector<uint8_t> buf;
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n) return;
      int16_t* row = out + i * max_len;
      std::memset(row, 0, sizeof(int16_t) * max_len);
      lengths[i] = 0;
      rates[i] = 0;
      buf.clear();
      int rc = read_file(paths[i], &buf);
      if (rc == 0) {
        Fmt fmt;
        Chunk payload;
        rc = parse_wav(buf.data(), buf.size(), &fmt, &payload);
        if (rc == 0) {
          if (fmt.format == 1 && fmt.bits == 16 && fmt.channels <= 1) {
            int64_t frames = payload.size / 2;
            int64_t keep = frames < max_len ? frames : max_len;
            std::memcpy(row, payload.p, sizeof(int16_t) * keep);
            lengths[i] = keep;
            rates[i] = static_cast<int32_t>(fmt.sample_rate);
          } else {
            rc = -6;  // not mono PCM16: caller uses the float path
          }
        }
      }
      errors[i] = rc;
    }
  };
  std::vector<std::thread> pool;
  for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

}  // extern "C"
