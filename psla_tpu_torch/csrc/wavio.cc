// Native host-side WAV batch decoder for the psla_tpu_torch input pipeline
// (a copy of psla_tpu/csrc/wavio.cc: the port builds its own).
//
// Replaces the role of the reference's torchaudio.load / libsox C backend
// (reference: src/dataloaders/audioset_dataset.py:91) on the host feed path.
// Semantics match psla_tpu_torch/data/wav.py (the pure-numpy golden):
//   * RIFF/WAVE chunk walk, word-aligned chunks
//   * PCM 8/16/24/32 and IEEE float32; WAVE_FORMAT_EXTENSIBLE resolved from
//     the SubFormat GUID
//   * normalization: i16/32768, (u8-128)/128, i24/2^23, i32/2^31
//   * multichannel: channel 0 only (the reference always takes waveform[0])
//
// Each clip is decoded in ONE streaming pass that simultaneously
//   - writes the first `buffer_samples` samples into a caller-provided
//     zero-padded float32 buffer (the fixed-shape device feed),
//   - accumulates the FULL-clip mean in float64 (the loader's DC-removal
//     term, computed over all samples even when the clip is truncated),
//   - reports the true in-buffer length.
// The batch entry point shards clips over a std::thread pool; calls are made
// from Python via ctypes, which releases the GIL for the whole batch.
//
// Build: g++ -O3 -march=native -shared -fPIC wavio.cc -o libpslawav.so
// (see psla_tpu_torch/data/native.py, which compiles and caches this on demand).

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#include "wavio.h"

namespace {

constexpr int kOk = 0;
constexpr int kErrOpen = -1;
constexpr int kErrNotWave = -2;
constexpr int kErrNoChunks = -3;
constexpr int kErrBadFormat = -4;

struct RawFile {
  std::vector<uint8_t> bytes;
};

bool read_file(const char* path, RawFile* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (size < 0) {
    std::fclose(f);
    return false;
  }
  out->bytes.resize(static_cast<size_t>(size));
  size_t got = size ? std::fread(out->bytes.data(), 1, out->bytes.size(), f) : 0;
  std::fclose(f);
  return got == out->bytes.size();
}

inline uint32_t rd_u32(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16) | (static_cast<uint32_t>(p[3]) << 24);
}
inline uint16_t rd_u16(const uint8_t* p) {
  return static_cast<uint16_t>(p[0]) | (static_cast<uint16_t>(p[1]) << 8);
}

// Decode sample i of channel 0 from the raw data chunk.
template <typename Fn>
void stream_samples(const uint8_t* raw, int64_t n_frames, int stride_bytes,
                    Fn&& emit) {
  for (int64_t i = 0; i < n_frames; ++i) emit(i, raw + i * stride_bytes);
}

// Chunk-walk + format parse shared by the truncating and full decoders.
struct ParsedWav {
  const uint8_t* raw = nullptr;
  int64_t n_frames = 0;
  int stride = 0;
  uint16_t format = 0;
  uint16_t bits = 0;
  uint32_t rate = 0;
};

int parse_wav(const RawFile& file, ParsedWav* pw) {
  const uint8_t* d = file.bytes.data();
  const size_t n = file.bytes.size();
  if (n < 12 || std::memcmp(d, "RIFF", 4) != 0 || std::memcmp(d + 8, "WAVE", 4) != 0)
    return kErrNotWave;

  const uint8_t* fmt = nullptr;
  size_t fmt_size = 0;
  const uint8_t* raw = nullptr;
  size_t raw_size = 0;
  size_t pos = 12;
  while (pos + 8 <= n) {
    const uint8_t* id = d + pos;
    uint32_t size = rd_u32(d + pos + 4);
    size_t body = pos + 8;
    size_t avail = n > body ? n - body : 0;
    size_t take = size < avail ? size : avail;
    if (std::memcmp(id, "fmt ", 4) == 0) {
      fmt = d + body;
      fmt_size = take;
    } else if (std::memcmp(id, "data", 4) == 0) {
      raw = d + body;
      raw_size = take;
    }
    pos = body + size + (size & 1);  // chunks are word-aligned
  }
  if (!fmt || fmt_size < 16 || !raw) return kErrNoChunks;

  uint16_t format = rd_u16(fmt);
  uint16_t channels = rd_u16(fmt + 2);
  pw->rate = rd_u32(fmt + 4);
  pw->bits = rd_u16(fmt + 14);
  if (format == 0xFFFE && fmt_size >= 26) format = rd_u16(fmt + 24);
  if (channels == 0) return kErrBadFormat;
  pw->format = format;

  int bytes_per_sample = pw->bits / 8;
  pw->stride = bytes_per_sample * channels;
  if (pw->stride == 0) return kErrBadFormat;
  pw->raw = raw;
  pw->n_frames = static_cast<int64_t>(raw_size) / pw->stride;
  return kOk;
}

int decode_one(const char* path, float* out, int64_t buffer_samples,
               float* out_mean, int32_t* out_length, int32_t* out_rate) {
  RawFile file;
  if (!read_file(path, &file)) return kErrOpen;
  ParsedWav pw;
  int prc = parse_wav(file, &pw);
  if (prc != kOk) return prc;
  const uint8_t* raw = pw.raw;
  uint16_t format = pw.format, bits = pw.bits;
  uint32_t rate = pw.rate;
  int stride = pw.stride;
  int64_t n_frames = pw.n_frames;
  int64_t n_keep = n_frames < buffer_samples ? n_frames : buffer_samples;

  double sum = 0.0;
  auto emit = [&](int64_t i, float v) {
    sum += v;
    if (i < n_keep) out[i] = v;
  };

  if (format == 1 && bits == 16 && stride == 2) {  // mono PCM16
    // Fast path for the dominant format (AudioSet/FSD50K dumps are mono
    // PCM16): vectorizable convert+store, multi-accumulator double sum.
    // data chunks are word-aligned, so int16 loads are aligned.
    const int16_t* s = reinterpret_cast<const int16_t*>(raw);
    constexpr float kScale = 1.0f / 32768.0f;
    double acc0 = 0.0, acc1 = 0.0, acc2 = 0.0, acc3 = 0.0;
    int64_t i = 0;
    for (; i + 4 <= n_keep; i += 4) {
      float v0 = s[i] * kScale, v1 = s[i + 1] * kScale;
      float v2 = s[i + 2] * kScale, v3 = s[i + 3] * kScale;
      out[i] = v0;
      out[i + 1] = v1;
      out[i + 2] = v2;
      out[i + 3] = v3;
      acc0 += v0;
      acc1 += v1;
      acc2 += v2;
      acc3 += v3;
    }
    for (; i < n_keep; ++i) {
      float v = s[i] * kScale;
      out[i] = v;
      acc0 += v;
    }
    for (i = n_keep; i + 4 <= n_frames; i += 4) {  // truncated tail: mean only
      acc0 += s[i] * kScale;
      acc1 += s[i + 1] * kScale;
      acc2 += s[i + 2] * kScale;
      acc3 += s[i + 3] * kScale;
    }
    for (; i < n_frames; ++i) acc0 += s[i] * kScale;
    sum = (acc0 + acc1) + (acc2 + acc3);
  } else if (format == 3 && bits == 32) {  // IEEE float
    stream_samples(raw, n_frames, stride, [&](int64_t i, const uint8_t* p) {
      float v;
      std::memcpy(&v, p, 4);
      emit(i, v);
    });
  } else if (format == 3 && bits == 64) {  // IEEE double (e.g. scipy f64)
    stream_samples(raw, n_frames, stride, [&](int64_t i, const uint8_t* p) {
      double v;
      std::memcpy(&v, p, 8);
      emit(i, static_cast<float>(v));
    });
  } else if (format == 1 && bits == 16) {
    stream_samples(raw, n_frames, stride, [&](int64_t i, const uint8_t* p) {
      int16_t v = static_cast<int16_t>(rd_u16(p));
      emit(i, static_cast<float>(v) / 32768.0f);
    });
  } else if (format == 1 && bits == 8) {
    stream_samples(raw, n_frames, stride, [&](int64_t i, const uint8_t* p) {
      emit(i, (static_cast<float>(p[0]) - 128.0f) / 128.0f);
    });
  } else if (format == 1 && bits == 24) {
    stream_samples(raw, n_frames, stride, [&](int64_t i, const uint8_t* p) {
      int32_t v = static_cast<int32_t>(p[0]) | (static_cast<int32_t>(p[1]) << 8) |
                  (static_cast<int32_t>(p[2]) << 16);
      if (v >= (1 << 23)) v -= (1 << 24);
      emit(i, static_cast<float>(v) / 8388608.0f);
    });
  } else if (format == 1 && bits == 32) {
    stream_samples(raw, n_frames, stride, [&](int64_t i, const uint8_t* p) {
      int32_t v = static_cast<int32_t>(rd_u32(p));
      emit(i, static_cast<float>(v) / 2147483648.0f);
    });
  } else {
    return kErrBadFormat;
  }

  if (n_keep < buffer_samples)  // zero the padding tail (callers pass empty)
    std::memset(out + n_keep, 0, (buffer_samples - n_keep) * sizeof(float));
  if (out_mean) *out_mean = n_frames ? static_cast<float>(sum / n_frames) : 0.0f;
  if (out_length) *out_length = static_cast<int32_t>(n_keep);
  if (out_rate) *out_rate = static_cast<int32_t>(rate);
  return kOk;
}

// int16-wire variant of decode_one: fills a raw PCM16 buffer (the
// loader's ExperimentConfig.wire='int16' format, dequantized on-device).
// PCM16 sources copy sample-for-sample with NO float conversion at all
// (the wire is their native representation); other formats decode to
// float and quantize with round-half-to-even (exactly numpy's rint in
// data/loader.py quantize_pcm16). The mean is still accumulated from the
// pre-quantization float samples over the FULL clip, matching the
// float32 decode path bit-for-bit on PCM16 input.
int decode_one_i16(const char* path, int16_t* out, int64_t buffer_samples,
                   float* out_mean, int32_t* out_length, int32_t* out_rate) {
  RawFile file;
  if (!read_file(path, &file)) return kErrOpen;
  ParsedWav pw;
  int prc = parse_wav(file, &pw);
  if (prc != kOk) return prc;
  const uint8_t* raw = pw.raw;
  const int stride = pw.stride;
  const int64_t n_frames = pw.n_frames;
  const int64_t n_keep = n_frames < buffer_samples ? n_frames : buffer_samples;

  double sum = 0.0;
  if (pw.format == 1 && pw.bits == 16 && stride == 2) {  // mono PCM16
    const int16_t* s = reinterpret_cast<const int16_t*>(raw);
    if (n_keep) std::memcpy(out, s, n_keep * sizeof(int16_t));
    int64_t isum = 0;
    for (int64_t i = 0; i < n_frames; ++i) isum += s[i];
    sum = static_cast<double>(isum) / 32768.0;
  } else {
    // generic formats: reuse the float decoders sample-by-sample
    auto emit = [&](int64_t i, float v) {
      sum += v;
      if (i < n_keep) {
        float q = v * 32768.0f;
        if (q > 32767.0f) q = 32767.0f;
        if (q < -32768.0f) q = -32768.0f;
        out[i] = static_cast<int16_t>(std::lrintf(q));  // nearest-even
      }
    };
    if (pw.format == 1 && pw.bits == 16) {
      stream_samples(raw, n_frames, stride, [&](int64_t i, const uint8_t* p) {
        emit(i, static_cast<float>(static_cast<int16_t>(rd_u16(p))) / 32768.0f);
      });
    } else if (pw.format == 3 && pw.bits == 32) {
      stream_samples(raw, n_frames, stride, [&](int64_t i, const uint8_t* p) {
        float v;
        std::memcpy(&v, p, 4);
        emit(i, v);
      });
    } else if (pw.format == 3 && pw.bits == 64) {
      stream_samples(raw, n_frames, stride, [&](int64_t i, const uint8_t* p) {
        double v;
        std::memcpy(&v, p, 8);
        emit(i, static_cast<float>(v));
      });
    } else if (pw.format == 1 && pw.bits == 8) {
      stream_samples(raw, n_frames, stride, [&](int64_t i, const uint8_t* p) {
        emit(i, (static_cast<float>(p[0]) - 128.0f) / 128.0f);
      });
    } else if (pw.format == 1 && pw.bits == 24) {
      stream_samples(raw, n_frames, stride, [&](int64_t i, const uint8_t* p) {
        int32_t v = static_cast<int32_t>(p[0]) |
                    (static_cast<int32_t>(p[1]) << 8) |
                    (static_cast<int32_t>(p[2]) << 16);
        if (v >= (1 << 23)) v -= (1 << 24);
        emit(i, static_cast<float>(v) / 8388608.0f);
      });
    } else if (pw.format == 1 && pw.bits == 32) {
      stream_samples(raw, n_frames, stride, [&](int64_t i, const uint8_t* p) {
        emit(i, static_cast<float>(static_cast<int32_t>(rd_u32(p))) /
                    2147483648.0f);
      });
    } else {
      return kErrBadFormat;
    }
  }

  if (n_keep < buffer_samples)
    std::memset(out + n_keep, 0, (buffer_samples - n_keep) * sizeof(int16_t));
  if (out_mean)
    *out_mean = n_frames ? static_cast<float>(sum / n_frames) : 0.0f;
  if (out_length) *out_length = static_cast<int32_t>(n_keep);
  if (out_rate) *out_rate = static_cast<int32_t>(pw.rate);
  return kOk;
}

}  // namespace

namespace pslanative {

int decode_full(const char* path, std::vector<float>* out, int32_t* rate) {
  RawFile file;
  if (!read_file(path, &file)) return kErrOpen;
  ParsedWav pw;
  int prc = parse_wav(file, &pw);
  if (prc != kOk) return prc;
  out->resize(static_cast<size_t>(pw.n_frames));
  float* o = out->data();
  const uint8_t* raw = pw.raw;
  const int stride = pw.stride;
  if (pw.format == 1 && pw.bits == 16) {
    constexpr float kScale = 1.0f / 32768.0f;
    stream_samples(raw, pw.n_frames, stride, [&](int64_t i, const uint8_t* p) {
      o[i] = static_cast<float>(static_cast<int16_t>(rd_u16(p))) * kScale;
    });
  } else if (pw.format == 3 && pw.bits == 32) {
    stream_samples(raw, pw.n_frames, stride, [&](int64_t i, const uint8_t* p) {
      std::memcpy(&o[i], p, 4);
    });
  } else if (pw.format == 3 && pw.bits == 64) {
    stream_samples(raw, pw.n_frames, stride, [&](int64_t i, const uint8_t* p) {
      double v;
      std::memcpy(&v, p, 8);
      o[i] = static_cast<float>(v);
    });
  } else if (pw.format == 1 && pw.bits == 8) {
    stream_samples(raw, pw.n_frames, stride, [&](int64_t i, const uint8_t* p) {
      o[i] = (static_cast<float>(p[0]) - 128.0f) / 128.0f;
    });
  } else if (pw.format == 1 && pw.bits == 24) {
    stream_samples(raw, pw.n_frames, stride, [&](int64_t i, const uint8_t* p) {
      int32_t v = static_cast<int32_t>(p[0]) | (static_cast<int32_t>(p[1]) << 8) |
                  (static_cast<int32_t>(p[2]) << 16);
      if (v >= (1 << 23)) v -= (1 << 24);
      o[i] = static_cast<float>(v) / 8388608.0f;
    });
  } else if (pw.format == 1 && pw.bits == 32) {
    stream_samples(raw, pw.n_frames, stride, [&](int64_t i, const uint8_t* p) {
      o[i] = static_cast<float>(static_cast<int32_t>(rd_u32(p))) / 2147483648.0f;
    });
  } else {
    return kErrBadFormat;
  }
  if (rate) *rate = static_cast<int32_t>(pw.rate);
  return kOk;
}

}  // namespace pslanative

extern "C" {

// Decode one clip into a float32 buffer (padding tail zero-filled). 0 = ok.
int psla_decode_wav(const char* path, float* out, int64_t buffer_samples,
                    float* out_mean, int32_t* out_length, int32_t* out_rate) {
  return decode_one(path, out, buffer_samples, out_mean, out_length, out_rate);
}

// Decode a batch of clips concurrently into `out` [n, buffer_samples]; each
// row's padding tail is zero-filled by the decoder. Status codes in `status`.
// Returns the number of clips that failed.
int psla_decode_batch(const char** paths, int32_t n, int64_t buffer_samples,
                      float* out, float* means, int32_t* lengths,
                      int32_t* status, int32_t n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int32_t> next{0};
  std::atomic<int32_t> failures{0};
  auto worker = [&]() {
    for (;;) {
      int32_t i = next.fetch_add(1);
      if (i >= n) return;
      int rc = decode_one(paths[i], out + static_cast<int64_t>(i) * buffer_samples,
                          buffer_samples, means ? means + i : nullptr,
                          lengths ? lengths + i : nullptr, nullptr);
      if (status) status[i] = rc;
      if (rc != kOk) failures.fetch_add(1);
    }
  };
  int workers = n_threads < n ? n_threads : n;
  std::vector<std::thread> pool;
  pool.reserve(workers > 1 ? workers - 1 : 0);
  for (int t = 1; t < workers; ++t) pool.emplace_back(worker);
  worker();
  for (auto& th : pool) th.join();
  return failures.load();
}

// Batch decode onto the int16 wire (see decode_one_i16): raw PCM16 rows,
// padding tails zero-filled, full-clip float means. Same contract as
// psla_decode_batch otherwise.
int psla_decode_batch_i16(const char** paths, int32_t n,
                          int64_t buffer_samples, int16_t* out, float* means,
                          int32_t* lengths, int32_t* status,
                          int32_t n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int32_t> next{0};
  std::atomic<int32_t> failures{0};
  auto worker = [&]() {
    for (;;) {
      int32_t i = next.fetch_add(1);
      if (i >= n) return;
      int rc = decode_one_i16(
          paths[i], out + static_cast<int64_t>(i) * buffer_samples,
          buffer_samples, means ? means + i : nullptr,
          lengths ? lengths + i : nullptr, nullptr);
      if (status) status[i] = rc;
      if (rc != kOk) failures.fetch_add(1);
    }
  };
  int workers = n_threads < n ? n_threads : n;
  std::vector<std::thread> pool;
  pool.reserve(workers > 1 ? workers - 1 : 0);
  for (int t = 1; t < workers; ++t) pool.emplace_back(worker);
  worker();
  for (auto& th : pool) th.join();
  return failures.load();
}

}  // extern "C"
