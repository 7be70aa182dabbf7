// reazonspeech_tpu native host-side kernels (C++17, no external deps).
//
// The reference delegates these to external native packages (SURVEY.md §2.2):
// editdistance (C++) for CER, libsndfile/librosa (C) for PCM decode, and its
// pure-Python MPEG-TS scan is flagged as a C++ candidate for corpus-building
// throughput (SURVEY.md §2.1 O1). Exposed via a plain C ABI for ctypes.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Levenshtein distance over UTF-32 code points (matches editdistance.eval
// and the reference's Wagner-Fischer, pkg/espnet-oneseg/src/text.py:16-32).
int64_t rs_edit_distance(const uint32_t* a, int64_t na, const uint32_t* b,
                         int64_t nb) {
  if (na == 0) return nb;
  if (nb == 0) return na;
  std::vector<int64_t> prev(nb + 1), cur(nb + 1);
  for (int64_t j = 0; j <= nb; ++j) prev[j] = j;
  for (int64_t i = 1; i <= na; ++i) {
    cur[0] = i;
    const uint32_t ai = a[i - 1];
    for (int64_t j = 1; j <= nb; ++j) {
      if (ai == b[j - 1]) {
        cur[j] = prev[j - 1];
      } else {
        cur[j] = std::min({prev[j], cur[j - 1], prev[j - 1]}) + 1;
      }
    }
    std::swap(prev, cur);
  }
  return prev[nb];
}

// PCM int16 -> float32 (the hot loop of WAV decode).
void rs_pcm16_to_f32(const int16_t* in, int64_t n, float* out) {
  constexpr float kScale = 1.0f / 32768.0f;
  for (int64_t i = 0; i < n; ++i) out[i] = in[i] * kScale;
}

// PCM int24 (packed 3-byte little-endian) -> float32.
void rs_pcm24_to_f32(const uint8_t* in, int64_t n_samples, float* out) {
  constexpr float kScale = 1.0f / 8388608.0f;
  for (int64_t i = 0; i < n_samples; ++i) {
    const uint8_t* p = in + 3 * i;
    int32_t v = p[0] | (p[1] << 8) | (p[2] << 16);
    if (v & 0x800000) v -= 0x1000000;
    out[i] = v * kScale;
  }
}

// MPEG-TS scan: find 188-byte-aligned packets of a given PID with PUSI set.
// Writes packet byte-offsets into `offsets` (capacity `max_out`), returns the
// count. A fast pre-filter for the Python caption demuxer: only caption-PID
// payload starts cross back into Python.
int64_t rs_ts_scan_pid(const uint8_t* data, int64_t size, int32_t pid,
                       int32_t require_pusi, int64_t* offsets,
                       int64_t max_out) {
  int64_t count = 0;
  for (int64_t pos = 0; pos + 188 <= size; pos += 188) {
    const uint8_t* pkt = data + pos;
    if (pkt[0] != 0x47) continue;
    int32_t p = ((pkt[1] & 0x1F) << 8) | pkt[2];
    if (p != pid) continue;
    if (require_pusi && !(pkt[1] & 0x40)) continue;
    if (count < max_out) offsets[count] = pos;
    ++count;
  }
  return count;
}

// Downmix interleaved multichannel float32 to mono (mean over channels).
void rs_downmix_mean(const float* in, int64_t frames, int32_t channels,
                     float* out) {
  const float inv = 1.0f / channels;
  for (int64_t i = 0; i < frames; ++i) {
    float acc = 0.0f;
    const float* p = in + i * channels;
    for (int32_t c = 0; c < channels; ++c) acc += p[c];
    out[i] = acc * inv;
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Batched WAV loading (the training data loader's hot path).
//
// RIFF/WAVE parse for PCM16/PCM24/PCM32/IEEE-float32, any channel count
// (downmixed to mono by mean). Two-phase API: rs_wav_info reads only the
// header (cheap; the Python side sizes the padded batch buffer), then
// rs_wav_batch_load decodes all files concurrently on a thread pool into
// caller-provided rows. Errors are per-file: a failed row reports length -1
// and the caller falls back to the Python decoder for that file.

namespace {

struct WavFmt {
  uint16_t format = 0;
  uint16_t channels = 0;
  uint32_t sample_rate = 0;
  uint16_t bits = 0;
  long long data_off = -1;
  long long data_len = 0;
};

bool read_wav_header(FILE* f, WavFmt* out) {
  uint8_t hdr[12];
  if (fread(hdr, 1, 12, f) != 12) return false;
  if (memcmp(hdr, "RIFF", 4) != 0 || memcmp(hdr + 8, "WAVE", 4) != 0)
    return false;
  uint8_t ck[8];
  while (fread(ck, 1, 8, f) == 8) {
    uint32_t len = ck[4] | (ck[5] << 8) | (ck[6] << 16) |
                   (static_cast<uint32_t>(ck[7]) << 24);
    if (memcmp(ck, "fmt ", 4) == 0) {
      uint8_t fmt[16];
      if (len < 16 || fread(fmt, 1, 16, f) != 16) return false;
      out->format = fmt[0] | (fmt[1] << 8);
      out->channels = fmt[2] | (fmt[3] << 8);
      out->sample_rate = fmt[4] | (fmt[5] << 8) | (fmt[6] << 16) |
                         (static_cast<uint32_t>(fmt[7]) << 24);
      out->bits = fmt[14] | (fmt[15] << 8);
      if (len > 16 && fseek(f, len - 16 + (len & 1), SEEK_CUR) != 0)
        return false;
    } else if (memcmp(ck, "data", 4) == 0) {
      out->data_off = ftell(f);
      out->data_len = len;
      if (fseek(f, len + (len & 1), SEEK_CUR) != 0) break;
    } else {
      if (fseek(f, len + (len & 1), SEEK_CUR) != 0) break;
    }
  }
  return out->data_off >= 0 && out->channels > 0 && out->bits > 0;
}

long long wav_frames(const WavFmt& fmt) {
  return fmt.data_len / (fmt.channels * (fmt.bits / 8));
}

// decode one file into out (mono mean-downmix); returns frame count or -1
long long decode_wav(const char* path, float* out, long long cap) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavFmt fmt;
  if (!read_wav_header(f, &fmt)) {
    fclose(f);
    return -1;
  }
  const long long frames = std::min<long long>(wav_frames(fmt), cap);
  const int ch = fmt.channels;
  const long long bytes = frames * ch * (fmt.bits / 8);
  std::vector<uint8_t> raw(bytes);
  if (fseek(f, fmt.data_off, SEEK_SET) != 0 ||
      fread(raw.data(), 1, bytes, f) != static_cast<size_t>(bytes)) {
    fclose(f);
    return -1;
  }
  fclose(f);

  const float inv_ch = 1.0f / ch;
  if (fmt.format == 1 && fmt.bits == 16) {
    const int16_t* p = reinterpret_cast<const int16_t*>(raw.data());
    constexpr float kS = 1.0f / 32768.0f;
    for (long long i = 0; i < frames; ++i) {
      float acc = 0.0f;
      for (int c = 0; c < ch; ++c) acc += p[i * ch + c];
      out[i] = acc * kS * inv_ch;
    }
  } else if (fmt.format == 1 && fmt.bits == 24) {
    constexpr float kS = 1.0f / 8388608.0f;
    for (long long i = 0; i < frames; ++i) {
      float acc = 0.0f;
      for (int c = 0; c < ch; ++c) {
        const uint8_t* b = raw.data() + 3 * (i * ch + c);
        int32_t v = b[0] | (b[1] << 8) | (b[2] << 16);
        if (v & 0x800000) v -= 0x1000000;
        acc += static_cast<float>(v);
      }
      out[i] = acc * kS * inv_ch;
    }
  } else if (fmt.format == 1 && fmt.bits == 32) {
    const int32_t* p = reinterpret_cast<const int32_t*>(raw.data());
    constexpr float kS = 1.0f / 2147483648.0f;
    for (long long i = 0; i < frames; ++i) {
      float acc = 0.0f;
      for (int c = 0; c < ch; ++c) acc += p[i * ch + c] * kS;
      out[i] = acc * inv_ch;
    }
  } else if (fmt.format == 3 && fmt.bits == 32) {
    const float* p = reinterpret_cast<const float*>(raw.data());
    for (long long i = 0; i < frames; ++i) {
      float acc = 0.0f;
      for (int c = 0; c < ch; ++c) acc += p[i * ch + c];
      out[i] = acc * inv_ch;
    }
  } else {
    return -1;
  }
  return frames;
}

}  // namespace

extern "C" {

// Header-only probe: sample rate + mono frame count (for batch sizing).
int32_t rs_wav_info(const char* path, int32_t* sample_rate,
                    int64_t* n_frames) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavFmt fmt;
  const bool ok = read_wav_header(f, &fmt);
  fclose(f);
  if (!ok) return -1;
  *sample_rate = static_cast<int32_t>(fmt.sample_rate);
  *n_frames = wav_frames(fmt);
  return 0;
}

// Decode n files concurrently into out rows (row i at out + i*stride,
// zero-padded by the CALLER); lengths[i] = frames decoded or -1 on error.
void rs_wav_batch_load(const char** paths, int32_t n, float* out,
                       int64_t stride, int64_t* lengths,
                       int32_t num_threads) {
  std::atomic<int32_t> next(0);
  auto worker = [&]() {
    for (;;) {
      const int32_t i = next.fetch_add(1);
      if (i >= n) return;
      lengths[i] = decode_wav(paths[i], out + i * stride, stride);
    }
  };
  const int32_t nt = std::max(1, std::min(num_threads, n));
  std::vector<std::thread> pool;
  for (int32_t t = 0; t < nt; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

}  // extern "C"
