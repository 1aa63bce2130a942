// Native WAV codec of the PyTorch port's data pipeline.
//
// The port's own copy of advoc_tpu/data/native/wavio.cc: a dependency-free
// C++ RIFF/WAVE parser and decoder, used by advoc_tpu_torch/data/audioio.py
// through ctypes. It reads PCM 8/16/24/32-bit and IEEE float32/float64,
// downmixes to mono, and decodes a frame slice straight from disk (a random
// crop never decodes the whole file); it writes mono float32 as 16-bit PCM.
//
// Built with g++ at first use into advoc_tpu_torch/_build/ by
// advoc_tpu_torch/data/native/__init__.py.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <vector>

namespace {

struct WavInfo {
  uint16_t format = 0;       // 1 = PCM, 3 = IEEE float
  uint16_t channels = 0;
  uint32_t sample_rate = 0;
  uint16_t bits = 0;
  long data_offset = 0;      // byte offset of sample data
  long data_bytes = 0;       // length of sample data in bytes
};

bool read_header(std::FILE* f, WavInfo* info) {
  char id[4];
  uint32_t riff_size = 0;
  if (std::fread(id, 1, 4, f) != 4 || std::memcmp(id, "RIFF", 4) != 0) return false;
  if (std::fread(&riff_size, 4, 1, f) != 1) return false;
  if (std::fread(id, 1, 4, f) != 4 || std::memcmp(id, "WAVE", 4) != 0) return false;

  bool have_fmt = false, have_data = false;
  while (std::fread(id, 1, 4, f) == 4) {
    uint32_t chunk_size = 0;
    if (std::fread(&chunk_size, 4, 1, f) != 1) return false;
    if (std::memcmp(id, "fmt ", 4) == 0) {
      uint8_t buf[16];
      if (chunk_size < 16 || std::fread(buf, 1, 16, f) != 16) return false;
      std::memcpy(&info->format, buf + 0, 2);
      std::memcpy(&info->channels, buf + 2, 2);
      std::memcpy(&info->sample_rate, buf + 4, 4);
      std::memcpy(&info->bits, buf + 14, 2);
      if (info->format == 0xFFFE) {
        // WAVE_FORMAT_EXTENSIBLE: true format lives in the extension GUID.
        uint8_t ext[24];
        if (chunk_size >= 40 && std::fread(ext, 1, 24, f) == 24) {
          std::memcpy(&info->format, ext + 8, 2);
          if (chunk_size > 40) std::fseek(f, chunk_size - 40, SEEK_CUR);
        } else {
          return false;
        }
      } else if (chunk_size > 16) {
        std::fseek(f, chunk_size - 16, SEEK_CUR);
      }
      have_fmt = true;
    } else if (std::memcmp(id, "data", 4) == 0) {
      info->data_offset = std::ftell(f);
      info->data_bytes = chunk_size;
      have_data = true;
      if (!have_fmt)  // a 'data' chunk may legally precede 'fmt '
        std::fseek(f, chunk_size + (chunk_size & 1), SEEK_CUR);
    } else {
      std::fseek(f, chunk_size + (chunk_size & 1), SEEK_CUR);
    }
    if (have_fmt && have_data) return true;
  }
  return false;
}

inline float sample_to_float(const uint8_t* p, uint16_t format, uint16_t bits) {
  if (format == 3) {  // IEEE float
    if (bits == 32) { float v; std::memcpy(&v, p, 4); return v; }
    if (bits == 64) { double v; std::memcpy(&v, p, 8); return (float)v; }
    return 0.0f;
  }
  switch (bits) {  // PCM
    case 8:  return ((int)p[0] - 128) / 128.0f;
    case 16: { int16_t v; std::memcpy(&v, p, 2); return v / 32768.0f; }
    case 24: {
      int32_t v = (int32_t)((uint32_t)p[0] | ((uint32_t)p[1] << 8) |
                            ((uint32_t)p[2] << 16));
      if (v & 0x800000) v |= 0xFF000000;
      return v / 8388608.0f;
    }
    case 32: { int32_t v; std::memcpy(&v, p, 4); return v / 2147483648.0f; }
    default: return 0.0f;
  }
}

}  // namespace

extern "C" {

// Fills sample_rate/channels/n_frames/bits. Returns 0 on success, <0 on error.
int advoc_wav_info(const char* path, int* sample_rate, int* channels,
                   long* n_frames, int* bits) {
  std::FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  WavInfo info;
  bool ok = read_header(f, &info);
  std::fclose(f);
  if (!ok || info.channels == 0 || info.bits == 0) return -2;
  if (info.format != 1 && info.format != 3) return -3;
  *sample_rate = (int)info.sample_rate;
  *channels = (int)info.channels;
  *bits = (int)info.bits;
  long bytes_per_frame = (long)info.channels * (info.bits / 8);
  *n_frames = info.data_bytes / bytes_per_frame;
  return 0;
}

// Decodes frames [start, start + count) to mono float32 in `out`.
// Returns the number of frames written, or <0 on error. Frames past EOF are
// zero-filled (so fixed-size slice reads never fail at file tails).
long advoc_wav_decode_slice(const char* path, long start, long count,
                            float* out) {
  std::FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  WavInfo info;
  if (!read_header(f, &info) || (info.format != 1 && info.format != 3) ||
      info.channels == 0 || info.bits < 8) {  // bits/channels 0 ⇒ div-by-zero
    std::fclose(f);
    return -2;
  }
  const int bpsamp = info.bits / 8;
  const long bpframe = (long)info.channels * bpsamp;
  const long total = info.data_bytes / bpframe;
  if (start < 0) start = 0;
  long avail = total > start ? total - start : 0;
  long n_read = avail < count ? avail : count;

  std::fseek(f, info.data_offset + start * bpframe, SEEK_SET);
  std::vector<uint8_t> buf((size_t)(n_read > 0 ? n_read : 0) * bpframe);
  if (n_read > 0 && std::fread(buf.data(), 1, buf.size(), f) != buf.size()) {
    std::fclose(f);
    return -3;
  }
  std::fclose(f);

  const float inv_ch = info.channels ? 1.0f / info.channels : 0.0f;
  for (long i = 0; i < n_read; ++i) {
    const uint8_t* fp = buf.data() + (size_t)i * bpframe;
    float acc = 0.0f;
    for (int c = 0; c < info.channels; ++c)
      acc += sample_to_float(fp + (size_t)c * bpsamp, info.format, info.bits);
    out[i] = acc * inv_ch;
  }
  for (long i = n_read; i < count; ++i) out[i] = 0.0f;
  return n_read;
}

// Full-file mono decode into `out` (caller sizes it from advoc_wav_info).
long advoc_wav_decode(const char* path, float* out, long max_frames) {
  return advoc_wav_decode_slice(path, 0, max_frames, out);
}

// Writes mono float32 samples as 16-bit PCM WAV. Returns 0 on success, <0 on
// any short write or close failure (disk full must not look like success —
// the Python caller falls back / raises on nonzero).
int advoc_wav_write(const char* path, const float* samples, long n,
                    int sample_rate) {
  std::FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  uint32_t data_bytes = (uint32_t)(n * 2);
  uint32_t riff_size = 36 + data_bytes;
  uint16_t fmt = 1, ch = 1, bits = 16, block = 2;
  uint32_t sr = (uint32_t)sample_rate, byte_rate = sr * 2;
  uint32_t fmt_size = 16;
  bool ok = true;
  ok &= std::fwrite("RIFF", 1, 4, f) == 4; ok &= std::fwrite(&riff_size, 4, 1, f) == 1;
  ok &= std::fwrite("WAVE", 1, 4, f) == 4;
  ok &= std::fwrite("fmt ", 1, 4, f) == 4; ok &= std::fwrite(&fmt_size, 4, 1, f) == 1;
  ok &= std::fwrite(&fmt, 2, 1, f) == 1; ok &= std::fwrite(&ch, 2, 1, f) == 1;
  ok &= std::fwrite(&sr, 4, 1, f) == 1; ok &= std::fwrite(&byte_rate, 4, 1, f) == 1;
  ok &= std::fwrite(&block, 2, 1, f) == 1; ok &= std::fwrite(&bits, 2, 1, f) == 1;
  ok &= std::fwrite("data", 1, 4, f) == 4; ok &= std::fwrite(&data_bytes, 4, 1, f) == 1;
  std::vector<int16_t> pcm((size_t)n);
  for (long i = 0; i < n; ++i) {
    float v = samples[i];
    if (v > 1.0f) v = 1.0f;
    if (v < -1.0f) v = -1.0f;
    pcm[(size_t)i] = (int16_t)std::lrintf(v * 32767.0f);
  }
  ok &= std::fwrite(pcm.data(), 2, (size_t)n, f) == (size_t)n;
  ok &= std::fclose(f) == 0;
  return ok ? 0 : -2;
}

}  // extern "C"
