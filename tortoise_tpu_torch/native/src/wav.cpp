// Mono float32 RIFF/WAVE encoder, format-compatible with the reference's
// writeWav (the reference's main.cpp:4821-4868).

#include <cstdint>
#include <cstring>

namespace {

#pragma pack(push, 1)
struct WavHeader {
  char riff[4];
  uint32_t riff_size;
  char wave[4];
  char fmt[4];
  uint32_t fmt_size;
  uint16_t format;       // 3 = IEEE float
  uint16_t channels;     // 1
  uint32_t sample_rate;
  uint32_t byte_rate;
  uint16_t block_align;
  uint16_t bits;
  char data[4];
  uint32_t data_size;
};
#pragma pack(pop)

static_assert(sizeof(WavHeader) == 44, "unexpected WAV header layout");

}  // namespace

extern "C" {

int64_t wav_encoded_size(int64_t n_samples) {
  return (int64_t)sizeof(WavHeader) + n_samples * 4;
}

int wav_encode(const float* data, int64_t n_samples, int sample_rate,
               char* out) {
  if (!data || !out || n_samples < 0) return 0;
  // RIFF sizes are u32: past ~4 GiB (about 12 hours at 24 kHz f32) the
  // header fields would wrap and readers would drop almost all samples —
  // fail loudly so the caller takes the pure-Python writer's error path
  if (36 + n_samples * 4 > (int64_t)UINT32_MAX) return 0;
  WavHeader h;
  std::memcpy(h.riff, "RIFF", 4);
  h.riff_size = (uint32_t)(36 + n_samples * 4);
  std::memcpy(h.wave, "WAVE", 4);
  std::memcpy(h.fmt, "fmt ", 4);
  h.fmt_size = 16;
  h.format = 3;
  h.channels = 1;
  h.sample_rate = (uint32_t)sample_rate;
  h.byte_rate = (uint32_t)sample_rate * 4;
  h.block_align = 4;
  h.bits = 32;
  std::memcpy(h.data, "data", 4);
  h.data_size = (uint32_t)(n_samples * 4);
  std::memcpy(out, &h, sizeof(h));
  std::memcpy(out + sizeof(h), data, (size_t)n_samples * 4);
  return 1;
}

}  // extern "C"
