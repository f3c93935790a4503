// Exact reproduction of the reference's host RNG plane: a process
// std::mt19937 consumed by std::uniform_real_distribution<float> (sampling)
// and std::normal_distribution<double> (all noise), including restoring the
// serialized engine/distribution state used by the seeded regression tests
// (the reference's main.cpp:39-50, 6260-6265).
//
// Compiled with the system libstdc++, so the distribution algorithms are the
// real thing rather than a re-implementation; the pure-Python fallback in
// tortoise_tpu/rng is validated against streams produced by this code.

#include <cstdint>
#include <random>
#include <sstream>
#include <string>

namespace {

struct StdRng {
  std::mt19937 gen;
  std::uniform_real_distribution<float> uniform{0.0f, 1.0f};
  std::normal_distribution<double> normal{0.0, 1.0};
  explicit StdRng(uint64_t seed) : gen((uint32_t)seed) {}
};

}  // namespace

extern "C" {

void* stdrng_new(uint64_t seed) { return new StdRng(seed); }

void stdrng_free(void* h) { delete static_cast<StdRng*>(h); }

int stdrng_load_state(void* h, const char* text) {
  auto* rng = static_cast<StdRng*>(h);
  std::istringstream in(text);
  in >> rng->gen;
  return in.fail() ? 0 : 1;
}

int stdrng_load_normal_state(void* h, const char* text) {
  auto* rng = static_cast<StdRng*>(h);
  std::istringstream in(text);
  in >> rng->normal;
  return in.fail() ? 0 : 1;
}

int stdrng_raw_u32(void* h, uint32_t* out, int64_t n) {
  auto* rng = static_cast<StdRng*>(h);
  for (int64_t i = 0; i < n; ++i) out[i] = rng->gen();
  return 1;
}

int stdrng_uniform_float(void* h, float* out, int64_t n) {
  auto* rng = static_cast<StdRng*>(h);
  for (int64_t i = 0; i < n; ++i) out[i] = rng->uniform(rng->gen);
  return 1;
}

int stdrng_normal_double(void* h, double* out, int64_t n) {
  auto* rng = static_cast<StdRng*>(h);
  for (int64_t i = 0; i < n; ++i) out[i] = rng->normal(rng->gen);
  return 1;
}

}  // extern "C"
