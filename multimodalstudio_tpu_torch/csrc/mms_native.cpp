// Host data path: threaded pixel-batch sampling (JAX reference:
// native/mms_native.cpp), behind a plain C interface that data/native.py
// loads with ctypes, so the build needs no Python headers.
//
// The sampling keeps the reference's streams exactly: the n samples split
// into `threads` contiguous chunks of ceil(n / threads), chunk t drawn by a
// std::mt19937_64 seeded seed + 0x9e3779b97f4a7c15 * (t + 1), each sample
// drawing its frame, then its row, then its column. Equal (seed, threads)
// give the reference's bytes. One thread draws on the calling thread: no
// thread is started.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <random>
#include <thread>
#include <vector>

extern "C" {

// images [F, H, W, C] float32 C-contiguous; mosaick [H, W] int8 or null.
// Writes frame_idx [n] int32, coords [n, 2] float32 (y, x) + pixel_offset,
// pixels [n, C] float32 and channels [n] int32 (0 without a mosaick).
void mms_sample_pixels(const float* img, int64_t F, int64_t H, int64_t W, int64_t C,
                       const int8_t* mosaick, int64_t n, uint64_t seed, int n_threads,
                       double pixel_offset, int32_t* fi, float* co, float* px, int32_t* ch) {
  int workers = n_threads > 0 ? n_threads : 1;
  int64_t chunk = (n + workers - 1) / workers;
  auto draw = [=](int t, int64_t lo, int64_t hi) {
    std::mt19937_64 rng(seed + 0x9e3779b97f4a7c15ULL * (t + 1));
    std::uniform_int_distribution<int64_t> df(0, F - 1), dy(0, H - 1), dx(0, W - 1);
    for (int64_t i = lo; i < hi; ++i) {
      int64_t f = df(rng), y = dy(rng), x = dx(rng);
      fi[i] = static_cast<int32_t>(f);
      co[i * 2 + 0] = static_cast<float>(y) + static_cast<float>(pixel_offset);
      co[i * 2 + 1] = static_cast<float>(x) + static_cast<float>(pixel_offset);
      std::memcpy(px + i * C, img + ((f * H + y) * W + x) * C, C * sizeof(float));
      ch[i] = mosaick ? static_cast<int32_t>(mosaick[y * W + x]) : 0;
    }
  };
  if (workers == 1) {
    draw(0, 0, n);
    return;
  }
  std::vector<std::thread> pool;
  for (int t = 0; t < workers; ++t) {
    int64_t lo = t * chunk, hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    pool.emplace_back(draw, t, lo, hi);
  }
  for (auto& th : pool) th.join();
}

}  // extern "C"
