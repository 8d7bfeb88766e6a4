// Windowed correlation-pyramid lookup for RAFT, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel particlesfm_tpu/ops/corr_lookup.py
// (_lookup_kernel :29-59, lookup_corr_level_pallas :62-93, looped over levels
// by lookup_corr_pyramid_pallas :96-111) and computes exactly the gather form
// particlesfm_tpu/models/raft.py:101-142 (lookup_corr_gather):
//
//   out[b, p, l*K + iy*W + ix] = bilinear sample of pixel p's own level-l
//       correlation map at coords[b, p] / 2^l + (ix - r, iy - r),
//   W = 2r+1, K = W*W; each of the four corners carries its own validity
//   mask, so samples outside the map read 0.
//
// What bounds it: bytes. Each output element costs ~10 flops; the kernel has
// to write B*P*L*K floats (73 MB for a block of 8 pairs at 1024x436) and read
// each pixel's (2r+2)^2 window per level (<= 90 MB), i.e. ~50 us at
// 3.35 TB/s. The design keeps it simple: one thread per output element, with
// the output's channel axis innermost, so consecutive threads write
// consecutive addresses and read neighbouring addresses of one pixel's
// window (L1 serves the 4-corner re-reads). Bounds are checked per corner in
// the kernel instead of zero-padding every level, which the TPU kernel did
// with a full copy of the 198 MB level per call.
//
// Plain C interface (bound with ctypes), one launch per block of pairs for
// all levels. Returns the cudaError_t of the launch.

#include <cuda_runtime.h>
#include <climits>

#define MAX_LEVELS 4

struct Pyramid {
  const float* l0; const float* l1; const float* l2; const float* l3;
  int h0, w0, h1, w1, h2, w2, h3, w3;
};

__device__ __forceinline__ float corner(const float* __restrict__ map, int H, int W,
                                        int y, int x) {
  return (x >= 0 && x < W && y >= 0 && y < H) ? __ldg(map + y * W + x) : 0.0f;
}

// n_pix * channels < 2^31 (checked by the launcher): 32-bit index math. The
// level's pointer and shape are picked with branches, not by indexing arrays
// in the kernel parameters, which would copy them to local memory.
__global__ void corr_lookup_kernel(Pyramid pyr, const float* __restrict__ coords,
                                   float* __restrict__ out, int n_pix,
                                   int levels, int radius) {
  const int win = 2 * radius + 1;
  const int per_level = win * win;
  const int channels = levels * per_level;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_pix * channels) return;
  const int pix = idx / channels;
  const int k = idx - pix * channels;
  const int lvl = k / per_level;
  const int j = k - lvl * per_level;
  const int iy = j / win;
  const int ix = j - iy * win;

  const float* base = pyr.l0;
  int H = pyr.h0, W = pyr.w0;
  if (lvl == 1) { base = pyr.l1; H = pyr.h1; W = pyr.w1; }
  else if (lvl == 2) { base = pyr.l2; H = pyr.h2; W = pyr.w2; }
  else if (lvl == 3) { base = pyr.l3; H = pyr.h3; W = pyr.w3; }

  const float div = (float)(1 << lvl);
  const float x = __ldg(coords + 2 * pix) / div + (float)(ix - radius);
  const float y = __ldg(coords + 2 * pix + 1) / div + (float)(iy - radius);
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const float wx = x - x0;
  const float wy = y - y0;
  // clamp before the int conversion: far-out coordinates keep both corners
  // out of range instead of overflowing
  const int xi = (int)fmaxf(fminf(x0, (float)W + 1.0f), -2.0f);
  const int yi = (int)fmaxf(fminf(y0, (float)H + 1.0f), -2.0f);
  const float* __restrict__ map = base + (long long)pix * (H * W);

  out[idx] = (1.0f - wx) * (1.0f - wy) * corner(map, H, W, yi, xi)
           + wx * (1.0f - wy) * corner(map, H, W, yi, xi + 1)
           + (1.0f - wx) * wy * corner(map, H, W, yi + 1, xi)
           + wx * wy * corner(map, H, W, yi + 1, xi + 1);
}

extern "C" int corr_lookup_launch(const float* l0, const float* l1, const float* l2,
                                  const float* l3, int h0, int w0, int h1, int w1,
                                  int h2, int w2, int h3, int w3, int levels,
                                  const float* coords, float* out, long long n_pix,
                                  int radius, void* stream) {
  if (levels < 1 || levels > MAX_LEVELS || radius < 0 || n_pix < 0)
    return (int)cudaErrorInvalidValue;
  const Pyramid pyr = {l0, l1, l2, l3, h0, w0, h1, w1, h2, w2, h3, w3};
  const long long total = n_pix * levels * (2 * radius + 1) * (2 * radius + 1);
  if (total == 0) return (int)cudaSuccess;
  if (total > INT_MAX) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const int blocks = (int)((total + threads - 1) / threads);
  corr_lookup_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      pyr, coords, out, (int)n_pix, levels, radius);
  return (int)cudaGetLastError();
}
