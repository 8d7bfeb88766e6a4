// Windowed correlation-pyramid lookup for RAFT, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel particlesfm_tpu/ops/corr_lookup.py
// (_lookup_kernel :29-59, lookup_corr_level_pallas :62-93, looped over levels
// by lookup_corr_pyramid_pallas :96-111) and computes the gather form
// particlesfm_tpu/models/raft.py:101-142 (lookup_corr_gather):
//
//   out[b, p, l*K*K + iy*K + ix] = bilinear sample of pixel p's own level-l
//       correlation map at coords[b, p] / 2^l + (ix - r, iy - r),  K = 2r+1;
//   samples outside the map read 0.
//
// All K*K samples of a (pixel, level) share one fractional offset (wx, wy),
// so, as in the TPU kernel, the window is one (2r+2)^2 block of integer
// samples W blended from four shifted copies:
//   out = (1-wy) * ((1-wx) W[:-1,:-1] + wx W[:-1,1:])
//       +    wy  * ((1-wx) W[1:,:-1]  + wx W[1:,1:]).
//
// What bounds it: bytes. ~13 flops per output (0.24 GFLOP for a block of 8
// pairs at 1024x436, ~3.5 us at the fp32 rate) against 73 MB of output and
// up to 90 MB of windows (~50 us at 3.35 TB/s); the tensor cores have no
// role here. A 2r+2 = 10-float window row starts at any 4-byte offset, so the
// device fetches 2-3 32-byte sectors per 40-byte row: about 1.7x the window
// bytes the bound counts, whatever the kernel does. The design:
// - Radius and level count are template parameters (r, L in 1..4): no
//   run-time integer division, and each level's pointer and shape are read
//   from the kernel parameters at compile-time indices.
// - A persistent block walks tiles of kTile pixels. Each (pixel, level)
//   window is fetched once into shared memory with cp.async into a ring of
//   kStages tiles, so the windows of the next tile are in flight while this
//   one is blended: the counterpart of the TPU kernel's make_async_copy of
//   the window (:49-55). Where every level's rows are 16-byte aligned
//   (Wl % 4 == 0, as on the main path) a window row is copied as 16-byte
//   chunks from the aligned column x0 & ~3 on (3-4 copies instead of 10, no
//   L1 allocation) and the blend reads it shifted by x0 & 3; any other shape
//   takes 4-byte copies. Neighbouring threads copy neighbouring bytes of a
//   row; src-size 0 zero-fills what lies off the map without reading it.
//   (TMA boxes were measured and lost: PERF.md.)
// - The window centre is clamped into [-(r+1), Wl+r] x [-(r+1), Hl+r] before
//   the int conversion, as in the TPU kernel (:40-41): far-out coordinates
//   read exact zeros.
// - One thread blends one output row (2r+1 values) from two window rows into
//   an output tile in shared memory. Windows sit in output order, 4 banks
//   apart, and the output rows a warp writes are an odd number of banks
//   apart. The tile's output is one contiguous run of the result and leaves
//   as coalesced 16-byte streaming stores.
// - Shared memory at r = 4, L = 4 (Cfg<4, 4>::kSmemBytes): 20,736 B of
//   output tile + 2 x 41,984 B of windows + 4,608 B of window parameters =
//   109,312 B per block of 256 threads, so two blocks share an SM.
//
// Plain C interface (bound with ctypes), one launch per block of pairs for
// all levels. Returns the cudaError_t of the launch.

#include <cuda_runtime.h>
#include <atomic>
#include <climits>
#include <cstdint>

namespace {

constexpr int kMaxLevels = 4;
constexpr int kMaxDevices = 64;
constexpr int kThreads = 256;
constexpr int kTile = 16;        // pixels per tile (a multiple of 4: 16-byte stores)
constexpr int kStages = 2;       // tiles of windows in the ring of a block
constexpr int kMinBlocks = 2;    // blocks per SM that the register budget must allow
static_assert(kTile % 4 == 0 && kTile <= kThreads && kStages >= 2, "tile and ring");

struct Pyramid {
  const float* map[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
};

template <int R, int L>
struct Cfg {
  static constexpr int kWin = 2 * R + 2;                    // window side
  static constexpr int kK = 2 * R + 1;                      // output window side
  static constexpr int kC = L * kK * kK;                    // outputs per pixel
  static constexpr int kWins = kTile * L;                   // windows of one tile
  // A window row in shared memory: kWin floats from the 16-byte aligned
  // column x0 & ~3 on, shifted by x0 & 3 (16-byte copies), or from x0 (4-byte
  // copies). Windows are 4 mod 32 banks apart.
  static constexpr int kRowStride = (kWin + 3 + 3) / 4 * 4;
  static constexpr int kChunks = kRowStride / 4;            // 16-byte chunks of a row
  static constexpr int kWinStride = kWin * kRowStride + 4;
  static constexpr int kStageFloats = kWins * kWinStride;
  static constexpr int kBlends = kWins * kK;                // output rows of one tile
  static constexpr int kBlendIters = (kBlends + kThreads - 1) / kThreads;
  static constexpr int kCols = kWins * kWin;                // 4-byte copy tasks of a tile
  static constexpr int kColIters = (kCols + kThreads - 1) / kThreads;
  static constexpr int kVecs = kWins * kChunks;             // 16-byte copy tasks of a tile
  static constexpr int kVecIters = (kVecs + kThreads - 1) / kThreads;
  // shared memory: [output tile][window ring][window params ring][weights ring]
  static constexpr size_t kOutBytes = sizeof(float) * kTile * kC;
  static constexpr size_t kRingBytes = sizeof(float) * kStages * kStageFloats;
  static constexpr size_t kPrmBytes = sizeof(int4) * (kStages + 1) * kWins;
  static constexpr size_t kWtBytes = sizeof(float2) * (kStages + 1) * kWins;
  static constexpr size_t kSmemBytes = kOutBytes + kRingBytes + kPrmBytes + kWtBytes;
  static_assert(kOutBytes % 16 == 0 && kRingBytes % 16 == 0, "16-byte alignment");
};

__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Window of each (pixel q, level l) of a tile, entry q * L + l: {address
// of its first row's first copied column lo, hi, Wl, bits of the rows in the
// map | first in-map column (kVec: chunk) << 16 | end column (chunk) << 20 |
// shift x0 - first copied column << 24} and the weights (wx, wy). Pixels
// past the end copy no rows.
template <int R, int L, bool kVec>
__device__ __forceinline__ void tile_params(const Pyramid& pyr, const float2* __restrict__ coords,
                                            long long n_pix, int tile, int4* prm, float2* wts) {
  constexpr int kWin = 2 * R + 2;
  const int q = threadIdx.x;
  if (q >= kTile) return;
  const long long pix = (long long)tile * kTile + q;
  const bool valid = pix < n_pix;
  const float2 c = valid ? __ldg(coords + pix) : make_float2(0.0f, 0.0f);
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int H = pyr.h[l], W = pyr.w[l];
    const float s = 1.0f / (float)(1 << l);                 // exact: a power of two
    const float cx = fminf(fmaxf(c.x * s, -(R + 1.0f)), (float)W + (float)R);
    const float cy = fminf(fmaxf(c.y * s, -(R + 1.0f)), (float)H + (float)R);
    const float fx = floorf(cx), fy = floorf(cy);
    const int xs = (int)fx - R, ys = (int)fy - R;
    const int xa = kVec ? (xs & ~3) : xs;                   // first copied column
    const int r0 = valid ? min(max(-ys, 0), kWin) : kWin, r1 = min(max(H - ys, 0), kWin);
    const unsigned rows = r1 > r0 ? ((1u << r1) - 1u) & ~((1u << r0) - 1u) : 0u;
    // in-map columns (4-byte copies) or chunks (16-byte; Wl % 4 == 0, so a
    // chunk lies wholly in or out of the map)
    const int c0 = kVec ? min(max(-xa / 4, 0), 15) : min(max(-xs, 0), kWin);
    const int c1 = kVec ? min(max((W - xa) / 4, 0), 15) : min(max(W - xs, 0), kWin);
    const uint64_t src = (uint64_t)(uintptr_t)pyr.map[l] +
                         4ull * (uint64_t)((pix * H + ys) * (long long)W + xa);
    prm[q * L + l] = make_int4((int)(uint32_t)src, (int)(uint32_t)(src >> 32), W,
                               (int)(rows | (unsigned)c0 << 16 | (unsigned)c1 << 20 |
                                     (unsigned)(xs - xa) << 24));
    wts[q * L + l] = make_float2(cx - fx, cy - fy);
  }
}

// Start the copies of a tile's windows into ring stage `dst` (window w at
// offset w * kWinStride, row r at r * kRowStride). kVec: one thread per
// 16-byte chunk of a window row walks its rows (chunks the shifted window
// does not reach are not copied); else one thread per window column. Either
// way neighbouring threads copy neighbouring bytes of a row; `safe` is any
// valid address, for copies that are zero-filled and read from nowhere.
template <int R, int L, bool kVec>
__device__ __forceinline__ void tile_issue(const int4* prm, uint32_t dst, const float* safe) {
  using C = Cfg<R, L>;
  constexpr int kPer = kVec ? C::kChunks : C::kWin;        // tasks per window
  constexpr int kTasks = kVec ? C::kVecs : C::kCols;
  constexpr int kIters = kVec ? C::kVecIters : C::kColIters;
#pragma unroll
  for (int m = 0; m < kIters; ++m) {
    const int j = threadIdx.x + m * kThreads;
    if (kIters * kThreads > kTasks && j >= kTasks) continue;
    const int w = j / kPer;
    const int col = j - w * kPer;
    const int4 p = prm[w];
    if (kVec && 4 * col >= (p.w >> 24) + C::kWin) continue;  // beyond the shifted window
    const bool col_in = col >= ((p.w >> 16) & 0xf) && col < ((p.w >> 20) & 0xf);
    const unsigned rows = col_in ? (unsigned)p.w & 0xffffu : 0u;
    const float* src = reinterpret_cast<const float*>(
        ((uint64_t)(uint32_t)p.y << 32 | (uint32_t)p.x) + (kVec ? 16ull : 4ull) * col);
    const uint32_t d = dst + 4u * (w * C::kWinStride + (kVec ? 4 : 1) * col);
#pragma unroll
    for (int row = 0; row < C::kWin; ++row) {
      const bool ok = (rows >> row) & 1u;
      const float* s = ok ? src + (long long)row * p.z : safe;
      if (kVec)
        cp_async16(d + 4u * row * C::kRowStride, s, ok);
      else
        cp_async4(d + 4u * row * C::kRowStride, s, ok);
    }
  }
}

// Blend a tile's windows into its output tile. Task t: output row iy = t /
// kWins of window w = t % kWins (pixel w / L, level w % L), which starts at
// out_tile[(w*K + iy)*K]; the window row starts x0 & 3 floats into its row.
template <int R, int L>
__device__ __forceinline__ void tile_blend(const float* win, const int4* prm, const float2* wts,
                                           float* out_tile, int n_valid) {
  using C = Cfg<R, L>;
  constexpr int kK = C::kK;
#pragma unroll
  for (int m = 0; m < C::kBlendIters; ++m) {
    const int t = threadIdx.x + m * kThreads;
    if (C::kBlendIters * kThreads > C::kBlends && t >= C::kBlends) continue;
    const int iy = t / C::kWins;
    const int w = t - iy * C::kWins;
    if (w >= n_valid * L) continue;
    const float2 f = wts[w];
    const float* a = win + w * C::kWinStride + iy * C::kRowStride + (prm[w].w >> 24);
    const float* b = a + C::kRowStride;
    float* o = out_tile + (w * kK + iy) * kK;
#pragma unroll
    for (int ix = 0; ix < kK; ++ix) {
      const float h0 = (1.0f - f.x) * a[ix] + f.x * a[ix + 1];
      const float h1 = (1.0f - f.x) * b[ix] + f.x * b[ix + 1];
      o[ix] = (1.0f - f.y) * h0 + f.y * h1;
    }
  }
}

template <int R, int L, bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
corr_lookup_kernel(const Pyramid pyr, const float2* __restrict__ coords, float* __restrict__ out,
                   long long n_pix, int n_tiles) {
  using C = Cfg<R, L>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* out_tile = reinterpret_cast<float*>(smem);
  float* ring = reinterpret_cast<float*>(smem + C::kOutBytes);
  int4* prm = reinterpret_cast<int4*>(smem + C::kOutBytes + C::kRingBytes);
  float2* wts = reinterpret_cast<float2*>(smem + C::kOutBytes + C::kRingBytes + C::kPrmBytes);
  const uint32_t ring_s = (uint32_t)__cvta_generic_to_shared(ring);
  const float* safe = out;                                  // 16-byte aligned
  constexpr int kSlot = C::kWins;                           // params of one tile

  // tiles blockIdx.x + k * gridDim.x, k < n_my (the grid is <= n_tiles)
  const int n_my = (n_tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
#pragma unroll
  for (int s = 0; s < kStages; ++s)
    if (s < n_my)
      tile_params<R, L, kVec>(pyr, coords, n_pix, blockIdx.x + s * gridDim.x,
                        prm + s * kSlot, wts + s * kSlot);
  __syncthreads();
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_my)
      tile_issue<R, L, kVec>(prm + s * kSlot, ring_s + 4u * s * C::kStageFloats, safe);
    cp_async_commit();
  }

  for (int k = 0; k < n_my; ++k) {
    const int tile = blockIdx.x + k * gridDim.x;
    const int nxt = k + kStages - 1;
    if (nxt < n_my)
      tile_issue<R, L, kVec>(prm + (nxt % (kStages + 1)) * kSlot,
                             ring_s + 4u * (nxt % kStages) * C::kStageFloats, safe);
    cp_async_commit();
    cp_async_wait<kStages - 1>();                           // this thread's copies of tile k
    __syncthreads();                                        // everyone's copies; out_tile is free

    const long long first = (long long)tile * kTile;
    const int n_valid = (int)(n_pix - first < kTile ? n_pix - first : kTile);
    const int slot = k % (kStages + 1);
    tile_blend<R, L>(ring + (k % kStages) * C::kStageFloats, prm + slot * kSlot,
                     wts + slot * kSlot, out_tile, n_valid);
    if (k + kStages < n_my)
      tile_params<R, L, kVec>(pyr, coords, n_pix, tile + kStages * gridDim.x,
                        prm + ((k + kStages) % (kStages + 1)) * kSlot,
                        wts + ((k + kStages) % (kStages + 1)) * kSlot);
    __syncthreads();                                        // out_tile written; stage free

    // the tile's output is contiguous and starts 16-byte aligned (kTile % 4 == 0)
    const int n_fl = n_valid * C::kC;
    float* dst = out + first * C::kC;
    const float4* src4 = reinterpret_cast<const float4*>(out_tile);
    for (int f = threadIdx.x; f < n_fl / 4; f += kThreads)
      __stcs(reinterpret_cast<float4*>(dst) + f, src4[f]);
    for (int f = (n_fl / 4) * 4 + threadIdx.x; f < n_fl; f += kThreads)
      __stcs(dst + f, out_tile[f]);
  }
}

struct Call {
  Pyramid pyr;
  const float* coords;
  float* out;
  long long n_pix;
  cudaStream_t stream;
  int device;            // the current device, which owns `stream`
  int* used_vec;         // set to whether the launch took the 16-byte copies
};

// Blocks of the instantiation that fit on `device` at once. The first call
// for an instantiation and device sets the shared-memory attribute and asks
// for the SM count and the occupancy; later calls read the cached count, so a
// launch makes no runtime call but the launch itself.
template <int R, int L, bool kVec>
cudaError_t resident_blocks(int device, int* blocks) {
  static std::atomic<int> cached[kMaxDevices];               // 0: not set up yet
  *blocks = cached[device].load();
  if (*blocks > 0) return cudaSuccess;
  using C = Cfg<R, L>;
  auto kernel = corr_lookup_kernel<R, L, kVec>;
  int sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)C::kSmemBytes);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, C::kSmemBytes);
  if (err != cudaSuccess) return err;
  *blocks = per_sm * sms;
  cached[device].store(*blocks);
  return cudaSuccess;
}

template <int R, int L, bool kVec>
int run_path(const Call& c) {
  int blocks = 0;
  const cudaError_t err = resident_blocks<R, L, kVec>(c.device, &blocks);
  if (err != cudaSuccess) return (int)err;
  const long long n_tiles = (c.n_pix + kTile - 1) / kTile;
  const long long grid = n_tiles < blocks ? n_tiles : blocks;
  corr_lookup_kernel<R, L, kVec><<<(int)(grid > 0 ? grid : 1), kThreads, Cfg<R, L>::kSmemBytes,
                                   c.stream>>>(
      c.pyr, reinterpret_cast<const float2*>(c.coords), c.out, c.n_pix, (int)n_tiles);
  return (int)cudaGetLastError();
}

// 16-byte copies where every level's rows are 16-byte aligned (Wl % 4 == 0,
// as on the main path), 4-byte copies for any other shape.
template <int R, int L>
int run(const Call& c) {
  bool vec = true;
  for (int l = 0; l < L; ++l)
    vec = vec && c.pyr.w[l] % 4 == 0 && reinterpret_cast<uintptr_t>(c.pyr.map[l]) % 16 == 0;
  *c.used_vec = vec;
  return vec ? run_path<R, L, true>(c) : run_path<R, L, false>(c);
}

int dispatch(int radius, int levels, const Call& c) {
#define CORR_LOOKUP_CASE(R, L) if (radius == R && levels == L) return run<R, L>(c);
#define CORR_LOOKUP_RADIUS(R) \
  CORR_LOOKUP_CASE(R, 1) CORR_LOOKUP_CASE(R, 2) CORR_LOOKUP_CASE(R, 3) CORR_LOOKUP_CASE(R, 4)
  CORR_LOOKUP_RADIUS(1) CORR_LOOKUP_RADIUS(2) CORR_LOOKUP_RADIUS(3) CORR_LOOKUP_RADIUS(4)
#undef CORR_LOOKUP_RADIUS
#undef CORR_LOOKUP_CASE
  return (int)cudaErrorInvalidValue;                        // radius or level count
}

}  // namespace

extern "C" int corr_lookup_launch(const float* l0, const float* l1, const float* l2,
                                  const float* l3, int h0, int w0, int h1, int w1,
                                  int h2, int w2, int h3, int w3, int levels,
                                  const float* coords, float* out, long long n_pix,
                                  int radius, void* stream, int device, int* used_vec) {
  if (n_pix < 0 || (n_pix + kTile - 1) / kTile > INT_MAX || device < 0 || device >= kMaxDevices ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 || reinterpret_cast<uintptr_t>(coords) % 8 != 0)
    return (int)cudaErrorInvalidValue;
  *used_vec = 0;
  if (n_pix == 0) return (int)cudaSuccess;
  const Call c = {{{l0, l1, l2, l3}, {h0, h1, h2, h3}, {w0, w1, w2, w3}},
                  coords, out, n_pix, (cudaStream_t)stream, device, used_vec};
  return dispatch(radius, levels, c);
}
