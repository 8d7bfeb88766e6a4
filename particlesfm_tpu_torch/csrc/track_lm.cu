// The tracker's path-consistency refinement for one frame (K2), hand-written
// for Hopper (sm_90a): step 4 of particlesfm_tpu_torch/tracks/engine.py
// run_tracker, that is the three anchor samples and optimize_locations'
// Levenberg-Marquardt solve (tracks/optimize.py), for every pool slot in one
// launch.
//
// It replaces no Pallas kernel: the JAX package leaves this step to XLA
// (particlesfm_tpu/tracks/engine.py, particlesfm_tpu/tracks/optimize.py:179),
// which fuses it. In the port it ran as ~2,600 small torch launches a frame,
// ~80 ms of host time against well under 0.1 ms of device work.
//
// For every slot i with survive[i] && start_time[i] <= f - 1 (one thread a
// slot; other slots are not touched):
//   x0 = prev2[i]; f01, f02, o02 = zero-padded bilinear samples of flow01,
//   flow02, occ02 at x0 (ops/sampling.py bilinear_sample);
//   uv1 = x0 + f01, uv2 = x0 + f02, s = (1 - o02) * (|f02| < upper_flow);
//   p = (prev1[i], new_pos[i]) refined by num_iters LM steps on the residuals
//     r01 = x1 - uv1, r02 = (x2 - uv2) * s, r12 = (x2 - x1) - flow12(x1),
//   flow12 sampled edge-clamped with its Jacobian, from the 6x6 window at
//   floor(prev1) - 2 clipped into the image (`patch`) or from the whole map;
//   prev1[i], new_pos[i] = p.
//
// What bounds it: neither bytes nor operations. A frame of 131,072 slots
// reads ~30 MB of maps and slots and does ~0.2 GFLOP; the flow maps (<= 3.6
// MB each) stay in L2, so the gathers hit it. The time is the latency of each
// thread's serial chain: 13 model evaluations and 12 4x4 Cholesky solves with
// IEEE divisions and square roots, which only enough resident warps hide. So
// everything lives in registers: the 6x6 window is read from the map where a
// sample falls (no [C, 6, 6, 2] patch tensor), the Jacobian's zeros and ones
// are folded into closed-form normal equations, and a slot that is not
// eligible returns at once.
//
// Rounding: the kernel takes the decisions the torch ops take on the card
// (accept cost_c < cost_best, damping, the clamps), so every expression is
// evaluated as those ops evaluate it: one rounding per op, in their order
// (_sum_residuals as its chain of torch.addcmul in residual order, each a
// fused multiply-add as PyTorch's CUDA functor computes it; the cost as a sum
// in residual order; the Cholesky as written), through the round-to-nearest
// intrinsics; the file is compiled with -fmad=false, so nothing else is
// contracted. Terms of the normal equations that the torch ops add as exact
// zeros or multiply by exact ones are left out, which changes no bit.
//
// Plain C interface (bound with ctypes). Returns the cudaError_t of the
// launch.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kPatch = 6;        // tracks/optimize.py _PATCH: the LM's flow window

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}
// torch.addcmul(acc, b, c) on the card: one fused multiply-add, a single
// rounding (its CUDA functor contracts; measured bit for bit on an H100)
__device__ __forceinline__ float addcmul(float acc, float b, float c) {
  return __fmaf_rn(b, c, acc);
}

struct Maps {
  const float* flow12;   // [H, W, 2] flows[f]: the LM's path-consistency flow
  const float* flow01;   // [H, W, 2] flows[f - 1]
  const float* flow02;   // [H, W, 2] flows2[f - 1]
  const float* occ02;    // [H, W]    occs2[f - 1]
  int h, w;
};

// One corner of a zero-padded bilinear sample: the map's value where the
// corner lies inside the image, else 0.
template <int C>
__device__ __forceinline__ void corner(const float* __restrict__ img, int h, int w, float xf,
                                       float yf, float* v) {
  const bool in = xf >= 0.f && xf < (float)w && yf >= 0.f && yf < (float)h;
  const int i = in ? ((int)yf * w + (int)xf) * C : 0;
#pragma unroll
  for (int c = 0; c < C; ++c) v[c] = in ? __ldg(img + i + c) : 0.f;
}

// ops/sampling.py bilinear_sample (zero padding) of a [H, W, C] map at (x, y).
template <int C>
__device__ void sample_zero(const float* __restrict__ img, int h, int w, float x, float y,
                            float* out) {
  const float xf = floorf(x), yf = floorf(y);
  const float dx = sub(x, xf), dy = sub(y, yf);
  const float w00 = mul(sub(1.f, dx), sub(1.f, dy));
  const float w01 = mul(dx, sub(1.f, dy));
  const float w10 = mul(sub(1.f, dx), dy);
  const float w11 = mul(dx, dy);
  float g00[C], g01[C], g10[C], g11[C];
  corner<C>(img, h, w, xf, yf, g00);
  corner<C>(img, h, w, add(xf, 1.f), yf, g01);
  corner<C>(img, h, w, xf, add(yf, 1.f), g10);
  corner<C>(img, h, w, add(xf, 1.f), add(yf, 1.f), g11);
#pragma unroll
  for (int c = 0; c < C; ++c)
    out[c] = add(add(add(mul(w00, g00[c]), mul(w01, g01[c])), mul(w10, g10[c])),
                 mul(w11, g11[c]));
}

// The flow at x1 and the Jacobian rows of r12 = (x2 - x1) - flow12(x1):
// d r12 / d x1 = [[a, b], [c, d]] = -I - d flow12 / d x1.
struct FlowJac {
  float v[2];
  float a, b, c, d;
};

// tracks/optimize.py _patch_sample_and_jac (kPatchLM) or _sample_flow_and_jac,
// then _interp: the edge-clamped bilinear sample, its derivative gated to 0
// along an axis where x1 lies outside the image.
template <bool kPatchLM>
__device__ FlowJac sample_jac(const float* __restrict__ map, int h, int w, int px, int py,
                              float x1, float y1) {
  float x = clampf(x1, 0.f, (float)(w - 1));
  float y = clampf(y1, 0.f, (float)(h - 1));
  int ix, iy;
  float dx, dy;
  if (kPatchLM) {
    x = clampf(sub(x, (float)px), 0.f, (float)(kPatch - 1));
    y = clampf(sub(y, (float)py), 0.f, (float)(kPatch - 1));
    const float x0 = clampf(floorf(x), 0.f, (float)(kPatch - 2));
    const float y0 = clampf(floorf(y), 0.f, (float)(kPatch - 2));
    dx = sub(x, x0);
    dy = sub(y, y0);
    ix = px + (int)x0;
    iy = py + (int)y0;
  } else {
    const float x0 = clampf(floorf(x), 0.f, (float)(w - 2));
    const float y0 = clampf(floorf(y), 0.f, (float)(h - 2));
    dx = sub(x, x0);
    dy = sub(y, y0);
    ix = (int)x0;
    iy = (int)y0;
  }
  const float2* m = reinterpret_cast<const float2*>(map);
  const float2 f00 = __ldg(m + iy * w + ix), f01 = __ldg(m + iy * w + ix + 1);
  const float2 f10 = __ldg(m + (iy + 1) * w + ix), f11 = __ldg(m + (iy + 1) * w + ix + 1);
  const float gx = (x1 >= 0.f && x1 <= (float)w - 1.f) ? 1.f : 0.f;
  const float gy = (y1 >= 0.f && y1 <= (float)h - 1.f) ? 1.f : 0.f;
  const float c00[2] = {f00.x, f00.y}, c01[2] = {f01.x, f01.y};
  const float c10[2] = {f10.x, f10.y}, c11[2] = {f11.x, f11.y};
  float jx[2], jy[2];
  FlowJac r;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const float d01 = sub(c01[c], c00[c]);
    const float d11 = sub(c11[c], c10[c]);
    const float top = add(c00[c], mul(dx, d01));
    const float bot = add(c10[c], mul(dx, d11));
    const float bt = sub(bot, top);
    r.v[c] = add(top, mul(dy, bt));
    jx[c] = mul(add(mul(sub(1.f, dy), d01), mul(dy, d11)), gx);
    jy[c] = mul(bt, gy);
  }
  r.a = sub(-1.f, jx[0]);
  r.b = sub(-0.f, jy[0]);
  r.c = sub(-0.f, jx[1]);
  r.d = sub(-1.f, jy[1]);
  return r;
}

// The model at p: cost, gradient g = J^T r and the entries of J^T J that
// are not exact constants. J's rows are (1,0,0,0), (0,1,0,0), (0,0,s,0),
// (0,0,0,s), (a,b,1,0), (c,d,0,1), so J^T J = [[h00, h10, a, c],
// [h10, h11, b, d], [a, b, h22, 0], [c, d, 0, h22]].
struct Model {
  float cost, g0, g1, g2, g3, h00, h10, h11, h22, a, b, c, d;
};

template <bool kPatchLM>
__device__ Model evaluate(const float* p, float u1x, float u1y, float u2x, float u2y, float s,
                          const Maps& mp, int px, int py) {
  const FlowJac fj = sample_jac<kPatchLM>(mp.flow12, mp.h, mp.w, px, py, p[0], p[1]);
  const float r0 = sub(p[0], u1x), r1 = sub(p[1], u1y);
  const float r2 = mul(sub(p[2], u2x), s), r3 = mul(sub(p[3], u2y), s);
  const float r4 = sub(sub(p[2], p[0]), fj.v[0]);
  const float r5 = sub(sub(p[3], p[1]), fj.v[1]);
  Model m;
  m.cost = add(add(add(add(add(mul(r0, r0), mul(r1, r1)), mul(r2, r2)), mul(r3, r3)),
                   mul(r4, r4)), mul(r5, r5));
  m.g0 = addcmul(addcmul(r0, fj.a, r4), fj.c, r5);
  m.g1 = addcmul(addcmul(r1, fj.b, r4), fj.d, r5);
  m.g2 = add(mul(s, r2), r4);
  m.g3 = add(mul(s, r3), r5);
  m.h00 = addcmul(addcmul(1.f, fj.a, fj.a), fj.c, fj.c);
  m.h10 = addcmul(mul(fj.b, fj.a), fj.d, fj.c);
  m.h11 = addcmul(addcmul(1.f, fj.b, fj.b), fj.d, fj.d);
  m.h22 = add(mul(s, s), 1.f);
  m.a = fj.a;
  m.b = fj.b;
  m.c = fj.c;
  m.d = fj.d;
  return m;
}

__device__ __forceinline__ float sqrt_pos(float v) { return __fsqrt_rn(fmaxf(v, 1e-20f)); }

// tracks/optimize.py _solve4_spd on (J^T J + lam I) x = -g, as written.
__device__ void solve(const Model& m, float lam, float* x) {
  const float a00 = add(m.h00, lam), a11 = add(m.h11, lam), a22 = add(m.h22, lam);
  const float a10 = m.h10, a20 = m.a, a30 = m.c, a21 = m.b, a31 = m.d, a32 = 0.f;
  const float a33 = a22;
  const float g0 = -m.g0, g1 = -m.g1, g2 = -m.g2, g3 = -m.g3;
  const float l00 = sqrt_pos(a00);
  const float l10 = dvd(a10, l00), l20 = dvd(a20, l00), l30 = dvd(a30, l00);
  const float l11 = sqrt_pos(sub(a11, mul(l10, l10)));
  const float l21 = dvd(sub(a21, mul(l20, l10)), l11);
  const float l31 = dvd(sub(a31, mul(l30, l10)), l11);
  const float l22 = sqrt_pos(sub(sub(a22, mul(l20, l20)), mul(l21, l21)));
  const float l32 = dvd(sub(sub(a32, mul(l30, l20)), mul(l31, l21)), l22);
  const float l33 = sqrt_pos(sub(sub(sub(a33, mul(l30, l30)), mul(l31, l31)), mul(l32, l32)));
  const float y0 = dvd(g0, l00);
  const float y1 = dvd(sub(g1, mul(l10, y0)), l11);
  const float y2 = dvd(sub(sub(g2, mul(l20, y0)), mul(l21, y1)), l22);
  const float y3 = dvd(sub(sub(sub(g3, mul(l30, y0)), mul(l31, y1)), mul(l32, y2)), l33);
  x[3] = dvd(y3, l33);
  x[2] = dvd(sub(y2, mul(l32, x[3])), l22);
  x[1] = dvd(sub(sub(y1, mul(l21, x[2])), mul(l31, x[3])), l11);
  x[0] = dvd(sub(sub(sub(y0, mul(l10, x[1])), mul(l20, x[2])), mul(l30, x[3])), l00);
}

template <bool kPatchLM>
__global__ void __launch_bounds__(kThreads)
track_lm_kernel(Maps mp, const float2* __restrict__ prev2, float2* __restrict__ prev1,
                float2* __restrict__ new_pos, const unsigned char* __restrict__ survive,
                const int* __restrict__ start_time, int slots, int frame, float upper_flow,
                int num_iters) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= slots || !survive[i] || start_time[i] > frame - 1) return;

  // the anchors at x0 = prev2 (engine.py step 4)
  const float2 x0 = prev2[i];
  float f01[2], f02[2], o02;
  sample_zero<2>(mp.flow01, mp.h, mp.w, x0.x, x0.y, f01);
  sample_zero<2>(mp.flow02, mp.h, mp.w, x0.x, x0.y, f02);
  sample_zero<1>(mp.occ02, mp.h, mp.w, x0.x, x0.y, &o02);
  const float u1x = add(x0.x, f01[0]), u1y = add(x0.y, f01[1]);
  const float u2x = add(x0.x, f02[0]), u2y = add(x0.y, f02[1]);
  const float norm = __fsqrt_rn(add(mul(f02[0], f02[0]), mul(f02[1], f02[1])));
  const float s = mul(sub(1.f, o02), norm < upper_flow ? 1.f : 0.f);

  // the LM (optimize_locations): the carry holds the best point's model
  const float2 q1 = prev1[i], q2 = new_pos[i];
  float pb[4] = {q1.x, q1.y, q2.x, q2.y};
  int px = 0, py = 0;
  if (kPatchLM) {            // _extract_patches: the window origin, clipped inside the image
    px = min(max((int)floorf(q1.x) - (kPatch / 2 - 1), 0), mp.w - kPatch);
    py = min(max((int)floorf(q1.y) - (kPatch / 2 - 1), 0), mp.h - kPatch);
  }
  Model mb = evaluate<kPatchLM>(pb, u1x, u1y, u2x, u2y, s, mp, px, py);
  float lam = 1e-4f;
  for (int it = 0; it < num_iters; ++it) {
    float step[4], pc[4];
    solve(mb, lam, step);
#pragma unroll
    for (int k = 0; k < 4; ++k) pc[k] = add(pb[k], step[k]);
    const Model mc = evaluate<kPatchLM>(pc, u1x, u1y, u2x, u2y, s, mp, px, py);
    const bool better = mc.cost < mb.cost;
    if (better) {
#pragma unroll
      for (int k = 0; k < 4; ++k) pb[k] = pc[k];
      mb = mc;
    }
    lam = clampf(better ? mul(lam, 0.3f) : mul(lam, 4.f), 1e-8f, 1e6f);
  }
  prev1[i] = make_float2(pb[0], pb[1]);
  new_pos[i] = make_float2(pb[2], pb[3]);
}

}  // namespace

extern "C" int track_lm_launch(const float* flow12, const float* flow01, const float* flow02,
                               const float* occ02, int height, int width, const float* prev2,
                               float* prev1, float* new_pos, const unsigned char* survive,
                               const int* start_time, int slots, int frame, float upper_flow,
                               int num_iters, int patch, void* stream) {
  if (slots < 0 || height < 2 || width < 2 || (patch && (height < kPatch || width < kPatch)))
    return (int)cudaErrorInvalidValue;
  if (slots == 0) return (int)cudaSuccess;
  const Maps mp = {flow12, flow01, flow02, occ02, height, width};
  const int blocks = (slots + kThreads - 1) / kThreads;
  const cudaStream_t s = (cudaStream_t)stream;
  const float2* p2 = reinterpret_cast<const float2*>(prev2);
  float2* p1 = reinterpret_cast<float2*>(prev1);
  float2* np = reinterpret_cast<float2*>(new_pos);
  if (patch)
    track_lm_kernel<true><<<blocks, kThreads, 0, s>>>(mp, p2, p1, np, survive, start_time,
                                                     slots, frame, upper_flow, num_iters);
  else
    track_lm_kernel<false><<<blocks, kThreads, 0, s>>>(mp, p2, p1, np, survive, start_time,
                                                      slots, frame, upper_flow, num_iters);
  return (int)cudaGetLastError();
}
