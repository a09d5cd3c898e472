// Pyramidal Lucas-Kanade tracking, all pyramid levels in one launch.
//
// Replaces the TPU kernel eqvio_tpu/frontend/pallas_klt.py:_klt_kernel_body
// (launched per level by _pallas_klt_call, wrapped by klt_track_level_pallas)
// together with the per-level Python loop of eqvio_tpu/frontend/klt.py
// (track_features, "pallas" mode).  It computes what the gather path
// computes (klt._bilinear / klt._track_level): per feature and per level a
// bilinear win x win template from the previous image with +-1 px central
// difference gradients, the 2x2 normal matrix with |det| floored at 1e-12,
// and `iters` Gauss-Newton steps (no early exit) that sample the next image
// at the current estimate and solve in closed form; err is the mean
// |residual| of the last step of level 0.  Each sample clamps its own
// coordinates to [0, W - 1.001] x [0, H - 1.001] and keeps the gather path's
// weight order, so a sample's value does not depend on where its pixels were
// read from.  The Pallas kernel's aligned VMEM tiles and
// interpolation-as-matmul were TPU mechanics and are not carried over.
//
// Bound on an H100 at the main path's shape (N = 30 features, 4 levels of
// 752x480, win 21, 8 steps): about 19 MFLOP of f32 work (359 operations per
// window sample and level, kernels/klt.py:klt_work) is 0.28 us at
// 67 TFLOP/s, and the 0.5 MB of neighbourhoods it must read is 0.15 us at
// 3.35 TB/s.  Neither is what limits it: each feature is a chain of
// 4 x (1 + 8) dependent window sums, and one Gauss-Newton step (sample,
// sum over the window, 2x2 solve) takes about 0.40 us on the card
// (scripts/klt_timing.py --scan; PERF.md), so the time is the latency of
// that chain.  The design shortens the links it can:
//
// - A feature runs on one block of 8 warps, so the 30 features of the main
//   path spread over 30 SMs (4 warps per feature, or 2 or 4 features per
//   block, measured slower at N = 30: PERF.md).  Each lane holds
//   SPT = ceil(win^2 / 256) samples with their template, gradients and
//   window offsets in registers, and samples them without a branch (a
//   sample past the window sits at the centre and is masked).
// - A window sum is a __shfl_xor_sync butterfly (every lane ends with the
//   same bits) and one shared-memory hop behind a named barrier,
//   double-buffered so one barrier per sum.  No __syncthreads anywhere.
// - At block start, cp.async stages the previous image's (win+3)^2
//   neighbourhood of every level into shared memory (the centres pos / 2^l
//   are known at launch), so no template stage waits on L2.  A tile's corner
//   is clamped into the image, so it holds plain pixels and the per-sample
//   clamp stays the only edge rule.  A window whose footprints leave the
//   tile (a check on its two extreme samples; float rounding of cx + r + 1
//   can push the last column one pixel out) reads global memory, which
//   holds the same values.
// - The next image is read through L1 (__ldg): the window moves by a
//   fraction of a pixel per step, so after the first step the reads hit.
//   A staged (win+3+2M)^2 next-image tile per level, M = 2, 4 or 8,
//   measured slower (PERF.md): its copy, wait and barriers at every level
//   cost more than the L1 hits it replaces, and its in-tile check sits on
//   every step's critical path.
// - cp.async and not TMA: TMA needs 16-byte row strides and 16-byte aligned
//   boxes, but the 94-px level's stride is 376 B and the tiles start at
//   arbitrary pixels.  The 4-byte cp.async.ca form takes any float address.
// - Shared memory per block: 2 x 8 float4 partials and KLT_MAX_LEVELS tiles
//   of at most 35^2 floats (win <= 32) stay under the 48 KB that needs no
//   opt-in.
//
// Lanes (jax.vmap of the Pallas call over B sequences,
// eqvio_tpu/app/run_opt.py:_make_batch_chunk_runner): one launch tracks
// B x N features, one block per (lane, feature), lane = blockIdx.x / N.
// Each level's images are [B, H_l, W_l] with a lane stride of its own (0
// for a pyramid shared by every lane); positions, guesses and outputs are
// [B, N, 2] and [B, N].  A block does the same arithmetic as with one lane,
// so a lane's outputs do not depend on the others, and B = 1 is the
// single-lane launch.

#include <cuda_runtime.h>
#include <stdint.h>

#define KLT_MAX_LEVELS 8
#define KLT_WARPS 8  // warps per feature (= per block)
#define KLT_THREADS (32 * KLT_WARPS)

struct KltPyramid {
  const float* prev[KLT_MAX_LEVELS];
  const float* next[KLT_MAX_LEVELS];
  int height[KLT_MAX_LEVELS];
  int width[KLT_MAX_LEVELS];
  float xmax[KLT_MAX_LEVELS];  // float32(W - 1.001), rounded on the host
  float ymax[KLT_MAX_LEVELS];  // float32(H - 1.001)
  long long prev_lane_stride[KLT_MAX_LEVELS];  // floats from one lane's image to the next
  long long next_lane_stride[KLT_MAX_LEVELS];
  int levels;
};

// A staged tile: image corner and the extent that lies in the image.
struct Tile {
  int x0, y0, w, h;
};

// 2^-l, exact: x * pow2_neg(l) equals x / 2^l bit for bit.
__device__ __forceinline__ float pow2_neg(int l) { return __int_as_float((127 - l) << 23); }

// The tile of pitch `extent` that covers the footprints of samples within
// `reach` px of (cx, cy), corner clamped into the image
// (kernels/klt.py:tile_corner mirrors this).
__device__ __forceinline__ Tile tile_at(float cx, float cy, float reach, int extent, int width,
                                        int height) {
  Tile t;
  t.x0 = max(0, min((int)floorf(cx - reach), width - extent));
  t.y0 = max(0, min((int)floorf(cy - reach), height - extent));
  t.w = min(extent, width);
  t.h = min(extent, height);
  return t;
}

// Whether the clamped 2x2 footprints of all samples with a coordinate in
// [lo, hi] lie within [t0, t0 + extent): clamp and floor are monotone, so
// the two extreme samples decide (kernels/klt.py:window_in_tile mirrors
// this).
__device__ __forceinline__ bool span_in(float lo, float hi, float vmax, int t0, int extent) {
  const int a = (int)floorf(fminf(fmaxf(lo, 0.0f), vmax)) - t0;
  const int b = (int)floorf(fminf(fmaxf(hi, 0.0f), vmax)) - t0;
  return a >= 0 && b <= extent - 2;
}

__device__ __forceinline__ bool window_in(Tile t, float xmax, float ymax, float xlo, float xhi,
                                          float ylo, float yhi) {
  return span_in(xlo, xhi, xmax, t.x0, t.w) && span_in(ylo, yhi, ymax, t.y0, t.h);
}

// The gather path's bilinear weights, in its order.
__device__ __forceinline__ float lerp2(float i00, float i01, float i10, float i11, float fx,
                                       float fy) {
  return i00 * (1.0f - fx) * (1.0f - fy) + i01 * fx * (1.0f - fy) + i10 * (1.0f - fx) * fy +
         i11 * fx * fy;
}

// Bilinear samples with the gather path's per-sample clamp, from a staged
// tile (shared memory) or from the image (read-only global path).  floorf(x)
// is integral, so x - floorf(x) equals x - (float)(int)floorf(x).
struct TileFetch {
  const float* tile;
  int pitch, x0, y0;
  float xmax, ymax;
  __device__ __forceinline__ float operator()(float x, float y) const {
    x = fminf(fmaxf(x, 0.0f), xmax);
    y = fminf(fmaxf(y, 0.0f), ymax);
    const float xf = floorf(x), yf = floorf(y);
    const float* r0 = tile + ((int)yf - y0) * pitch + ((int)xf - x0);
    return lerp2(r0[0], r0[1], r0[pitch], r0[pitch + 1], x - xf, y - yf);
  }
};

struct ImageFetch {
  const float* __restrict__ img;
  int width;
  float xmax, ymax;
  __device__ __forceinline__ float operator()(float x, float y) const {
    x = fminf(fmaxf(x, 0.0f), xmax);
    y = fminf(fmaxf(y, 0.0f), ymax);
    const float xf = floorf(x), yf = floorf(y);
    const float* r0 = img + (int)yf * width + (int)xf;
    return lerp2(__ldg(r0), __ldg(r0 + 1), __ldg(r0 + width), __ldg(r0 + width + 1), x - xf,
                 y - yf);
  }
};

// Template and +-1 px central-difference gradients of this lane's samples;
// samples past the window (k >= win^2) give zeros.
template <int SPT, class Fetch>
__device__ __forceinline__ void template_samples(const Fetch& at, float cx, float cy,
                                                 const float (&ox)[SPT], const float (&oy)[SPT],
                                                 unsigned valid, float (&tm)[SPT],
                                                 float (&gx)[SPT], float (&gy)[SPT]) {
#pragma unroll
  for (int j = 0; j < SPT; ++j) {
    const bool v = (valid >> j) & 1u;
    const float sx = cx + ox[j], sy = cy + oy[j];
    const float t = at(sx, sy);
    const float dx = at(sx + 1.0f, sy) - at(sx - 1.0f, sy);
    const float dy = at(sx, sy + 1.0f) - at(sx, sy - 1.0f);
    tm[j] = v ? t : 0.0f;
    gx[j] = v ? dx : 0.0f;
    gy[j] = v ? dy : 0.0f;
  }
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Named barrier 1 over the block's warps (id 0 is __syncthreads's and is
// never used).
__device__ __forceinline__ void feature_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(KLT_THREADS) : "memory");
}

// Rows of the tile go to the warps in turn, columns to lanes.
__device__ __forceinline__ void stage_tile(float* dst, int pitch, const float* __restrict__ img,
                                           int width, Tile t, int warp, int lane) {
  for (int row = warp; row < t.h; row += KLT_WARPS) {
    const float* src = img + (size_t)(t.y0 + row) * width + t.x0;
    float* d = dst + row * pitch;
    for (int col = lane; col < t.w; col += 32) cp_async4(d + col, src + col);
  }
}

// Sum three values over the block: a __shfl_xor_sync butterfly (every lane
// ends with the same bits), then one shared-memory hop whose partials every
// thread adds in the same order.  `red` holds two buffers of KLT_WARPS
// partials, used in turn, so one barrier per sum suffices.
__device__ __forceinline__ void block_sum3(float& a, float& b, float& c, float4* red,
                                           int& parity, int warp, int lane) {
  const unsigned full = 0xffffffffu;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(full, a, off);
    b += __shfl_xor_sync(full, b, off);
    c += __shfl_xor_sync(full, c, off);
  }
  float4* buf = red + parity * KLT_WARPS;
  parity ^= 1;
  if (lane == 0) buf[warp] = make_float4(a, b, c, 0.0f);
  feature_sync();
  float4 v = buf[0];
  a = v.x;
  b = v.y;
  c = v.z;
#pragma unroll
  for (int w = 1; w < KLT_WARPS; ++w) {
    v = buf[w];
    a += v.x;
    b += v.y;
    c += v.z;
  }
}

// One block per (lane, feature): block f tracks feature f % n of lane
// f / n.  Shared memory: [2 x KLT_WARPS float4 partials] [the prev tile of
// each level, pitch win + 3].
template <int SPT>
__global__ void __launch_bounds__(KLT_THREADS)
klt_pyramid_kernel(KltPyramid pyr, const float* __restrict__ pos, const float* __restrict__ guess,
                   float* __restrict__ out_pos, float* __restrict__ out_err, int n, int win, int iters) {
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int f = blockIdx.x;
  const long long seq = f / n;  // the sequence lane of this block
  float4* red = smem4;
  float* prev_tiles = reinterpret_cast<float*>(red + 2 * KLT_WARPS);
  const int tprev = win + 3;
  const int tprev2 = tprev * tprev;

  const int nsamp = win * win;
  const float r = (float)(win - 1) * 0.5f;
  // sample k = (row k / win, column k % win) sits at centre + (col - r, row - r);
  // a sample past the window sits at the centre and is masked out
  float ox[SPT], oy[SPT];
  unsigned valid = 0u;
#pragma unroll
  for (int j = 0; j < SPT; ++j) {
    const int k = threadIdx.x + KLT_THREADS * j;
    ox[j] = k < nsamp ? (float)(k % win) - r : 0.0f;
    oy[j] = k < nsamp ? (float)(k / win) - r : 0.0f;
    if (k < nsamp) valid |= 1u << j;
  }
  const float reach = r + 1.0f;

  const float posx = pos[2 * f], posy = pos[2 * f + 1];
  const int top = pyr.levels - 1;
  float px = guess[2 * f] * pow2_neg(top);
  float py = guess[2 * f + 1] * pow2_neg(top);

  // every level's prev tile: the centres are known at launch
  for (int l = top; l >= 0; --l) {
    const int w = pyr.width[l], h = pyr.height[l];
    stage_tile(prev_tiles + l * tprev2, tprev, pyr.prev[l] + seq * pyr.prev_lane_stride[l], w,
               tile_at(posx * pow2_neg(l), posy * pow2_neg(l), reach, tprev, w, h), warp, lane);
  }
  cp_async_commit_wait_all();
  feature_sync();

  int parity = 0;
  float ad = 0.0f;
  for (int lvl = top; lvl >= 0; --lvl) {
    const int w = pyr.width[lvl], h = pyr.height[lvl];
    const float xmax = pyr.xmax[lvl], ymax = pyr.ymax[lvl];
    const float* prev = pyr.prev[lvl] + seq * pyr.prev_lane_stride[lvl];
    const float* next = pyr.next[lvl] + seq * pyr.next_lane_stride[lvl];
    const float cx = posx * pow2_neg(lvl), cy = posy * pow2_neg(lvl);
    if (lvl < top) {
      px *= 2.0f;
      py *= 2.0f;
    }

    // template and gradients: samples at (cx + ox) +- 1 and (cy + oy) +- 1
    const Tile tp = tile_at(cx, cy, reach, tprev, w, h);
    float tm[SPT], gx[SPT], gy[SPT];
    if (window_in(tp, xmax, ymax, (cx + (-r)) - 1.0f, (cx + r) + 1.0f, (cy + (-r)) - 1.0f,
                  (cy + r) + 1.0f))
      template_samples<SPT>(TileFetch{prev_tiles + lvl * tprev2, tprev, tp.x0, tp.y0, xmax, ymax},
                            cx, cy, ox, oy, valid, tm, gx, gy);
    else
      template_samples<SPT>(ImageFetch{prev, w, xmax, ymax}, cx, cy, ox, oy, valid, tm, gx, gy);
    float sxx = 0.0f, sxy = 0.0f, syy = 0.0f;
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      sxx += gx[j] * gx[j];
      sxy += gx[j] * gy[j];
      syy += gy[j] * gy[j];
    }
    block_sum3(sxx, sxy, syy, red, parity, warp, lane);
    float det = sxx * syy - sxy * sxy;
    if (fabsf(det) < 1e-12f) det = 1e-12f;

    // Gauss-Newton steps: sum d * gx, sum d * gy and sum |d| with d the
    // residual at (px, py)
    const ImageFetch at{next, w, xmax, ymax};
    for (int it = 0; it < iters; ++it) {
      float bx = 0.0f, by = 0.0f;
      ad = 0.0f;
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        const float res = at(px + ox[j], py + oy[j]) - tm[j];
        const float d = (valid >> j) & 1u ? res : 0.0f;
        bx += d * gx[j];
        by += d * gy[j];
        ad += fabsf(d);
      }
      block_sum3(bx, by, ad, red, parity, warp, lane);
      const float dx = (syy * bx - sxy * by) / det;
      const float dy = (sxx * by - sxy * bx) / det;
      px -= dx;
      py -= dy;
    }
  }
  if (threadIdx.x == 0) {
    out_pos[2 * f] = px;
    out_pos[2 * f + 1] = py;
    out_err[f] = ad / (float)nsamp;  // mean |residual| of level 0's last step
  }
}

template <int SPT>
static int launch(const KltPyramid& pyr, const float* pos, const float* guess, float* out_pos,
                  float* out_err, int lanes, int n, int win, int iters, cudaStream_t stream) {
  const size_t smem = (2 * KLT_WARPS * 4 + (size_t)pyr.levels * (win + 3) * (win + 3)) * sizeof(float);
  klt_pyramid_kernel<SPT><<<lanes * n, KLT_THREADS, smem, stream>>>(pyr, pos, guess, out_pos, out_err,
                                                                    n, win, iters);
  return (int)cudaGetLastError();
}

// C entry point for ctypes: `lanes` sequences of `n` features in one
// launch.  Pointers are device pointers except the six per-level host
// arrays; level l of lane b starts at prev_ptrs[l] + b * prev_strides[l]
// floats (next likewise).  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int klt_track_pyramid_lanes_f32(const uint64_t* prev_ptrs, const uint64_t* next_ptrs,
                                           const long long* prev_strides,
                                           const long long* next_strides, const int* heights,
                                           const int* widths, int levels, int lanes,
                                           const float* pos, const float* guess, float* out_pos,
                                           float* out_err, int n, int win, int iters, void* stream) {
  if (levels < 1 || levels > KLT_MAX_LEVELS || lanes < 1 || n < 1 || (long long)lanes * n > 2147483647LL ||
      win < 1 || win * win > 1024 || iters < 1)
    return (int)cudaErrorInvalidValue;
  KltPyramid pyr;
  for (int l = 0; l < levels; ++l) {
    if (heights[l] < 2 || widths[l] < 2 || prev_strides[l] < 0 || next_strides[l] < 0)
      return (int)cudaErrorInvalidValue;
    pyr.prev[l] = reinterpret_cast<const float*>(prev_ptrs[l]);
    pyr.next[l] = reinterpret_cast<const float*>(next_ptrs[l]);
    pyr.prev_lane_stride[l] = prev_strides[l];
    pyr.next_lane_stride[l] = next_strides[l];
    pyr.height[l] = heights[l];
    pyr.width[l] = widths[l];
    pyr.xmax[l] = (float)((double)widths[l] - 1.001);
    pyr.ymax[l] = (float)((double)heights[l] - 1.001);
  }
  pyr.levels = levels;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // samples per lane: the least of 1, 2, 4 that covers the window
  const int need = (win * win + KLT_THREADS - 1) / KLT_THREADS;
  if (need <= 1) return launch<1>(pyr, pos, guess, out_pos, out_err, lanes, n, win, iters, st);
  if (need <= 2) return launch<2>(pyr, pos, guess, out_pos, out_err, lanes, n, win, iters, st);
  return launch<4>(pyr, pos, guess, out_pos, out_err, lanes, n, win, iters, st);
}

// The single-sequence entry of the earlier releases: one lane.
extern "C" int klt_track_pyramid_f32(const uint64_t* prev_ptrs, const uint64_t* next_ptrs,
                                     const int* heights, const int* widths, int levels,
                                     const float* pos, const float* guess, float* out_pos,
                                     float* out_err, int n, int win, int iters, void* stream) {
  if (levels < 1 || levels > KLT_MAX_LEVELS) return (int)cudaErrorInvalidValue;
  const long long zero[KLT_MAX_LEVELS] = {0, 0, 0, 0, 0, 0, 0, 0};
  return klt_track_pyramid_lanes_f32(prev_ptrs, next_ptrs, zero, zero, heights, widths, levels, 1,
                                     pos, guess, out_pos, out_err, n, win, iters, stream);
}
