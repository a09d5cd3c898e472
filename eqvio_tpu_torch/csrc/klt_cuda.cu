// Pyramidal Lucas-Kanade tracking, all pyramid levels in one launch.
//
// Replaces the TPU kernel eqvio_tpu/frontend/pallas_klt.py:_klt_kernel_body
// (launched per level by _pallas_klt_call, wrapped by klt_track_level_pallas)
// together with the per-level Python loop of eqvio_tpu/frontend/klt.py
// (track_features, "pallas" mode).  It computes what the gather path
// computes (klt._bilinear / klt._track_level): per feature and per level a
// bilinear win x win template from the previous image with +-1 px central
// difference gradients, the 2x2 normal matrix with |det| floored at 1e-12,
// and `iters` Gauss-Newton steps that sample the next image at the current
// estimate and solve in closed form; err is the mean |residual| of the last
// step.  Each sample clamps its own coordinates to [0, W - 1.001] x
// [0, H - 1.001] (edge replication), so no padding and no block corners: the
// Pallas kernel's aligned VMEM tiles and interpolation-as-matmul were TPU
// mechanics and are not carried over.
//
// Layout: one block per feature, one thread per window sample (win = 21 ->
// 441 samples on 448 threads).  Template and gradients stay in registers;
// block sums (gxx, gxy, gyy once per level; bx, by, sum|diff| per step) go
// through warp shuffles and one shared-memory hop.  Images are read straight
// from global memory: one f32 pyramid pair at 752x480 is about 1.9 MB and
// stays in the 50 MB L2.
//
// What bounds it on an H100: latency and occupancy, not bytes or FLOPs.  At
// the main path's N = 30 features the grid fills 30 of 132 SMs, and each
// level is a chain of 1 + iters dependent block reductions (36 for 4 levels
// and 8 steps), each two __syncthreads apart.  The design answers the launch
// side (one launch instead of one per level, no host round trips between
// levels) and keeps each step's critical path short (four L2-resident loads
// per thread, one block reduction); packing several features per SM or
// splitting a feature across a cluster is left for a later, measured change.

#include <cuda_runtime.h>
#include <stdint.h>

#define KLT_MAX_LEVELS 8

struct KltPyramid {
  const float* prev[KLT_MAX_LEVELS];
  const float* next[KLT_MAX_LEVELS];
  int height[KLT_MAX_LEVELS];
  int width[KLT_MAX_LEVELS];
  float xmax[KLT_MAX_LEVELS];  // float32(W - 1.001), rounded on the host
  float ymax[KLT_MAX_LEVELS];  // float32(H - 1.001)
  int levels;
};

// Bilinear sample with the gather path's per-sample clamp and weight order.
__device__ __forceinline__ float bilinear(const float* __restrict__ img, int width,
                                          float xmax, float ymax, float x, float y) {
  x = fminf(fmaxf(x, 0.0f), xmax);
  y = fminf(fmaxf(y, 0.0f), ymax);
  const int x0 = (int)floorf(x);
  const int y0 = (int)floorf(y);
  const float fx = x - (float)x0;
  const float fy = y - (float)y0;
  const float* r0 = img + (size_t)y0 * width + x0;
  const float* r1 = r0 + width;
  const float i00 = __ldg(r0), i01 = __ldg(r0 + 1);
  const float i10 = __ldg(r1), i11 = __ldg(r1 + 1);
  return i00 * (1.0f - fx) * (1.0f - fy) + i01 * fx * (1.0f - fy) +
         i10 * (1.0f - fx) * fy + i11 * fx * fy;
}

// Sum three values over the block; every thread receives the totals.
// `sh` holds 32 * 3 partials plus the 3 totals.
__device__ __forceinline__ void block_sum3(float& a, float& b, float& c, float* sh) {
  const unsigned full = 0xffffffffu;
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(full, a, off);
    b += __shfl_down_sync(full, b, off);
    c += __shfl_down_sync(full, c, off);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    sh[3 * warp + 0] = a;
    sh[3 * warp + 1] = b;
    sh[3 * warp + 2] = c;
  }
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    a = lane < nwarps ? sh[3 * lane + 0] : 0.0f;
    b = lane < nwarps ? sh[3 * lane + 1] : 0.0f;
    c = lane < nwarps ? sh[3 * lane + 2] : 0.0f;
    for (int off = 16; off > 0; off >>= 1) {
      a += __shfl_down_sync(full, a, off);
      b += __shfl_down_sync(full, b, off);
      c += __shfl_down_sync(full, c, off);
    }
    if (lane == 0) {
      sh[96] = a;
      sh[97] = b;
      sh[98] = c;
    }
  }
  __syncthreads();
  a = sh[96];
  b = sh[97];
  c = sh[98];
}

__global__ void __launch_bounds__(1024)
klt_pyramid_kernel(KltPyramid pyr, const float* __restrict__ pos,
                   const float* __restrict__ guess, float* __restrict__ out_pos,
                   float* __restrict__ out_err, int win, int iters) {
  __shared__ float sh[99];
  const int f = blockIdx.x;
  const int t = threadIdx.x;
  const int nsamp = win * win;
  const bool active = t < nsamp;
  const float r = (float)(win - 1) * 0.5f;
  // sample (row j, column i) sits at centre + (i - r, j - r)
  const float ox = active ? (float)(t % win) - r : 0.0f;
  const float oy = active ? (float)(t / win) - r : 0.0f;

  const float posx = pos[2 * f], posy = pos[2 * f + 1];
  const int top = pyr.levels - 1;
  const float scale0 = (float)(1 << top);
  float px = guess[2 * f] / scale0;
  float py = guess[2 * f + 1] / scale0;
  float err = 0.0f;

  for (int lvl = top; lvl >= 0; --lvl) {
    if (lvl < top) {
      px *= 2.0f;
      py *= 2.0f;
    }
    const float s = (float)(1 << lvl);
    const float cx = posx / s, cy = posy / s;
    const float* prev = pyr.prev[lvl];
    const float* next = pyr.next[lvl];
    const int w = pyr.width[lvl];
    const float xmax = pyr.xmax[lvl], ymax = pyr.ymax[lvl];

    float tmpl = 0.0f, gx = 0.0f, gy = 0.0f;
    if (active) {
      const float sx = cx + ox, sy = cy + oy;
      tmpl = bilinear(prev, w, xmax, ymax, sx, sy);
      gx = bilinear(prev, w, xmax, ymax, sx + 1.0f, sy) -
           bilinear(prev, w, xmax, ymax, sx - 1.0f, sy);
      gy = bilinear(prev, w, xmax, ymax, sx, sy + 1.0f) -
           bilinear(prev, w, xmax, ymax, sx, sy - 1.0f);
    }
    float gxx = gx * gx, gxy = gx * gy, gyy = gy * gy;
    block_sum3(gxx, gxy, gyy, sh);
    float det = gxx * gyy - gxy * gxy;
    if (fabsf(det) < 1e-12f) det = 1e-12f;

    for (int it = 0; it < iters; ++it) {
      const float diff = active ? bilinear(next, w, xmax, ymax, px + ox, py + oy) - tmpl : 0.0f;
      float bx = diff * gx, by = diff * gy, ad = fabsf(diff);
      block_sum3(bx, by, ad, sh);
      const float dx = (gyy * bx - gxy * by) / det;
      const float dy = (gxx * by - gxy * bx) / det;
      px -= dx;
      py -= dy;
      err = ad / (float)nsamp;
    }
  }
  if (t == 0) {
    out_pos[2 * f] = px;
    out_pos[2 * f + 1] = py;
    out_err[f] = err;
  }
}

// C entry point for ctypes.  Pointers are device pointers except the four
// per-level host arrays.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int klt_track_pyramid_f32(const uint64_t* prev_ptrs, const uint64_t* next_ptrs,
                                     const int* heights, const int* widths, int levels,
                                     const float* pos, const float* guess, float* out_pos,
                                     float* out_err, int n, int win, int iters,
                                     void* stream) {
  if (levels < 1 || levels > KLT_MAX_LEVELS || n < 1 || win < 1 || iters < 1)
    return (int)cudaErrorInvalidValue;
  const int threads = ((win * win + 31) / 32) * 32;
  if (threads > 1024) return (int)cudaErrorInvalidValue;
  KltPyramid pyr;
  for (int l = 0; l < levels; ++l) {
    if (heights[l] < 2 || widths[l] < 2) return (int)cudaErrorInvalidValue;
    pyr.prev[l] = reinterpret_cast<const float*>(prev_ptrs[l]);
    pyr.next[l] = reinterpret_cast<const float*>(next_ptrs[l]);
    pyr.height[l] = heights[l];
    pyr.width[l] = widths[l];
    pyr.xmax[l] = (float)((double)widths[l] - 1.001);
    pyr.ymax[l] = (float)((double)heights[l] - 1.001);
  }
  pyr.levels = levels;
  klt_pyramid_kernel<<<n, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      pyr, pos, guess, out_pos, out_err, win, iters);
  return (int)cudaGetLastError();
}
