// The tracker's epipolar RANSAC gate, one launch a frame for all lanes.
//
// Replaces no TPU kernel: eqvio_tpu/frontend/ransac.py is plain JAX that XLA
// fuses.  The port's torch version (eqvio_tpu_torch/frontend/ransac.py:
// ransac_epipolar_mask after frontend/prng.py:fold_in of the tracker's
// next_id) computes the gate in about 3,800 small kernels a frame on the
// card, each rounding its own operation.  This kernel computes the same mask
// in one launch, rounding where those kernels round: every float multiply,
// add, subtract, divide and square root is its own correctly rounded
// operation (the __f*_rn intrinsics, so nvcc contracts nothing into an FMA).
// Only the order of the sums over the tracks and of the small matrix
// products differs from torch's reductions and cuBLAS's, so a mask can
// differ from the torch path's only where a Sampson distance or a best
// hypothesis sits at a near tie.
//
// Bound on an H100: the work is well under one MFLOP and a few kB a lane,
// nanoseconds at the card's rates.  What bounds it is the latency of two
// serial chains: each hypothesis's 8-point solve (the 9x9 Gram matrix, its
// regularised unrolled Cholesky, six inverse-iteration solves, two 3x3
// eigenvector solves for the rank-2 projection: a few thousand dependent
// operations, a hundred of them divisions or square roots), and after the
// pick the weighted refit's solve of the same length.  The design keeps
// everything between the phases in shared memory and registers:
//
// - One block of RS_THREADS threads per lane, lane = blockIdx.x.
// - Hartley normalisation of both point sets by block reductions over the N
//   tracks (an xor butterfly in each warp, then the warp sums in order: a
//   fixed order, so every lane of a vmap does a single lane's arithmetic).
// - The K x N threefry-2x32 draws of jax.random.uniform(fold_in(key,
//   next_id), (K, N)): the same integer arithmetic as prng.py, so the bits
//   equal the torch path's; untracked slots score +inf.
// - The 8 samples of each hypothesis by stable rank counting: a slot's rank
//   is the number of slots of its row with a lower score, or an equal score
//   and a lower index, which is argsort(stable=True)[:, :8].
// - Each track's epipolar constraint row once, in shared memory, read by
//   the hypotheses' Gram matrices and the refit's.
// - One thread per hypothesis for its solve, in registers.
// - The K x N Sampson costs across the block, the truncated sum per
//   hypothesis and the first-maximum pick of torch.argmax (a NaN counts as
//   the maximum, as there).
// - The refit's 9x9 Gram matrix over the N tracks, one thread per entry,
//   its solve on one thread, then the refined mask, its count and the
//   usable guard.
// A lane with fewer than max(min_points, 8) tracked slots keeps its mask, as
// the torch path's guard returns it, and skips the rest.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define RS_THREADS 256
#define RS_WARPS (RS_THREADS / 32)
#define RS_GRAM 45  // packed lower triangle of a 9x9 matrix

struct RansacArgs {
  const float* prev;     // [lanes, n, 2]
  const float* curr;     // [lanes, n, 2]
  const uint8_t* mask;   // [lanes, n] (bool)
  const long long* key;  // [2] or [lanes, 2]: uint32 values
  const long long* next_id;  // [] or [lanes]
  uint8_t* out;          // [lanes, n] (bool)
  long long key_stride;  // 0 (one key for every lane) or 2
  long long id_stride;   // 0 or 1
  int n, k;
  float thr_sq;          // float32(threshold ** 2)
  int need;              // max(min_points, 8)
  int min_inliers;
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
// torch.clamp(x, min=lo) and torch.minimum(x, hi) keep a NaN x
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float min_keep_nan(float x, float hi) { return x > hi ? hi : x; }

__device__ __forceinline__ uint32_t rotl(uint32_t x, int d) { return (x << d) | (x >> (32 - d)); }

// Threefry-2x32 (20 rounds) of the counter pair (x1, x2) under (k1, k2), in place
__device__ __forceinline__ void threefry2x32(uint32_t k1, uint32_t k2, uint32_t& x1, uint32_t& x2) {
  const uint32_t ks[3] = {k1, k2, k1 ^ k2 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x1 += ks[0];
  x2 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x1 += x2;
      x2 = rotl(x2, rot[i % 2][r]) ^ x1;
    }
    x1 += ks[(i + 1) % 3];
    x2 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
}

// Block sums of one value per thread, the result in every thread.  `red`
// holds RS_WARPS slots; the barrier before the write frees it from the last
// call.
__device__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = add(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = red[0];
#pragma unroll
  for (int w = 1; w < RS_WARPS; ++w) s = add(s, red[w]);
  return s;
}

__device__ int block_count(int v, int* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int s = 0;
#pragma unroll
  for (int w = 0; w < RS_WARPS; ++w) s += red[w];
  return s;
}

// Packed lower triangle: entry (i, j), j <= i
__host__ __device__ constexpr int tri(int i, int j) { return i * (i + 1) / 2 + j; }

// Unit eigenvector of the smallest eigenvalue of the PSD matrix G (packed
// lower triangle, overwritten) by frontend/ransac.py:smallest_eigvec's
// regularised inverse iteration: the unrolled lower Cholesky of
// G + (1e-7 tr + 1e-30) I, then `iters` solves of L L^T x = v, each
// normalised with its norm clamped at 1e-30, from v_i = 1 + 0.01 i.
template <int n>
__device__ __forceinline__ void smallest_eigvec(float (&G)[n * (n + 1) / 2], float (&v)[n]) {
  float tr = G[0];
#pragma unroll
  for (int i = 1; i < n; ++i) tr = add(tr, G[tri(i, i)]);
  const float reg = add(mul(1e-7f, tr), 1e-30f);
  const float off = mul(reg, 0.0f);  // reg * eye off the diagonal
#pragma unroll
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) G[tri(i, j)] = add(G[tri(i, j)], i == j ? reg : off);
  }
  // Cholesky in place: L(i, j) replaces G(i, j) once the entries it reads are L's
#pragma unroll
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float s = G[tri(i, j)];
#pragma unroll
      for (int k = 0; k < j; ++k) s = sub(s, mul(G[tri(i, k)], G[tri(j, k)]));
      G[tri(i, j)] = i == j ? __fsqrt_rn(clamp_min(s, 1e-30f)) : dvd(s, G[tri(j, j)]);
    }
  }
#pragma unroll
  for (int i = 0; i < n; ++i) v[i] = add(1.0f, mul(0.01f, (float)i));
#pragma unroll
  for (int it = 0; it < 6; ++it) {
    float y[n];
#pragma unroll
    for (int i = 0; i < n; ++i) {
      float s = v[i];
#pragma unroll
      for (int k = 0; k < i; ++k) s = sub(s, mul(G[tri(i, k)], y[k]));
      y[i] = dvd(s, G[tri(i, i)]);
    }
#pragma unroll
    for (int i = n - 1; i >= 0; --i) {
      float s = y[i];
#pragma unroll
      for (int k = i + 1; k < n; ++k) s = sub(s, mul(G[tri(k, i)], v[k]));
      v[i] = dvd(s, G[tri(i, i)]);
    }
    float ss = mul(v[0], v[0]);
#pragma unroll
    for (int i = 1; i < n; ++i) ss = add(ss, mul(v[i], v[i]));
    const float nrm = clamp_min(__fsqrt_rn(ss), 1e-30f);
#pragma unroll
    for (int i = 0; i < n; ++i) v[i] = dvd(v[i], nrm);
  }
}

// frontend/ransac.py:_rank2 of the row-major 3x3 F, in place: less the
// smallest singular triplet (v3 of F^T F, u3 of F F^T, s3 = u3^T F v3)
__device__ __forceinline__ void rank2(float (&F)[9]) {
  float a[6], b[6], v3[3], u3[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c <= r; ++c) {
      a[tri(r, c)] = add(add(mul(F[r], F[c]), mul(F[3 + r], F[3 + c])), mul(F[6 + r], F[6 + c]));
      b[tri(r, c)] = add(add(mul(F[3 * r], F[3 * c]), mul(F[3 * r + 1], F[3 * c + 1])),
                         mul(F[3 * r + 2], F[3 * c + 2]));
    }
  }
  smallest_eigvec<3>(a, v3);
  smallest_eigvec<3>(b, u3);
  float s3 = 0.0f;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float t = add(add(mul(u3[0], F[j]), mul(u3[1], F[3 + j])), mul(u3[2], F[6 + j]));
    s3 = j == 0 ? mul(t, v3[0]) : add(s3, mul(t, v3[j]));
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float su = mul(s3, u3[i]);
#pragma unroll
    for (int j = 0; j < 3; ++j) F[3 * i + j] = sub(F[3 * i + j], mul(su, v3[j]));
  }
}

// Entry i of the epipolar constraint row of (x1, y1) -> (x2, y2):
// [x2 x1, x2 y1, x2, y2 x1, y2 y1, y2, x1, y1, 1]
__device__ __forceinline__ float row_entry(int i, float x1, float y1, float x2, float y2) {
  switch (i) {
    case 0: return mul(x2, x1);
    case 1: return mul(x2, y1);
    case 2: return x2;
    case 3: return mul(y2, x1);
    case 4: return mul(y2, y1);
    case 5: return y2;
    case 6: return x1;
    case 7: return y1;
    default: return 1.0f;
  }
}

// Squared Sampson distance of (x1, y1) -> (x2, y2) under the row-major F
__device__ __forceinline__ float sampson(const float* F, float x1, float y1, float x2, float y2) {
  const float a0 = add(add(mul(F[0], x1), mul(F[1], y1)), F[2]);
  const float a1 = add(add(mul(F[3], x1), mul(F[4], y1)), F[5]);
  const float a2 = add(add(mul(F[6], x1), mul(F[7], y1)), F[8]);
  const float b0 = add(add(mul(F[0], x2), mul(F[3], y2)), F[6]);
  const float b1 = add(add(mul(F[1], x2), mul(F[4], y2)), F[7]);
  const float e = add(add(mul(x2, a0), mul(y2, a1)), a2);
  const float den = add(add(add(mul(a0, a0), mul(a1, a1)), mul(b0, b0)), mul(b1, b1));
  return dvd(mul(e, e), clamp_min(den, 1e-12f));
}

// Normalise one point set in place into `p` (Hartley: centroid to the
// origin, mean distance sqrt 2) over the tracked slots; returns the scale.
__device__ float normalise(const float* pts, const float* w, float* p, int n, float count, float* red) {
  float sx = 0.0f, sy = 0.0f;
  for (int i = threadIdx.x; i < n; i += RS_THREADS) {
    sx = add(sx, mul(pts[2 * i], w[i]));
    sy = add(sy, mul(pts[2 * i + 1], w[i]));
  }
  const float cx = dvd(block_sum(sx, red), count);
  const float cy = dvd(block_sum(sy, red), count);
  float sd = 0.0f;
  for (int i = threadIdx.x; i < n; i += RS_THREADS) {
    const float dx = sub(pts[2 * i], cx), dy = sub(pts[2 * i + 1], cy);
    sd = add(sd, mul(__fsqrt_rn(add(mul(dx, dx), mul(dy, dy))), w[i]));
  }
  const float mean_d = clamp_min(dvd(block_sum(sd, red), count), 1e-9f);
  const float s = dvd(1.41421356237309505f, mean_d);
  for (int i = threadIdx.x; i < n; i += RS_THREADS) {
    p[2 * i] = mul(sub(pts[2 * i], cx), s);
    p[2 * i + 1] = mul(sub(pts[2 * i + 1], cy), s);
  }
  return s;
}

__global__ void __launch_bounds__(RS_THREADS) ransac_gate_kernel(RansacArgs a) {
  extern __shared__ float smem[];
  __shared__ float red[RS_WARPS];
  __shared__ int ired[RS_WARPS];
  __shared__ float G2[RS_GRAM];
  __shared__ float F_lo[9];
  const int N = a.n, K = a.k, tid = threadIdx.x;
  const long long lane = blockIdx.x;
  const float* prev = a.prev + lane * 2 * N;
  const float* curr = a.curr + lane * 2 * N;
  const uint8_t* mask = a.mask + lane * N;
  uint8_t* out = a.out + lane * N;
  float* p1 = smem;            // [N, 2] normalised prev
  float* p2 = p1 + 2 * N;      // [N, 2] normalised curr
  float* w = p2 + 2 * N;       // [N] the mask as 0 / 1
  float* A = w + N;            // [N, 9] the tracks' epipolar constraint rows
  float* u = A + 9 * N;        // [K, N] draws, then truncated costs, then scratch
  float* Fk = u + K * N;       // [K, 9] hypotheses
  float* cost = Fk + 9 * K;    // [K]
  int* idx = reinterpret_cast<int*>(cost + K);  // [K, 8] samples

  int tracked = 0;
  for (int i = tid; i < N; i += RS_THREADS) {
    const bool m = mask[i] != 0;
    w[i] = m ? 1.0f : 0.0f;
    tracked += m;
  }
  const int n_tracked = block_count(tracked, ired);
  if (n_tracked < a.need) {  // the guard keeps the mask; the same branch in every thread
    for (int i = tid; i < N; i += RS_THREADS) out[i] = mask[i];
    return;
  }
  const float count = (float)n_tracked;  // sum(w), exact; at least 8
  const float s1 = normalise(prev, w, p1, N, count, red);
  const float s2 = normalise(curr, w, p2, N, count, red);
  __syncthreads();
  for (int i = tid; i < N; i += RS_THREADS) {
#pragma unroll
    for (int e = 0; e < 9; ++e) A[9 * i + e] = row_entry(e, p1[2 * i], p1[2 * i + 1], p2[2 * i], p2[2 * i + 1]);
  }

  // uniform(fold_in(key, next_id), (K, N)): counter (0, k N + i), bits h1 ^ h2,
  // (bits >> 9) 2^-23; every thread folds the key itself
  uint32_t k1 = 0u, k2 = (uint32_t)a.next_id[lane * a.id_stride];
  threefry2x32((uint32_t)a.key[lane * a.key_stride], (uint32_t)a.key[lane * a.key_stride + 1], k1, k2);
  for (int t = tid; t < K * N; t += RS_THREADS) {
    uint32_t h1 = 0u, h2 = (uint32_t)t;
    threefry2x32(k1, k2, h1, h2);
    u[t] = w[t % N] != 0.0f ? mul((float)((h1 ^ h2) >> 9), 1.1920928955078125e-7f) : INFINITY;
  }
  __syncthreads();

  // the first 8 of each row's stable ascending order (a full count, no early
  // exit, so the loads pipeline)
  for (int t = tid; t < K * N; t += RS_THREADS) {
    const int k = t / N, j = t - k * N;
    const float* row = u + k * N;
    const float sj = row[j];
    int rank = 0;
#pragma unroll 4
    for (int i = 0; i < N; ++i) {
      const float si = row[i];
      rank += (si < sj) || (si == sj && i < j);
    }
    if (rank < 8) idx[8 * k + rank] = j;
  }
  __syncthreads();

  // one normalised 8-point F per thread: its samples' Gram matrix, summed
  // over the samples in order
  for (int k = tid; k < K; k += RS_THREADS) {
    float G[RS_GRAM], f[9];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float* a_r = A + 9 * idx[8 * k + r];
      float a[9];
#pragma unroll
      for (int e = 0; e < 9; ++e) a[e] = a_r[e];
#pragma unroll
      for (int i = 0; i < 9; ++i) {
#pragma unroll
        for (int j = 0; j <= i; ++j) G[tri(i, j)] = r == 0 ? mul(a[i], a[j]) : add(G[tri(i, j)], mul(a[i], a[j]));
      }
    }
    smallest_eigvec<9>(G, f);
    rank2(f);
#pragma unroll
    for (int i = 0; i < 9; ++i) Fk[9 * k + i] = f[i];
  }
  __syncthreads();

  // MSAC: truncated Sampson costs, their sums, the first best
  const float thr2 = mul(mul(a.thr_sq, s1), s2);
  for (int t = tid; t < K * N; t += RS_THREADS) {
    const int k = t / N, i = t - k * N;
    const float d2 = sampson(Fk + 9 * k, p1[2 * i], p1[2 * i + 1], p2[2 * i], p2[2 * i + 1]);
    u[t] = w[i] != 0.0f ? min_keep_nan(d2, thr2) : 0.0f;
  }
  __syncthreads();
  for (int k = tid; k < K; k += RS_THREADS) {
    float c = u[k * N];
    for (int i = 1; i < N; ++i) c = add(c, u[k * N + i]);
    cost[k] = c;
  }
  __syncthreads();
  int best = 0;  // torch.argmax(-cost): the first maximum, a NaN the maximum
  float best_v = -cost[0];
  for (int k = 1; k < K && !isnan(best_v); ++k) {
    const float v = -cost[k];
    if (isnan(v) || v > best_v) {
      best = k;
      best_v = v;
    }
  }
  float* wl = u;  // [N] the best hypothesis's inliers as 0 / 1
  for (int i = tid; i < N; i += RS_THREADS) {
    const float d2 = sampson(Fk + 9 * best, p1[2 * i], p1[2 * i + 1], p2[2 * i], p2[2 * i + 1]);
    wl[i] = (d2 < thr2 && w[i] != 0.0f) ? 1.0f : 0.0f;
  }
  __syncthreads();

  // the refit's Gram matrix, sum over the tracks of (A_i w) A_j, one thread an entry
  if (tid < RS_GRAM) {
    int i = 0;
    while (tri(i + 1, 0) <= tid) ++i;
    const int j = tid - tri(i, 0);
    float s = 0.0f;
    for (int t = 0; t < N; ++t) s = add(s, mul(mul(A[9 * t + i], wl[t]), A[9 * t + j]));
    G2[tid] = s;
  }
  __syncthreads();
  if (tid == 0) {
    float G[RS_GRAM], f[9];
#pragma unroll
    for (int e = 0; e < RS_GRAM; ++e) G[e] = G2[e];
    smallest_eigvec<9>(G, f);
    rank2(f);
#pragma unroll
    for (int i = 0; i < 9; ++i) F_lo[i] = f[i];
  }
  __syncthreads();

  // the refined mask's count decides, then the mask (each distance computed
  // twice, the same bits both times)
  int inl = 0;
  for (int i = tid; i < N; i += RS_THREADS)
    inl += sampson(F_lo, p1[2 * i], p1[2 * i + 1], p2[2 * i], p2[2 * i + 1]) < thr2 && w[i] != 0.0f;
  const bool usable = block_count(inl, ired) >= a.min_inliers;
  for (int i = tid; i < N; i += RS_THREADS)
    out[i] = usable ? (sampson(F_lo, p1[2 * i], p1[2 * i + 1], p2[2 * i], p2[2 * i + 1]) < thr2 && w[i] != 0.0f)
                    : mask[i];
}

// Shared memory a block needs for n tracks and k hypotheses (the wrapper's
// kernels/ransac.py:smem_bytes computes the same)
static size_t smem_bytes(int n, int k) {
  return sizeof(float) * (14 * (size_t)n + (size_t)k * n + 10 * (size_t)k) + sizeof(int) * 8 * (size_t)k;
}

extern "C" int ransac_gate_lanes_f32(const float* prev, const float* curr, const uint8_t* mask,
                                     const long long* key, long long key_stride,
                                     const long long* next_id, long long id_stride, uint8_t* out,
                                     int lanes, int n, int k, float thr_sq, int need,
                                     int min_inliers, void* stream) {
  if (lanes < 1 || n < 1 || k < 1 || (long long)k * n > 2147483647LL || need < 8 ||
      (key_stride != 0 && key_stride != 2) || (id_stride != 0 && id_stride != 1))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(n, k);
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (smem + 1024 > (size_t)limit) return (int)cudaErrorInvalidValue;  // 1 kB: the static arrays
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(ransac_gate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  RansacArgs a{prev, curr, mask, key, next_id, out, key_stride, id_stride, n, k, thr_sq, need, min_inliers};
  ransac_gate_kernel<<<lanes, RS_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
