// Kernel 11: Gauss-Newton on frozen point-to-line / point-to-plane
// correspondences, all iterations in one launch.
//
// Replaces: lv_slam_tpu/lfa/registration.py:156 `gn_solve`.
//
// What bounds it on the card: latency. Each of the 8 iterations does ~150
// flops on each of the 12160 residual lanes (4096 + 8064 at the flagship
// shapes, ~0.5 MB read once), then a 6x6 solve that one warp does; the
// floor is 8 x (the lanes' dependent chains + a cluster barrier + the
// solve and exp_se3), a few microseconds each, not the flops (0.00016 ms).
//
// Design: one thread-block cluster of 8 blocks x 512 threads, one
// launch for every iteration. Each block takes a contiguous slice of the
// ne + ns lanes and loads it once into shared memory (up to 4096 lanes a
// block; lanes past that are read from global memory each iteration);
// invalid lanes are zeroed before any nonlinear op (sentinel points at 1e6
// overflow when squared). Per iteration each thread builds the residuals of
// its lanes, two at a time (line: r = |(y - mu) x v|, J = [g, y x g] with
// g = v x (c / r); plane: r = n.y + d, J = [n, y x n]), Huber(0.1)-weights
// them and sums the 21 entries of J^T W J (symmetric here, unlike the NDT
// Hessian) and the 6 of J^T W r; a warp reduce-scatter (31 shuffles) and a
// fixed-order pass over the warps give the block's 27 sums. After one
// cluster barrier every block adds the 8 blocks' sums in rank order over
// distributed shared memory (the same bits in every block, no atomics), and
// its warp 0 adds the ridge 1e-4 tr(H)/6 + 1e-9, solves by LU with partial
// pivoting, one row per lane (the elimination of the reference's
// jnp.linalg.solve; first-largest pivot on ties), zeroes a non-finite step
// and applies exp_se3 on the left to the block's own T: every block solves
// the same system, so one barrier per iteration suffices (the sums are
// double-buffered by iteration parity). No host read.
#include "common.cuh"

#include <cooperative_groups.h>
#include <math.h>

namespace {

constexpr int kGnCtas = 8;         // one cluster, the portable size
constexpr int kGnThreads = 512;    // per block
constexpr int kGnWarps = kGnThreads / 32;
constexpr int kGnMaxHeld = 4096;   // lanes a block keeps in shared memory (160 KB): 8 x 4096 in all
constexpr int kSums = 27;  // H upper triangle (21), then g (6)


__device__ __forceinline__ void cross(const float a[3], const float b[3], float out[3]) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ void transform(const float* T, const float p[3], float y[3]) {
#pragma unroll
  for (int r = 0; r < 3; ++r) y[r] = ((p[0] * T[4 * r + 0] + p[1] * T[4 * r + 1]) + p[2] * T[4 * r + 2]) + T[4 * r + 3];
}

__host__ __device__ constexpr int tri(int a, int b) {  // a <= b
  return a * 6 - a * (a - 1) / 2 + (b - a);
}

__device__ __forceinline__ void accumulate(float (&acc)[32], const float (&j)[6], float w, float r) {
#pragma unroll
  for (int a = 0; a < 6; ++a)
#pragma unroll
    for (int b = a; b < 6; ++b) acc[tri(a, b)] += (j[a] * w) * j[b];
#pragma unroll
  for (int a = 0; a < 6; ++a) acc[21 + a] += j[a] * (w * r);
}

__device__ __forceinline__ float huber(float r) {
  float ar = fabsf(r);
  return ar > 0.1f ? 0.1f / fmaxf(ar, 1e-9f) : 1.0f;
}

// Solves A x = b (6x6) by LU with partial pivoting, one row per lane:
// lane r < 6 holds row r of [A | b] in `row` and every lane ends with x.
// The operations and their order per element are a serial LU's (the
// elimination of the reference's jnp.linalg.solve), so the result does not
// depend on the lanes: the pivot is the first row of the largest |A[r][c]|
// (a NaN never wins), rows swap whole, and back substitution runs from
// row 5 up, each x[r] broadcast before the next. The whole warp calls it.
__device__ __forceinline__ void solve6_warp(float (&row)[7], int lane, float (&x)[6]) {
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    int piv = c;
    float best = fabsf(__shfl_sync(0xffffffffu, row[c], c));
#pragma unroll
    for (int r = c + 1; r < 6; ++r) {
      const float v = fabsf(__shfl_sync(0xffffffffu, row[c], r));
      if (v > best) {
        best = v;
        piv = r;
      }
    }
    const int src = lane == c ? piv : lane == piv ? c : lane;
#pragma unroll
    for (int k = 0; k < 7; ++k) row[k] = __shfl_sync(0xffffffffu, row[k], src);
    float prow[7];
#pragma unroll
    for (int k = c; k < 7; ++k) prow[k] = __shfl_sync(0xffffffffu, row[k], c);
    if (lane > c && lane < 6) {
      const float l = row[c] / prow[c];
#pragma unroll
      for (int k = c + 1; k < 7; ++k) row[k] -= l * prow[k];
    }
  }
#pragma unroll
  for (int r = 5; r >= 0; --r) {
    float s = row[6];
#pragma unroll
    for (int k = r + 1; k < 6; ++k) s -= row[k] * x[k];
    x[r] = __shfl_sync(0xffffffffu, s / row[r], r);
  }
}

// T <- exp_se3(delta) T, the formula of core/se3.py (Taylor branch below
// theta = 1e-4).
__device__ __forceinline__ void apply_exp(const float delta[6], float T[16]) {
  const float* rho = delta;
  const float* phi = delta + 3;
  float tsq = (phi[0] * phi[0] + phi[1] * phi[1]) + phi[2] * phi[2];
  float a, b, c;
  if (tsq < 1e-8f) {
    a = 1.0f - tsq / 6.0f;
    b = 0.5f - tsq / 24.0f;
    c = 1.0f / 6.0f - tsq / 120.0f;
  } else {
    float t = sqrtf(tsq);
    a = sinf(t) / t;
    b = (1.0f - cosf(t)) / tsq;
    c = (t - sinf(t)) / (tsq * t);
  }
  float K[9] = {0.0f, -phi[2], phi[1], phi[2], 0.0f, -phi[0], -phi[1], phi[0], 0.0f};
  float K2[9];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int q = 0; q < 3; ++q)
      K2[3 * r + q] = (K[3 * r + 0] * K[q] + K[3 * r + 1] * K[3 + q]) + K[3 * r + 2] * K[6 + q];
  float R[9], V[9];
#pragma unroll
  for (int e = 0; e < 9; ++e) {
    float eye = (e % 4 == 0) ? 1.0f : 0.0f;
    R[e] = (eye + a * K[e]) + b * K2[e];
    V[e] = (eye + b * K[e]) + c * K2[e];
  }
  float E[16];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int q = 0; q < 3; ++q) E[4 * r + q] = R[3 * r + q];
    E[4 * r + 3] = (V[3 * r + 0] * rho[0] + V[3 * r + 1] * rho[1]) + V[3 * r + 2] * rho[2];
  }
  E[12] = 0.0f; E[13] = 0.0f; E[14] = 0.0f; E[15] = 1.0f;
  float out[16];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      out[4 * r + q] = ((E[4 * r + 0] * T[q] + E[4 * r + 1] * T[4 + q]) + E[4 * r + 2] * T[8 + q]) +
                       E[4 * r + 3] * T[12 + q];
#pragma unroll
  for (int e = 0; e < 16; ++e) T[e] = out[e];
}

// The residual lanes a block keeps in shared memory, as ten arrays of
// `cap` floats: the point, then the line's mean and direction (edge lanes)
// or the plane's normal and offset (plane lanes), then the weight.
// Invalid lanes hold zeros and weight 0.
struct Lanes {
  float* f;
  int cap;
  __device__ float& operator()(int field, int i) const { return f[field * cap + i]; }
};
enum { kPx, kPy, kPz, kA0, kA1, kA2, kV0, kV1, kV2, kW, kLaneFields };

// Lane i's ten fields, read from the inputs (invalid lanes zeroed before
// any nonlinear op: sentinel points at 1e6 overflow when squared).
__device__ __forceinline__ void load_lane(int i, float (&l)[kLaneFields], const float* __restrict__ edges,
                                          const float* __restrict__ lmu, const float* __restrict__ lv,
                                          const bool* __restrict__ lvalid, int ne, const float* __restrict__ surfs,
                                          const float* __restrict__ pn, const float* __restrict__ pd,
                                          const bool* __restrict__ pvalid) {
  if (i < ne) {
    const bool ok = lvalid[i];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      l[kPx + k] = ok ? edges[3 * i + k] : 0.0f;
      l[kA0 + k] = ok ? lmu[3 * i + k] : 0.0f;
      l[kV0 + k] = lv[3 * i + k];
    }
    l[kW] = ok ? 1.0f : 0.0f;
  } else {
    const int j = i - ne;
    const bool ok = pvalid[j];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      l[kPx + k] = ok ? surfs[3 * j + k] : 0.0f;
      l[kV0 + k] = pn[3 * j + k];
    }
    l[kA0] = ok ? fminf(fmaxf(pd[j], -1e4f), 1e4f) : 0.0f;
    l[kA1] = l[kA2] = 0.0f;
    l[kW] = ok ? 1.0f : 0.0f;
  }
}

// Lane l's Jacobian row j, Huber weight w (0 for an invalid lane) and
// residual r at T.
__device__ __forceinline__ void lane_terms(const float (&l)[kLaneFields], bool edge, const float* T, float (&j)[6],
                                           float& w, float& r) {
  const float p[3] = {l[kPx], l[kPy], l[kPz]}, v[3] = {l[kV0], l[kV1], l[kV2]};
  float y[3];
  transform(T, p, y);
  if (edge) {
    float diff[3], c[3], cr[3], g[3], yg[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) diff[k] = y[k] - l[kA0 + k];
    cross(diff, v, c);
    r = sqrtf(((c[0] * c[0] + c[1] * c[1]) + c[2] * c[2]) + 1e-12f);
#pragma unroll
    for (int k = 0; k < 3; ++k) cr[k] = c[k] / r;
    cross(v, cr, g);
    cross(y, g, yg);
    j[0] = g[0]; j[1] = g[1]; j[2] = g[2]; j[3] = yg[0]; j[4] = yg[1]; j[5] = yg[2];
  } else {
    float yn[3];
    r = ((y[0] * v[0] + y[1] * v[1]) + y[2] * v[2]) + l[kA0];
    cross(y, v, yn);
    j[0] = v[0]; j[1] = v[1]; j[2] = v[2]; j[3] = yn[0]; j[4] = yn[1]; j[5] = yn[2];
  }
  w = l[kW] * huber(r);
}

// c ? a : b in a select instruction the compiler cannot turn into a
// run-time index of the array the operands come from (which would move the
// array to local memory).
__device__ __forceinline__ float select(bool c, float a, float b) {
  float r;
  asm("{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %1, 0;\n\tselp.f32 %0, %2, %3, p;\n\t}"
      : "=f"(r)
      : "r"(static_cast<int>(c)), "f"(a), "f"(b));
  return r;
}

// The warp's 27 sums (padded to 32), reduce-scattered: at step h the lane
// with bit h set keeps the upper half of its terms, so after 16 + 8 + 4 +
// 2 + 1 shuffles lane L holds the warp's sum of term L, a fixed tree of
// adds (the naive per-term reduction takes 27 x 5 shuffles).
template <int H>
__device__ __forceinline__ void reduce_half(float (&acc)[32], bool upper) {  // a constant count: acc stays in registers
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = select(upper, acc[i], acc[i + H]);
    acc[i] = select(upper, acc[i + H], acc[i]) + __shfl_xor_sync(0xffffffffu, send, H);
  }
}

__device__ __forceinline__ float warp_reduce_scatter(float (&acc)[32], int lane) {
  reduce_half<16>(acc, lane & 16);
  reduce_half<8>(acc, lane & 8);
  reduce_half<4>(acc, lane & 4);
  reduce_half<2>(acc, lane & 2);
  reduce_half<1>(acc, lane & 1);
  return acc[0];
}

__global__ void __cluster_dims__(kGnCtas, 1, 1) __launch_bounds__(kGnThreads, 1)
gn_cluster(const float* __restrict__ T0, const float* __restrict__ edges, const float* __restrict__ lmu,
           const float* __restrict__ lv, const bool* __restrict__ lvalid, int ne,
           const float* __restrict__ surfs, const float* __restrict__ pn, const float* __restrict__ pd,
           const bool* __restrict__ pvalid, int ns, int iters, int cap, float* __restrict__ T_out) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float lane_smem[];
  __shared__ float T[16];
  __shared__ float part[kGnWarps][32];
  __shared__ float block_sums[2][32];  // by iteration parity; read by every block over distributed shared memory
  __shared__ float total[32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = static_cast<int>(cluster.block_rank());

  // this block's contiguous slice of the ne + ns lanes, loaded once: the
  // first `cap` into shared memory, the rest read each iteration
  const int n_lanes = ne + ns, chunk = (n_lanes + kGnCtas - 1) / kGnCtas;
  const int lo = min(n_lanes, rank * chunk), hi = min(n_lanes, lo + chunk);
  const Lanes held{lane_smem, cap};
  for (int i = lo + tid; i < min(hi, lo + cap); i += kGnThreads) {
    float l[kLaneFields];
    load_lane(i, l, edges, lmu, lv, lvalid, ne, surfs, pn, pd, pvalid);
#pragma unroll
    for (int f = 0; f < kLaneFields; ++f) held(f, i - lo) = l[f];
  }
  if (tid < 16) T[tid] = T0[tid];
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    float acc[32];
#pragma unroll
    for (int s = 0; s < 32; ++s) acc[s] = 0.0f;
    for (int i = lo + tid; i < hi; i += 2 * kGnThreads) {  // two lanes at once: their math overlaps
      float l[2][kLaneFields], j[2][6], w[2], r[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int k = i + u * kGnThreads;
        if (k < hi && k - lo < cap) {
#pragma unroll
          for (int f = 0; f < kLaneFields; ++f) l[u][f] = held(f, k - lo);
        } else if (k < hi) {
          load_lane(k, l[u], edges, lmu, lv, lvalid, ne, surfs, pn, pd, pvalid);
        } else {
#pragma unroll
          for (int f = 0; f < kLaneFields; ++f) l[u][f] = 0.0f;  // no lane: weight 0
        }
        lane_terms(l[u], k < ne, T, j[u], w[u], r[u]);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) accumulate(acc, j[u], w[u], r[u]);
    }
    part[warp][lane] = warp_reduce_scatter(acc, lane);
    __syncthreads();
    float* sums = block_sums[it & 1];
    if (tid < kSums) {
      float v = 0.0f;
      for (int w = 0; w < kGnWarps; ++w) v += part[w][tid];
      sums[tid] = v;
    }
    cluster.sync();  // every block's sums are written
    if (tid < kSums) {  // the 8 blocks' sums in rank order: the same bits in every block
      float v = 0.0f;
      for (int b = 0; b < kGnCtas; ++b) v += cluster.map_shared_rank(sums, b)[tid];
      total[tid] = v;
    }
    __syncthreads();
    if (warp == 0) {  // H + ridge, the step, exp_se3 on the left
      float row[7], delta[6];
      const int r = min(lane, 5);
#pragma unroll
      for (int q = 0; q < 6; ++q) row[q] = total[r <= q ? tri(r, q) : tri(q, r)];
      const float trace = (((((total[tri(0, 0)] + total[tri(1, 1)]) + total[tri(2, 2)]) + total[tri(3, 3)]) +
                            total[tri(4, 4)]) + total[tri(5, 5)]);
      const float ridge = 1e-4f * trace / 6.0f + 1e-9f;
#pragma unroll
      for (int q = 0; q < 6; ++q)
        if (q == r) row[q] += ridge;
      row[6] = -total[21 + r];
      solve6_warp(row, lane, delta);
      bool finite = true;
#pragma unroll
      for (int a = 0; a < 6; ++a) finite &= isfinite(delta[a]);
      if (lane == 0 && finite) apply_exp(delta, T);
    }
    __syncthreads();
  }
  if (rank == 0 && tid < 16) T_out[tid] = T[tid];
  cluster.sync();  // no block leaves while another reads its sums
}

}  // namespace

extern "C" int lvs_gn_solve(const float* T0, const float* edges, const float* lmu, const float* lv,
                            const bool* lvalid, int ne, const float* surfs, const float* pn,
                            const float* pd, const bool* pvalid, int ns, int iters, float* T_out,
                            cudaStream_t stream) {
  const int cap = min((ne + ns + kGnCtas - 1) / kGnCtas, kGnMaxHeld);
  const int bytes = static_cast<int>(sizeof(float)) * kLaneFields * cap;
  cudaError_t err = cudaFuncSetAttribute(gn_cluster, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  gn_cluster<<<kGnCtas, kGnThreads, bytes, stream>>>(T0, edges, lmu, lv, lvalid, ne, surfs, pn, pd, pvalid, ns,
                                                     iters, cap, T_out);
  LVS_RETURN_LAST_ERROR();
}
