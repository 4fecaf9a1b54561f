// Design variants of kernel 19b (GICP's normal equations,
// lv_slam_tpu_torch/csrc/gicp.cu `gicp_normal`), built against the shipped
// source (included here) by scripts/k19b_variants.py, which times them side
// by side and holds each one's H and g to the shipped kernel's bits.
//
// `variant<kTiles, kFinish, kAcqRel, kAhead, kChain>` is the shipped
// kernel's body with its two phases apart and its choices as knobs: kTiles
// the blocks' walk over the 256-lane tiles (the lanes' terms, the warps'
// trees, the tiles' partial rows and live flags), kFinish the last block's
// staged chain over the live rows (alone: one block over rows a tiles-only
// launch left); kAcqRel the ticket as one acq_rel atomic after a barrier
// (else a __threadfence before a relaxed atomic and another after it),
// kAhead the next round's flags loaded during this round (else at its
// start), kChain a column's chain of adds: 1 two batches of kChainBatch
// values loaded before their adds, 2 the next batch's loads issued between
// this batch's adds, 0 a loop unrolled 8 deep. kAcqRel, kAhead and kChain
// 1 are the shipped design. With `stamps`, thread 0 of each block writes
// %globaltimer (ns) to [kStamps * block + s]: s = 0 at its start, 1 after
// its tiles, 2 after its count on the ticket; for its first tile 4 when the
// lane flags are in, 5 when the terms are, 6 after the warps' trees, 7
// after the row's write; the finishing block 3 at the end, 8 when its first
// round's flags are compacted, 9 when that round's rows are staged; and 10
// the SM the block ran on (%smid).
#include "gicp.cu"

namespace {

constexpr int kStamps = 11;

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void stamp(unsigned long long* stamps, int s) {
  if (stamps != nullptr && threadIdx.x == 0) stamps[kStamps * blockIdx.x + s] = global_ns();
}

// `finish_tiles` with stamps and the knobs kAhead and kChain
template <bool kAhead, int kChain>
__device__ __forceinline__ void finish_variant(const float* __restrict__ partials,
                                               const unsigned char* __restrict__ live, int n_tiles,
                                               float* __restrict__ out, unsigned long long* stamps) {
  __shared__ __align__(16) float staged[kFinishTiles * kRow];
  __shared__ int tiles[kFinishTiles];
  __shared__ int warp_count[2][kWarps];
  constexpr int kChunks = kRow / 4;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float s = 0.0f;
  unsigned char next = kAhead && tid < n_tiles ? __ldcg(live + tid) : 0;
  for (int base = 0; base < n_tiles; base += kFinishTiles) {
    bool on;
    if constexpr (kAhead) {
      on = next != 0;
      const int ahead = base + kFinishTiles + tid;
      next = ahead < n_tiles ? __ldcg(live + ahead) : 0;
    } else {
      on = base + tid < n_tiles && __ldcg(live + base + tid) != 0;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, on);
    int* counts = warp_count[(base / kFinishTiles) & 1];
    if (lane == 0) counts[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, count = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      before += w < warp ? counts[w] : 0;
      count += counts[w];
    }
    if (count == 0) continue;
    if (on) tiles[before + __popc(ballot & ((1u << lane) - 1u))] = base + tid;
    __syncthreads();
    if (base == 0) stamp(stamps, 8);
    for (int e = tid; e < count * kChunks; e += lvs::kThreads) {
      const int j = e / kChunks, q = e - j * kChunks;
      const float* src = partials + static_cast<long long>(tiles[j]) * kRow + 4 * q;
      const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(staged + j * kRow + 4 * q));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    if (base == 0) stamp(stamps, 9);
    if (tid < kTerms) {
      if constexpr (kChain == 2) {
        const float* col = staged + tid;
        int j = 0;
        if (count >= kChainBatch) {
          float a[kChainBatch], b[kChainBatch];
  #pragma unroll
          for (int u = 0; u < kChainBatch; ++u) a[u] = col[u * kRow];
          while (true) {  // a holds batch j; the next batch's loads go out between its adds
            bool more = j + 2 * kChainBatch <= count;
  #pragma unroll
            for (int u = 0; u < kChainBatch; ++u) {
              if (more) b[u] = col[(j + kChainBatch + u) * kRow];
              s += a[u];
            }
            j += kChainBatch;
            if (!more) break;
            more = j + 2 * kChainBatch <= count;
  #pragma unroll
            for (int u = 0; u < kChainBatch; ++u) {
              if (more) a[u] = col[(j + kChainBatch + u) * kRow];
              s += b[u];
            }
            j += kChainBatch;
            if (!more) break;
          }
        }
        for (; j < count; ++j) s += col[j * kRow];
      } else {
        const float* col = staged + tid;
        int j = 0;
        if constexpr (kChain == 1) {
          for (; j + 2 * kChainBatch <= count; j += 2 * kChainBatch) {
            float a[kChainBatch], b[kChainBatch];
#pragma unroll
            for (int u = 0; u < kChainBatch; ++u) a[u] = col[(j + u) * kRow];
#pragma unroll
            for (int u = 0; u < kChainBatch; ++u) b[u] = col[(j + kChainBatch + u) * kRow];
#pragma unroll
            for (int u = 0; u < kChainBatch; ++u) s += a[u];
#pragma unroll
            for (int u = 0; u < kChainBatch; ++u) s += b[u];
          }
        }
#pragma unroll 8
        for (; j < count; ++j) s += col[j * kRow];
      }
    }
  }
  if (tid < kTerms) out[tid] = s;
}

template <bool kTiles, bool kFinish, bool kAcqRel, bool kAhead, int kChain>
__global__ void __launch_bounds__(lvs::kThreads)
variant(const float* __restrict__ src, const bool* __restrict__ src_ok, const float* __restrict__ cov_a,
        const float* __restrict__ T, const float* __restrict__ nn, const float* __restrict__ nn_dist,
        const bool* __restrict__ nn_valid, const float* __restrict__ cov_b, int n, float max_dist, int n_tiles,
        float* __restrict__ partials, unsigned char* __restrict__ live, int* __restrict__ counter,
        float* __restrict__ out, unsigned long long* __restrict__ stamps) {
  __shared__ float warp_sums[kTerms * kWarps];
  __shared__ bool last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  stamp(stamps, 0);
  if (stamps != nullptr && tid == 0) {
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    stamps[kStamps * blockIdx.x + 10] = sm;
  }
  if constexpr (kTiles) {
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const long long i = static_cast<long long>(t) * lvs::kThreads + tid;
      const bool need = i < n && lane_needed(src_ok, nn_valid, nn_dist, max_dist, i);
      const bool first = t == static_cast<int>(blockIdx.x);
      if (first && __syncthreads_or(need)) stamp(stamps, 4);
      float acc[kTerms];
#pragma unroll
      for (int m = 0; m < kTerms; ++m) acc[m] = 0.0f;
      if (need) {
        float y[3];
#pragma unroll
        for (int r = 0; r < 3; ++r)
          y[r] = lvs::fma64(src[3 * i + 2], T[4 * r + 2],
                            lvs::fma64(src[3 * i + 1], T[4 * r + 1], src[3 * i + 0] * T[4 * r + 0])) +
                 T[4 * r + 3];
        const float* ca = cov_a + 9 * i;
        const float* cb = cov_b + 9 * i;
        float rc[3][3], m[3][3];
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
          for (int b = 0; b < 3; ++b)
            rc[a][b] = (T[4 * a + 0] * ca[b] + T[4 * a + 1] * ca[3 + b]) + T[4 * a + 2] * ca[6 + b];
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
          for (int b = 0; b < 3; ++b)
            m[a][b] = (cb[3 * a + b] + ((rc[a][0] * T[4 * b + 0] + rc[a][1] * T[4 * b + 1]) +
                                        rc[a][2] * T[4 * b + 2])) + (a == b ? 1e-6f : 0.0f);
        float cof[3][3];
        cof[0][0] = m[1][1] * m[2][2] - m[1][2] * m[2][1];
        cof[0][1] = m[1][2] * m[2][0] - m[1][0] * m[2][2];
        cof[0][2] = m[1][0] * m[2][1] - m[1][1] * m[2][0];
        cof[1][0] = m[0][2] * m[2][1] - m[0][1] * m[2][2];
        cof[1][1] = m[0][0] * m[2][2] - m[0][2] * m[2][0];
        cof[1][2] = m[0][1] * m[2][0] - m[0][0] * m[2][1];
        cof[2][0] = m[0][1] * m[1][2] - m[0][2] * m[1][1];
        cof[2][1] = m[0][2] * m[1][0] - m[0][0] * m[1][2];
        cof[2][2] = m[0][0] * m[1][1] - m[0][1] * m[1][0];
        const float det = (m[0][0] * cof[0][0] + m[0][1] * cof[0][1]) + m[0][2] * cof[0][2];
        float wm[3][3];
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
          for (int b = 0; b < 3; ++b) wm[a][b] = cof[b][a] / det;
        const float d[3] = {y[0] - nn[3 * i + 0], y[1] - nn[3 * i + 1], y[2] - nn[3 * i + 2]};
        const float jac[3][6] = {{1.0f, 0.0f, 0.0f, 0.0f, y[2], -y[1]},
                                 {0.0f, 1.0f, 0.0f, -y[2], 0.0f, y[0]},
                                 {0.0f, 0.0f, 1.0f, y[1], -y[0], 0.0f}};
        float wj[3][6], wd[3];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
#pragma unroll
          for (int b = 0; b < 6; ++b)
            wj[a][b] = (wm[a][0] * jac[0][b] + wm[a][1] * jac[1][b]) + wm[a][2] * jac[2][b];
          wd[a] = (wm[a][0] * d[0] + wm[a][1] * d[1]) + wm[a][2] * d[2];
        }
#pragma unroll
        for (int a = 0; a < 6; ++a) {
#pragma unroll
          for (int b = 0; b < 6; ++b)
            acc[6 * a + b] = (jac[0][a] * wj[0][b] + jac[1][a] * wj[1][b]) + jac[2][a] * wj[2][b];
          acc[36 + a] = (jac[0][a] * wd[0] + jac[1][a] * wd[1]) + jac[2][a] * wd[2];
        }
      }
      if (first && __syncthreads_or(need)) stamp(stamps, 5);
      if (__ballot_sync(0xffffffffu, need) != 0) {
        int id[kTerms];
#pragma unroll
        for (int m = 0; m < kTerms; ++m) id[m] = m;
        warp_sums_to<kTerms, 16>(acc, id, warp_sums + warp, kWarps);
      } else {
        for (int m = lane; m < kTerms; m += 32) warp_sums[m * kWarps + warp] = 0.0f;
      }
      const bool any = __syncthreads_or(need);
      if (first) stamp(stamps, 6);
      if (any && tid < kTerms) {
        float s = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += warp_sums[tid * kWarps + w];
        partials[static_cast<long long>(t) * kRow + tid] = s;
      }
      if (tid == 0) live[t] = any;
      __syncthreads();
      if (first) stamp(stamps, 7);
    }
  }
  stamp(stamps, 1);
  if constexpr (kFinish) {
    if constexpr (kTiles && kAcqRel) {
      __syncthreads();
      if (tid == 0) {
        int before;
        asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;" : "=r"(before) : "l"(counter) : "memory");
        last = before == static_cast<int>(gridDim.x) - 1;
      }
      __syncthreads();
    } else if constexpr (kTiles) {
      __threadfence();
      __syncthreads();
      if (tid == 0) last = atomicAdd(counter, 1) == static_cast<int>(gridDim.x) - 1;
      __syncthreads();
      if (last) __threadfence();
    } else {
      if (tid == 0) last = true;
      __syncthreads();
    }
    stamp(stamps, 2);
    if (last) {
      finish_variant<kAhead, kChain>(partials, live, n_tiles, out, stamps);
      if (tid == 0) *counter = 0;
      stamp(stamps, 3);
    }
  }
}

}  // namespace

// mode 0: the shipped kernel (`gicp_normal`), no stamps; 1: the tiles
// alone; 2: the finish alone, one block over the rows and flags in scratch;
// 3: the shipped design (stamped); 4: the first one-launch design (fenced
// ticket, flags at each round's start, chain unrolled 8 deep); 5-7: the
// shipped design with one knob back (5: the fenced ticket, 6: the flags at
// each round's start, 7: the chain unrolled 8 deep, 8: the chain's next
// batch loaded between this batch's adds). blocks: the grid (0: the
// shipped kernel's choice; mode 2 one block).
extern "C" int k19b_variant(int mode, int blocks, const float* src, const bool* src_ok, const float* cov_a,
                            const float* T, const float* nn, const float* nn_dist, const bool* nn_valid,
                            const float* cov_b, int n, float max_dist, void* scratch, int* counter, float* out,
                            unsigned long long* stamps, cudaStream_t stream) {
  const int n_tiles = n > 0 ? lvs::blocks_for(n) : 1;
  auto* partials = static_cast<float*>(scratch);
  auto* live = reinterpret_cast<unsigned char*>(partials + static_cast<long long>(n_tiles) * kRow);
  if (blocks <= 0) {
    int device = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gicp_normal, lvs::kThreads, 0);
    const int most = sms * (per_sm > 0 ? per_sm : 1);
    blocks = n_tiles < most ? n_tiles : most;
  }
#define LVS_ARGS src, src_ok, cov_a, T, nn, nn_dist, nn_valid, cov_b, n, max_dist, n_tiles, partials, live, counter, out
#define LVS_VARIANT(...) variant<__VA_ARGS__><<<mode == 2 ? 1 : blocks, lvs::kThreads, 0, stream>>>(LVS_ARGS, stamps)
  switch (mode) {
    case 0: gicp_normal<<<blocks, lvs::kThreads, 0, stream>>>(LVS_ARGS); break;
    case 1: LVS_VARIANT(true, false, true, true, 1); break;
    case 2: LVS_VARIANT(false, true, true, true, 1); break;
    case 3: LVS_VARIANT(true, true, true, true, 1); break;
    case 4: LVS_VARIANT(true, true, false, false, 0); break;
    case 5: LVS_VARIANT(true, true, false, true, 1); break;
    case 6: LVS_VARIANT(true, true, true, false, 1); break;
    case 7: LVS_VARIANT(true, true, true, true, 0); break;
    default: LVS_VARIANT(true, true, true, true, 2); break;
  }
#undef LVS_VARIANT
#undef LVS_ARGS
  LVS_RETURN_LAST_ERROR();
}
