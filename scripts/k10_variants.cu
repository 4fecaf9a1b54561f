// Design variants of kernel 10 (the LFA line / plane fits over the cell
// tables), timed side by side by `scripts/k10_variants.py`. The file
// includes the shipped source (`lv_slam_tpu_torch/csrc/lfa_fit.cu`: G lanes
// per query stage its 8 x S candidates in shared memory, then one thread
// per query runs the ordered sums, the eigh and the writes), so its kernels
// run here at other group sizes and block sizes. Beside them, two designs
// it replaced, both holding the same sums in the same order:
// - grouped: lane 0 of each query's group runs the chains over the
//   group's staged slice, in the warp that staged it;
// - relayed: each lane keeps its probe's slots in registers and the
//   running sums pass from lane to lane by shuffles, lane t adding its
//   participants after lanes 0..t-1 (a skipped non-participant adds an
//   exact zero in the shipped sums, so the bits are the same).
// And lines kernels of the shipped and the relayed design with clock
// stamps between their phases.
#include "lfa_fit.cu"

namespace {

// ------------------------------------------------------- the relayed design

// A query's lane in its group of G: lane gl holds probes o = gl * P + p,
// p < P, in candidate order; `base` is the warp lane of the group's lane 0.
template <int G>
struct Group {
  static constexpr int P = 8 / G;
  int gl, base;
  const float4* row[P];     // the probe's bucket row; nullptr if an earlier probe holds its bucket
  unsigned use[P];          // the probe's participating slots, bit s for slot s
  float4 first[P][kChunk];  // the row's first kChunk slots
};

// Hashes the lane's probes, drops those whose bucket an earlier probe of the
// group holds, issues every read of the kept rows and gates the candidates.
template <int G>
__device__ __forceinline__ Group<G> gather(const float* __restrict__ table, int n_buckets, int slots, float cs,
                                           float qx, float qy, float qz) {
  constexpr int P = Group<G>::P;
  Group<G> g;
  const int lane = threadIdx.x & 31;
  g.gl = lane % G;
  g.base = lane - g.gl;
  const float half = cs / 2.0f;
  const int b0 = static_cast<int>(floorf((qx - half) / cs));
  const int b1 = static_cast<int>(floorf((qy - half) / cs));
  const int b2 = static_cast<int>(floorf((qz - half) / cs));
  int bucket[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int o = g.gl * P + p;
    const unsigned h = (static_cast<unsigned>(b0 + (o >> 2)) * kH1) ^
                       (static_cast<unsigned>(b1 + ((o >> 1) & 1)) * kH2) ^
                       (static_cast<unsigned>(b2 + (o & 1)) * kH3);
    bucket[p] = static_cast<int>(h % static_cast<unsigned>(n_buckets));
  }
  bool dup[P];
#pragma unroll
  for (int p = 0; p < P; ++p) dup[p] = false;
#pragma unroll
  for (int e = 0; e < 8; ++e) {  // probe e's bucket, from the lane that holds it
    const int be = __shfl_sync(kFull, bucket[e % P], g.base + e / P);
#pragma unroll
    for (int p = 0; p < P; ++p) dup[p] |= e < g.gl * P + p && be == bucket[p];
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    g.row[p] = dup[p] ? nullptr
                      : reinterpret_cast<const float4*>(table) + static_cast<long long>(bucket[p]) * slots;
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      g.first[p][j] = g.row[p] != nullptr && j < slots ? __ldg(g.row[p] + j) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    unsigned use = 0;
#pragma unroll
    for (int j = 0; j < kChunk; ++j) use |= takes_part(g.first[p][j], qx, qy, qz) ? 1u << j : 0u;
    if (g.row[p] != nullptr)
      for (int s = kChunk; s < slots; ++s) use |= takes_part(__ldg(g.row[p] + s), qx, qy, qz) ? 1u << s : 0u;
    g.use[p] = use;
  }
  return g;
}

// f(point) for each of the lane's participants, in candidate order.
template <int G, class F>
__device__ __forceinline__ void for_participants(const Group<G>& g, int slots, F&& f) {
#pragma unroll
  for (int p = 0; p < Group<G>::P; ++p) {
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      if ((g.use[p] >> j) & 1u) f(g.first[p][j]);
    for (int s = kChunk; s < slots; ++s)
      if ((g.use[p] >> s) & 1u) f(__ldg(g.row[p] + s));
  }
}

// The group's ordered sums acc[0..M) of add(point, acc) over the
// participants: lane t adds its own after lanes 0..t-1 (candidate order),
// then hands the running sums on by a shuffle; every lane ends with them.
template <int G, int M, class F>
__device__ __forceinline__ void relay(const Group<G>& g, int slots, float (&acc)[M], F&& add) {
#pragma unroll
  for (int t = 0; t < G; ++t) {
    if (g.gl == t) for_participants(g, slots, [&](float4 c) { add(c, acc); });
#pragma unroll
    for (int m = 0; m < M; ++m) acc[m] = __shfl_sync(kFull, acc[m], g.base + t);
  }
}

// `fit` over the group's participants: the same sums in the same order.
template <int G>
__device__ __forceinline__ Fit group_fit(const Group<G>& g, int slots) {
  int n = 0;
#pragma unroll
  for (int p = 0; p < Group<G>::P; ++p) n += __popc(g.use[p]);
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) n += __shfl_xor_sync(kFull, n, off);
  Fit f;
  f.n_use = static_cast<float>(n);
  const float cnt = fmaxf(f.n_use, 1.0f);
  float s[3] = {0.0f, 0.0f, 0.0f};
  relay(g, slots, s, [](float4 c, float (&a)[3]) {
    a[0] = a[0] + c.x;
    a[1] = a[1] + c.y;
    a[2] = a[2] + c.z;
  });
  for (int j = 0; j < 3; ++j) f.mu[j] = s[j] / cnt;
  float c6[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  relay(g, slots, c6, [&f](float4 c, float (&a)[6]) {
    const float d0 = c.x - f.mu[0], d1 = c.y - f.mu[1], d2 = c.z - f.mu[2];
    a[0] = a[0] + d0 * d0;
    a[1] = a[1] + d0 * d1;
    a[2] = a[2] + d0 * d2;
    a[3] = a[3] + d1 * d1;
    a[4] = a[4] + d1 * d2;
    a[5] = a[5] + d2 * d2;
  });
  for (int j = 0; j < 6; ++j) f.cov[j] = c6[j] / cnt;
  return f;
}

// The query of this thread's group; a group past the last query runs query
// q - 1 and writes nothing. False for a warp wholly past the last query.
template <int G>
__device__ __forceinline__ bool relay_query(int q, int* i, int* iq) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if ((t - (threadIdx.x & 31)) / G >= q) return false;  // uniform over the warp
  *i = static_cast<int>(t / G);
  *iq = *i < q ? *i : q - 1;
  return true;
}

template <int G>
__global__ void __launch_bounds__(lvs::kThreads)
    lines_relay(const float* __restrict__ y, const bool* __restrict__ mask, int q, const float* __restrict__ table,
          int n_buckets, int slots, float cs, int k, float* __restrict__ mu, float* __restrict__ v,
          bool* __restrict__ valid) {
  int i, iq;
  if (!relay_query<G>(q, &i, &iq)) return;
  const Group<G> g = gather<G>(table, n_buckets, slots, cs, y[3 * iq + 0], y[3 * iq + 1], y[3 * iq + 2]);
  const Fit f = group_fit(g, slots);
  if (g.gl == 0 && i < q) write_line(f, i, mask[i], k, mu, v, valid);
}

template <int G>
__global__ void __launch_bounds__(lvs::kThreads)
    planes_relay(const float* __restrict__ y, const bool* __restrict__ mask, int q, const float* __restrict__ table,
           int n_buckets, int slots, float cs, int k, float* __restrict__ normal, float* __restrict__ offset,
           bool* __restrict__ valid) {
  int i, iq;
  if (!relay_query<G>(q, &i, &iq)) return;
  const Group<G> g = gather<G>(table, n_buckets, slots, cs, y[3 * iq + 0], y[3 * iq + 1], y[3 * iq + 2]);
  const Fit f = group_fit(g, slots);
  lvs::Vec3 n;
  float d;
  plane_frame(f, &n, &d);
  bool flat = true;
  for_participants(g, slots, [&](float4 c) { flat &= near_plane(c.x, c.y, c.z, n, d); });
  const unsigned far = (__ballot_sync(kFull, !flat) >> g.base) & ((1u << G) - 1u);
  if (g.gl == 0 && i < q) write_plane(f, n, d, far == 0u, i, mask[i], k, normal, offset, valid);
}

// ------------------------------------------------------- the grouped design

// The query of this thread's group of G; a group past the last query runs
// query q - 1 and writes nothing. False for a warp wholly past the last
// query. `stage` becomes the group's slice of the block's shared memory.
template <int G>
__device__ __forceinline__ bool grouped_query(int q, int slots, int* i, int* iq, float4** stage) {
  extern __shared__ float4 block_stage[];
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if ((t - (threadIdx.x & 31)) / G >= q) return false;  // uniform over the warp
  *i = static_cast<int>(t / G);
  *iq = *i < q ? *i : q - 1;
  *stage = block_stage + (threadIdx.x / G) * 8 * slots;
  return true;
}

template <int G>
__global__ void __launch_bounds__(lvs::kThreads)
    lines_grouped(const float* __restrict__ y, const bool* __restrict__ mask, int q, const float* __restrict__ table,
          int n_buckets, int slots, float cs, int k, float* __restrict__ mu, float* __restrict__ v,
          bool* __restrict__ valid) {
  int i, iq;
  float4* stage;
  if (!grouped_query<G>(q, slots, &i, &iq, &stage)) return;
  stage_candidates<G>(stage, table, n_buckets, slots, cs, y[3 * iq + 0], y[3 * iq + 1], y[3 * iq + 2]);
  __syncwarp();
  if (threadIdx.x % G == 0 && i < q) write_line(staged_fit(stage, slots), i, mask[i], k, mu, v, valid);
}

template <int G>
__global__ void __launch_bounds__(lvs::kThreads)
    planes_grouped(const float* __restrict__ y, const bool* __restrict__ mask, int q, const float* __restrict__ table,
           int n_buckets, int slots, float cs, int k, float* __restrict__ normal, float* __restrict__ offset,
           bool* __restrict__ valid) {
  int i, iq;
  float4* stage;
  if (!grouped_query<G>(q, slots, &i, &iq, &stage)) return;
  stage_candidates<G>(stage, table, n_buckets, slots, cs, y[3 * iq + 0], y[3 * iq + 1], y[3 * iq + 2]);
  __syncwarp();
  const Fit f = staged_fit(stage, slots);
  lvs::Vec3 n;
  float d;
  plane_frame(f, &n, &d);
  const int gl = threadIdx.x % G;
  bool flat = true;  // each lane tests every G-th candidate
  for (int c = gl; c < 8 * slots; c += G) {
    const float4 p = stage[c];
    if (p.w != 0.0f) flat &= near_plane(p.x, p.y, p.z, n, d);
  }
  const unsigned far = (__ballot_sync(kFull, !flat) >> ((threadIdx.x & 31) - gl)) & ((1u << G) - 1u);
  if (gl == 0 && i < q) write_plane(f, n, d, far == 0u, i, mask[i], k, normal, offset, valid);
}

// ------------------------------------------------------- clock stamps

// The SM clock after `dep` is ready (the operand orders the read after it).
__device__ __forceinline__ long long stamp(float dep) {
  long long t;
  asm volatile("{\n\t.reg .f32 d;\n\tmov.f32 d, %1;\n\tmov.u64 %0, %%clock64;\n\t}" : "=l"(t) : "f"(dep));
  return t;
}

// lines<kGroup> with clock stamps: thread 0 of each block (the chain
// thread of the block's first query) writes its cycles to the query read,
// the block's candidates staged, the mean's sums, the covariance's sums,
// and the eigh with the writes (5 per block).
__global__ void __launch_bounds__(lvs::kThreads)
    lines_stamped(const float* __restrict__ y, const bool* __restrict__ mask, int q, const float* __restrict__ table,
                  int n_buckets, int slots, float cs, int k, float* __restrict__ mu, float* __restrict__ v,
                  bool* __restrict__ valid, long long* __restrict__ cycles) {
  extern __shared__ float4 stage[];
  const long long t0 = stamp(0.0f);
  const int per_block = blockDim.x / kGroup, first = blockIdx.x * per_block;
  const int j = threadIdx.x / kGroup, iq = min(first + j, q - 1);
  const float qx = y[3 * iq + 0], qy = y[3 * iq + 1], qz = y[3 * iq + 2];
  const long long t1 = stamp(qx + qy + qz);
  stage_candidates<kGroup>(stage + j * slice(slots), table, n_buckets, slots, cs, qx, qy, qz);
  __syncthreads();
  const int i = first + threadIdx.x;
  const float4* mine = stage + threadIdx.x * slice(slots);
  const long long t2 = stamp(threadIdx.x < per_block ? mine[0].w : 0.0f);
  if (threadIdx.x >= per_block || i >= q) return;
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, n = 0.0f;
  for (int c0 = 0; c0 < slots; ++c0) {
    float4 p[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) p[j] = mine[8 * c0 + j];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s0 = s0 + p[j].x;
      s1 = s1 + p[j].y;
      s2 = s2 + p[j].z;
      n = n + p[j].w;
    }
  }
  Fit f;
  const float cnt = fmaxf(n, 1.0f);
  f.n_use = n;
  f.mu[0] = s0 / cnt;
  f.mu[1] = s1 / cnt;
  f.mu[2] = s2 / cnt;
  const long long t3 = stamp(f.mu[0] + f.mu[1] + f.mu[2]);
  float c6[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int c0 = 0; c0 < slots; ++c0) {
    float4 p[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) p[j] = mine[8 * c0 + j];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float d0 = (p[j].x - f.mu[0]) * p[j].w, d1 = (p[j].y - f.mu[1]) * p[j].w,
                  d2 = (p[j].z - f.mu[2]) * p[j].w;
      c6[0] = c6[0] + d0 * d0;
      c6[1] = c6[1] + d0 * d1;
      c6[2] = c6[2] + d0 * d2;
      c6[3] = c6[3] + d1 * d1;
      c6[4] = c6[4] + d1 * d2;
      c6[5] = c6[5] + d2 * d2;
    }
  }
  for (int j = 0; j < 6; ++j) f.cov[j] = c6[j] / cnt;
  const long long t4 = stamp(f.cov[0] + f.cov[1] + f.cov[2] + f.cov[3] + f.cov[4] + f.cov[5]);
  write_line(f, i, mask[i], k, mu, v, valid);
  const long long t5 = stamp(v[3 * i]);
  if (threadIdx.x == 0) {
    long long* w = cycles + 5 * static_cast<long long>(blockIdx.x);
    w[0] = t1 - t0;
    w[1] = t2 - t1;
    w[2] = t3 - t2;
    w[3] = t4 - t3;
    w[4] = t5 - t4;
  }
}

// lines_relay<kGroup> with clock stamps: the query read, the rows gathered
// and gated, the mean's relay, the covariance's relay, the eigh and writes.
__global__ void __launch_bounds__(lvs::kThreads)
    lines_relay_stamped(const float* __restrict__ y, const bool* __restrict__ mask, int q,
                        const float* __restrict__ table, int n_buckets, int slots, float cs, int k,
                        float* __restrict__ mu, float* __restrict__ v, bool* __restrict__ valid,
                        long long* __restrict__ cycles) {
  constexpr int G = kGroup;
  int i, iq;
  const long long t0 = stamp(0.0f);
  if (!relay_query<G>(q, &i, &iq)) return;
  const float qx = y[3 * iq + 0], qy = y[3 * iq + 1], qz = y[3 * iq + 2];
  const long long t1 = stamp(qx + qy + qz);
  const Group<G> g = gather<G>(table, n_buckets, slots, cs, qx, qy, qz);
  const long long t2 = stamp(static_cast<float>(g.use[0]));
  int n = __popc(g.use[0]);
  for (int off = G / 2; off > 0; off >>= 1) n += __shfl_xor_sync(kFull, n, off);
  Fit f;
  f.n_use = static_cast<float>(n);
  const float cnt = fmaxf(f.n_use, 1.0f);
  float s[3] = {0.0f, 0.0f, 0.0f};
  relay(g, slots, s, [](float4 c, float (&a)[3]) {
    a[0] = a[0] + c.x;
    a[1] = a[1] + c.y;
    a[2] = a[2] + c.z;
  });
  for (int j = 0; j < 3; ++j) f.mu[j] = s[j] / cnt;
  const long long t3 = stamp(f.mu[0] + f.mu[1] + f.mu[2]);
  float c6[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  relay(g, slots, c6, [&f](float4 c, float (&a)[6]) {
    const float d0 = c.x - f.mu[0], d1 = c.y - f.mu[1], d2 = c.z - f.mu[2];
    a[0] = a[0] + d0 * d0;
    a[1] = a[1] + d0 * d1;
    a[2] = a[2] + d0 * d2;
    a[3] = a[3] + d1 * d1;
    a[4] = a[4] + d1 * d2;
    a[5] = a[5] + d2 * d2;
  });
  for (int j = 0; j < 6; ++j) f.cov[j] = c6[j] / cnt;
  const long long t4 = stamp(f.cov[0] + f.cov[1] + f.cov[2] + f.cov[3] + f.cov[4] + f.cov[5]);
  if (g.gl == 0 && i < q) write_line(f, i, mask[i], k, mu, v, valid);
  const long long t5 = stamp(g.gl == 0 && i < q ? v[3 * i] : 0.0f);
  if ((threadIdx.x & 31) == 0) {
    long long* w = cycles + 5 * ((static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / 32);
    w[0] = t1 - t0;
    w[1] = t2 - t1;
    w[2] = t3 - t2;
    w[3] = t4 - t3;
    w[4] = t5 - t4;
  }
}

using FitKernel = void (*)(const float*, const bool*, int, const float*, int, int, float, int, float*, float*, bool*);

// design 0 the shipped kernels, 1 relayed, 2 grouped
template <int G>
int launch(int kind, int design, int threads, const float* y, const bool* mask, int q, const float* table,
           int n_buckets, int slots, float cs, int k, float* out3, float* second, bool* valid, cudaStream_t stream) {
  if (design == 0)
    return launch_fit<G>(kind ? planes<G> : lines<G>, threads, q, slots, stream, y, mask, q, table, n_buckets, slots,
                         cs, k, out3, second, valid);
  FitKernel fn =
      design == 1 ? (kind ? planes_relay<G> : lines_relay<G>) : (kind ? planes_grouped<G> : lines_grouped<G>);
  const int smem = design == 2 ? threads / G * 8 * slots * static_cast<int>(sizeof(float4)) : 0;
  if (smem > 48 * 1024) cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const long long n = static_cast<long long>(q) * G;
  if (q > 0)
    fn<<<static_cast<int>((n + threads - 1) / threads), threads, smem, stream>>>(y, mask, q, table, n_buckets, slots,
                                                                                 cs, k, out3, second, valid);
  LVS_RETURN_LAST_ERROR();
}

}  // namespace

// kind 0 lines, 1 planes; g lanes per query (1, 2, 4, 8); design 0 the
// shipped kernels, 1 relayed by shuffles, 2 grouped
extern "C" int k10v_fit(int kind, int g, int design, int threads, const float* y, const bool* mask, int q,
                        const float* table, int n_buckets, int slots, float cs, int k, float* out3, float* second,
                        bool* valid, cudaStream_t stream) {
  if (int err = table_args(table, slots)) return err;
  if (threads % 32 != 0 || threads < 32 || threads > lvs::kThreads) return static_cast<int>(cudaErrorInvalidValue);
  auto fn = g == 1 ? launch<1> : g == 2 ? launch<2> : g == 4 ? launch<4> : g == 8 ? launch<8> : nullptr;
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return fn(kind, design, threads, y, mask, q, table, n_buckets, slots, cs, k, out3, second, valid, stream);
}

// lines<kGroup> (relayed 0: 5 stamps per block) or lines_relay<kGroup> (1:
// 5 per warp) with clock stamps, 256 threads
extern "C" int k10v_lines_stamped(int relayed, const float* y, const bool* mask, int q, const float* table,
                                  int n_buckets, int slots, float cs, int k, float* mu, float* v, bool* valid,
                                  long long* cycles, cudaStream_t stream) {
  if (int err = table_args(table, slots)) return err;
  if (relayed) {
    if (q > 0)
      lines_relay_stamped<<<lvs::blocks_for(static_cast<long long>(q) * kGroup), lvs::kThreads, 0, stream>>>(
          y, mask, q, table, n_buckets, slots, cs, k, mu, v, valid, cycles);
    LVS_RETURN_LAST_ERROR();
  }
  return launch_fit<kGroup>(lines_stamped, lvs::kThreads, q, slots, stream, y, mask, q, table, n_buckets, slots, cs,
                            k, mu, v, valid, cycles);
}
