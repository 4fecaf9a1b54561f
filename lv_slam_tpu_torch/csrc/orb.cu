// Kernel 12: ORB over a 3-level image pyramid, a batch of images at once.
//
// Replaces: lv_slam_tpu/ops/orb.py:200 `_detect_pyramid_batch` (with :76
// `detect_and_compute`, :165 `_pack_bits_device`, :176 `_pyramid_body` and
// :310 `_halve`).
//
// What bounds it on the card: a (4, 128, 256) uint8 stack is 128 KB in and
// 4 x 511 x 37 bytes out, a microsecond of HBM; the work is ~100 operations
// per pixel (FAST circle, suppression, blur) and ~6000 per keypoint (the
// 709-pixel disc moments, 256 rotated pairs), a few microseconds of the
// card's float32 rate. Launch latency of the ~15 launches bounds it in
// practice.
//
// Design: one C call (`lvs_orb_detect`) launches every level's kernels, each
// over the whole batch, with no host read and no torch op between them; its
// images, score, blur, candidate and top-K buffers lie in one scratch
// allocation (`lvs_orb_scratch_bytes`).
// - `orb_level0` widens the uint8 images to float32; `orb_halve` makes the
//   next level's 2x2 means (exact: every level is a multiple of 1/16).
// - `orb_pixels`, one thread per pixel: the 16 wrapped circle loads,
//   bright / dark as 16-bit masks, a run of 9 found on the doubled mask,
//   the score summed in circle order (exact), and the wrapped 3x3 box sum
//   that BRIEF compares (the reference divides it by 9, which orders the
//   values as the exact sums do). It also zeroes the image's kept count.
// - `orb_keys`, one thread per pixel, blocks of one image: wrapped 3x3
//   suppression and the border decide `keep`; a warp ballot writes the
//   image's keep bitmask word and appends the kept pixels' ranking keys
//   (score bits << 32 | ~flat index) to the image's candidate list, one
//   atomicAdd a warp (the list's order is arbitrary; the keys are unique).
// - `orb_select`, a block per image: `lax.top_k`'s rows without sorting
//   the image. Every pixel that is not kept has the key ~flat index, below
//   every kept key, so the top K are the kept pixels by key, descending,
//   then the lowest-indexed pixels that are not kept, by index. The kept
//   keys are bitonic-sorted in shared memory; past kSelectCap of them, a
//   radix select over the list (8 rounds of 8-bit digit counts) finds the
//   kSelectCap-th largest key below the last cut, the keys between are
//   gathered and sorted, and so on until K rows are written. The j-th
//   pixel that is not kept lies below flat index n_kept + j < K, so the
//   fill scans the bitmask's first ceil(K / 32) words with a block scan of
//   their zero counts.
// - `orb_describe`, one warp per keypoint: the disc moments in float64
//   (exact) with a warp reduction, theta = atan2 in float64 rounded to
//   float32 and its cos / sin likewise, 8 of the 256 pairs per lane rotated
//   in float64 (exact products) and rounded half to even (`rint`), clipped,
//   compared; `__ballot_sync` collects each 32-pair word and every lane
//   writes one descriptor byte in np.packbits order; lane 0 writes the
//   keypoint (times 2^level, int16 little-endian) and the valid flag.
#include "common.cuh"
#include "key_sort.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

__constant__ int kCircleY[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int kCircleX[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};

__device__ __forceinline__ int wrap(int v, int n) {
  v %= n;
  return v < 0 ? v + n : v;
}

__global__ void orb_level0(const uint8_t* __restrict__ in, int n, float* __restrict__ out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = static_cast<float>(in[i]);
}

__global__ void orb_halve(const float* __restrict__ in, int b, int h, int w, float* __restrict__ out) {
  int ho = h / 2, wo = w / 2;
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(b) * ho * wo) return;
  int x = static_cast<int>(i % wo);
  int y = static_cast<int>((i / wo) % ho);
  long long img = i / (static_cast<long long>(ho) * wo);
  const float* p = in + img * h * w + static_cast<long long>(2 * y) * w + 2 * x;
  out[i] = (p[0] + p[1] + p[w] + p[w + 1]) / 4.0f;
}

// per pixel: FAST-9 score (0 off corners) and the wrapped 3x3 box sum
__global__ void orb_pixels(const float* __restrict__ img, int b, int h, int w, float threshold,
                           float* __restrict__ score, float* __restrict__ blur, int* __restrict__ n_kept) {
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(b) * h * w) return;
  if (i % (static_cast<long long>(h) * w) == 0) n_kept[i / (static_cast<long long>(h) * w)] = 0;
  int x = static_cast<int>(i % w);
  int y = static_cast<int>((i / w) % h);
  const float* im = img + (i / (static_cast<long long>(h) * w)) * h * w;
  float c = im[static_cast<long long>(y) * w + x];
  float hi = c + threshold, lo = c - threshold;
  unsigned bright = 0, dark = 0;
  float nb[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    nb[k] = im[static_cast<long long>(wrap(y + kCircleY[k], h)) * w + wrap(x + kCircleX[k], w)];
    if (nb[k] > hi) bright |= 1u << k;
    if (nb[k] < lo) dark |= 1u << k;
  }
  unsigned b2 = bright | (bright << 16), d2 = dark | (dark << 16);
  bool corner = false;
#pragma unroll
  for (int s = 0; s < 16; ++s) {
    corner |= ((b2 >> s) & 0x1ffu) == 0x1ffu;
    corner |= ((d2 >> s) & 0x1ffu) == 0x1ffu;
  }
  float sb = 0.0f, sd = 0.0f;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    if ((bright >> k) & 1u) sb = sb + ((nb[k] - c) - threshold);
    if ((dark >> k) & 1u) sd = sd + ((c - nb[k]) - threshold);
  }
  score[i] = corner ? fmaxf(sb, sd) : 0.0f;
  float acc = 0.0f;
  for (int dy = -1; dy <= 1; ++dy)
    for (int dx = -1; dx <= 1; ++dx)
      acc = acc + im[static_cast<long long>(wrap(y - dy, h)) * w + wrap(x - dx, w)];
  blur[i] = acc;
}

// per pixel of image blockIdx.y: keep (suppression with wrap, border) into
// the bitmask, and the kept pixels' ranking keys appended to the image's list
__global__ void orb_keys(const float* __restrict__ score, int h, int w, int border, unsigned* __restrict__ bits,
                         unsigned long long* __restrict__ cand, int* __restrict__ n_kept) {
  const int hw = h * w, bi = blockIdx.y, lane = threadIdx.x & 31;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const float* sc = score + static_cast<long long>(bi) * hw;
  bool keep = false;
  unsigned long long key = 0;
  if (i < hw) {
    int x = i % w, y = i / w;
    float s = sc[i];
    float nmax = s;
    for (int dy = -1; dy <= 1; ++dy)
      for (int dx = -1; dx <= 1; ++dx) nmax = fmaxf(nmax, sc[wrap(y + dy, h) * w + wrap(x + dx, w)]);
    bool inside = y >= border && y < h - border && x >= border && x < w - border;
    keep = s > 0.0f && s >= nmax && inside;
    key = (static_cast<unsigned long long>(__float_as_uint(s)) << 32) | (0xffffffffull - static_cast<unsigned>(i));
  }
  const unsigned ballot = __ballot_sync(kFull, keep);
  if (i - lane >= hw) return;  // whole warps past the image
  if (lane == 0) bits[static_cast<long long>(bi) * ((hw + 31) / 32) + i / 32] = ballot;
  if (ballot == 0) return;
  int base = 0;
  if (lane == 0) base = atomicAdd(&n_kept[bi], __popc(ballot));
  base = __shfl_sync(kFull, base, 0);
  if (keep) cand[static_cast<long long>(bi) * hw + base + __popc(ballot & ((1u << lane) - 1u))] = key;
}

constexpr int kSelectThreads = 512;
constexpr int kSelectCap = 4096;  // kept keys sorted in shared memory at once (32 KB)

// s[0, p) (p a power of two, at most kSelectCap) sorted descending. A step
// of stride 16 or less pairs elements inside each warp's own 64-element
// slices, as its next step does unless that one's stride is 32 or more, so
// only those steps need the block's barrier; the last one always takes it.
__device__ void bitonic_desc(unsigned long long* s, int p) {
  for (int size = 2; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < p / 2; t += blockDim.x) {
        int lo = 2 * t - (t & (stride - 1)), hi = lo + stride;
        unsigned long long a = s[lo], c = s[hi];
        if ((a < c) == ((lo & size) == 0)) {
          s[lo] = c;
          s[hi] = a;
        }
      }
      if (stride >= 32 || (stride == 1 && (size >= 32 || size == p)))
        __syncthreads();
      else
        __syncwarp();
    }
  }
}

// the t-th largest (t >= 1) of the unique keys list[0, n) below `below`
__device__ unsigned long long select_kth(const unsigned long long* list, int n, unsigned long long below, int t,
                                         unsigned* hist, int* pick) {
  unsigned long long prefix = 0, mask = 0;
  for (int shift = 56; shift >= 0; shift -= 8) {
    for (int d = threadIdx.x; d < 256; d += blockDim.x) hist[d] = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      unsigned long long key = list[i];
      if (key < below && (key & mask) == prefix) atomicAdd(&hist[(key >> shift) & 255], 1u);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      int d = 255;
      unsigned above = 0;
      while (d > 0 && above + hist[d] < static_cast<unsigned>(t)) above += hist[d--];
      pick[0] = d;
      pick[1] = t - static_cast<int>(above);
    }
    __syncthreads();
    prefix |= static_cast<unsigned long long>(pick[0]) << shift;
    mask |= 0xffull << shift;
    t = pick[1];
    __syncthreads();
  }
  return prefix;
}

// a block per image: its K ranking keys in lax.top_k's order
__global__ void __launch_bounds__(kSelectThreads)
orb_select(const unsigned long long* __restrict__ cand, const unsigned* __restrict__ bits,
           const int* __restrict__ n_kept, int hw, int k, unsigned long long* __restrict__ top) {
  __shared__ unsigned long long s[kSelectCap];
  __shared__ unsigned hist[256];
  __shared__ int pick[2];
  __shared__ int n_gathered;
  const int bi = blockIdx.x, n = n_kept[bi], m = min(n, k);
  const unsigned long long* list = cand + static_cast<long long>(bi) * hw;
  top += static_cast<long long>(bi) * k;

  // the kept pixels, kSelectCap keys a round, each round's keys below the last
  unsigned long long below = ~0ull;
  for (int done = 0; done < m;) {
    const int want = min(kSelectCap, m - done);
    unsigned long long cut = 0;
    if (n > kSelectCap) {
      cut = select_kth(list, n, below, want, hist, pick);
      if (threadIdx.x == 0) n_gathered = 0;
      __syncthreads();
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        unsigned long long key = list[i];
        if (key >= cut && key < below) s[atomicAdd(&n_gathered, 1)] = key;
      }
    } else {
      for (int i = threadIdx.x; i < n; i += blockDim.x) s[i] = list[i];
    }
    const int have = n > kSelectCap ? want : n;
    int p = 1;
    while (p < have) p <<= 1;
    for (int i = have + threadIdx.x; i < p; i += blockDim.x) s[i] = 0;  // below every kept key
    __syncthreads();
    bitonic_desc(s, p);
    for (int r = threadIdx.x; r < want; r += blockDim.x) top[done + r] = s[r];
    done += want;
    below = cut;
    __syncthreads();
  }

  // rows m..k: the pixels that are not kept, lowest flat index first
  const int need = k - m;
  if (need <= 0) return;
  const unsigned* word = bits + static_cast<long long>(bi) * ((hw + 31) / 32);
  const int n_words = (k + 31) / 32;
  int carry = 0;
  for (int w0 = 0; w0 < n_words && carry < need; w0 += blockDim.x) {
    const int wi = w0 + threadIdx.x;
    unsigned zeros = wi < n_words ? ~word[wi] : 0u;
    unsigned total;
    int rank = carry + static_cast<int>(lvs::keysort::block_exclusive_scan(__popc(zeros), &total));
    for (; zeros && rank < need; zeros &= zeros - 1, ++rank)
      top[m + rank] = 0xffffffffull - static_cast<unsigned>(32 * wi + __ffs(zeros) - 1);
    carry += static_cast<int>(total);
  }
}

// one warp per (image, keypoint rank): orientation, steered BRIEF, packed row
__global__ void orb_describe(const float* __restrict__ img, const float* __restrict__ blur,
                             const long long* __restrict__ top, const int8_t* __restrict__ disc, int n_disc,
                             const int8_t* __restrict__ pattern, int b, int h, int w, int k, int level,
                             int row0, int rows_total, uint8_t* __restrict__ out) {
  long long gw = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  int lane = threadIdx.x & 31;
  if (gw >= static_cast<long long>(b) * k) return;  // whole warps exit together
  int bi = static_cast<int>(gw / k), r = static_cast<int>(gw % k);
  unsigned long long key = static_cast<unsigned long long>(top[gw]);
  bool valid = (key >> 32) != 0;
  int idx = static_cast<int>(0xffffffffull - (key & 0xffffffffull));
  int ky = idx / w, kx = idx % w;
  const float* im = img + static_cast<long long>(bi) * h * w;
  const float* bl = blur + static_cast<long long>(bi) * h * w;

  // intensity centroid over the disc (patch clipped, as the reference)
  double m10 = 0.0, m01 = 0.0;
  for (int t = lane; t < n_disc; t += 32) {
    int dy = disc[2 * t], dx = disc[2 * t + 1];
    int py = min(max(ky + dy, 0), h - 1), px = min(max(kx + dx, 0), w - 1);
    double p = static_cast<double>(im[static_cast<long long>(py) * w + px]);
    m10 = __dadd_rn(m10, __dmul_rn(p, static_cast<double>(dx)));
    m01 = __dadd_rn(m01, __dmul_rn(p, static_cast<double>(dy)));
  }
  for (int off = 16; off > 0; off >>= 1) {
    m10 = __dadd_rn(m10, __shfl_xor_sync(kFull, m10, off));
    m01 = __dadd_rn(m01, __shfl_xor_sync(kFull, m01, off));
  }
  float theta = static_cast<float>(atan2(m01, m10));
  double ct = static_cast<double>(static_cast<float>(cos(static_cast<double>(theta))));
  double st = static_cast<double>(static_cast<float>(sin(static_cast<double>(theta))));
  double fy = static_cast<double>(ky), fx = static_cast<double>(kx);

  unsigned words[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int8_t* q = pattern + 4 * (lane + 32 * i);
    double v[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      double y = static_cast<double>(q[2 * e]), x = static_cast<double>(q[2 * e + 1]);
      // x' = x cos - y sin, y' = x sin + y cos
      double ry = __dadd_rn(__dmul_rn(x, st), __dmul_rn(y, ct));
      double rx = __dsub_rn(__dmul_rn(x, ct), __dmul_rn(y, st));
      int sy = min(max(static_cast<int>(rint(__dadd_rn(fy, ry))), 0), h - 1);
      int sx = min(max(static_cast<int>(rint(__dadd_rn(fx, rx))), 0), w - 1);
      v[e] = static_cast<double>(bl[static_cast<long long>(sy) * w + sx]);
    }
    words[i] = __ballot_sync(kFull, v[0] < v[1]);
  }
  // byte `lane` holds pairs 8 * lane .. 8 * lane + 7, the first at bit 7:
  // word lane / 4, lanes 8 (lane % 4) .. of it, bit-reversed
  unsigned word = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (i == (lane >> 2)) word = words[i];
  uint8_t* row = out + (static_cast<long long>(bi) * rows_total + row0 + r) * 37;
  row[lane] = static_cast<uint8_t>((__brev(word) >> (24 - 8 * (lane & 3))) & 0xffu);
  if (lane == 0) {
    int16_t yy = static_cast<int16_t>(ky << level), xx = static_cast<int16_t>(kx << level);
    row[32] = static_cast<uint8_t>(yy & 0xff);
    row[33] = static_cast<uint8_t>((yy >> 8) & 0xff);
    row[34] = static_cast<uint8_t>(xx & 0xff);
    row[35] = static_cast<uint8_t>((xx >> 8) & 0xff);
    row[36] = valid ? 1 : 0;
  }
}

}  // namespace

namespace {

struct OrbLayout {
  long long images[8];  // level l's float32 images (level 0: the caller's when they are float32)
  long long score, blur, cand, bits, n_kept, top, total;
};

OrbLayout orb_layout(int b, int h, int w, int n_levels, int k_max, int u8) {
  OrbLayout l{};
  long long at = 0;
  auto take = [&at](long long bytes) {
    long long here = at;
    at += (bytes + 255) / 256 * 256;
    return here;
  };
  for (int lv = 0; lv < n_levels && lv < 8; ++lv)
    l.images[lv] = lv == 0 && !u8 ? -1 : take(4LL * b * (h >> lv) * (w >> lv));
  const long long hw = static_cast<long long>(h) * w;
  l.score = take(4 * b * hw);
  l.blur = take(4 * b * hw);
  l.cand = take(8 * b * hw);
  l.bits = take(4LL * b * ((hw + 31) / 32));
  l.n_kept = take(4LL * b);
  l.top = take(8LL * b * k_max);
  l.total = at;
  return l;
}

}  // namespace

extern "C" long long lvs_orb_scratch_bytes(int b, int h, int w, int n_levels, int k_max, int u8) {
  return orb_layout(b, h, w, n_levels, k_max, u8).total;
}

// images (b, h, w) uint8 (u8) or float32; k_levels: n_levels (at most 8)
// row counts on the host; out (b, sum(k_levels), 37)
extern "C" int lvs_orb_detect(const void* images, int u8, int b, int h, int w, const int* k_levels, int n_levels,
                              float threshold, int border, const int8_t* disc, int n_disc, const int8_t* pattern,
                              void* scratch, long long scratch_bytes, uint8_t* out, cudaStream_t stream) {
  if (n_levels < 1 || n_levels > 8) return static_cast<int>(cudaErrorInvalidValue);
  int k_max = 0, rows_total = 0;
  for (int lv = 0; lv < n_levels; ++lv) {
    k_max = k_levels[lv] > k_max ? k_levels[lv] : k_max;
    rows_total += k_levels[lv];
  }
  const OrbLayout l = orb_layout(b, h, w, n_levels, k_max, u8);
  if (scratch_bytes < l.total) return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return 0;
  char* base = static_cast<char*>(scratch);
  float* score = reinterpret_cast<float*>(base + l.score);
  float* blur = reinterpret_cast<float*>(base + l.blur);
  auto* cand = reinterpret_cast<unsigned long long*>(base + l.cand);
  auto* bits = reinterpret_cast<unsigned*>(base + l.bits);
  int* n_kept = reinterpret_cast<int*>(base + l.n_kept);
  auto* top = reinterpret_cast<unsigned long long*>(base + l.top);
  const float* img = u8 ? reinterpret_cast<float*>(base + l.images[0]) : static_cast<const float*>(images);
  if (u8) {
    long long n = static_cast<long long>(b) * h * w;
    orb_level0<<<lvs::blocks_for(n), lvs::kThreads, 0, stream>>>(static_cast<const uint8_t*>(images), n,
                                                                 reinterpret_cast<float*>(base + l.images[0]));
  }
  int row0 = 0;
  for (int lv = 0; lv < n_levels; ++lv) {
    const int hl = h >> lv, wl = w >> lv, k = k_levels[lv];
    const long long n = static_cast<long long>(b) * hl * wl;
    orb_pixels<<<lvs::blocks_for(n), lvs::kThreads, 0, stream>>>(img, b, hl, wl, threshold, score, blur, n_kept);
    orb_keys<<<dim3(lvs::blocks_for(static_cast<long long>(hl) * wl), b), lvs::kThreads, 0, stream>>>(
        score, hl, wl, border, bits, cand, n_kept);
    orb_select<<<b, kSelectThreads, 0, stream>>>(cand, bits, n_kept, hl * wl, k, top);
    orb_describe<<<lvs::blocks_for(32LL * b * k), lvs::kThreads, 0, stream>>>(
        img, blur, reinterpret_cast<const long long*>(top), disc, n_disc, pattern, b, hl, wl, k, lv, row0,
        rows_total, out);
    row0 += k;
    if (lv + 1 < n_levels) {
      float* half = reinterpret_cast<float*>(base + l.images[lv + 1]);
      const long long n_half = static_cast<long long>(b) * (hl / 2) * (wl / 2);
      orb_halve<<<lvs::blocks_for(n_half), lvs::kThreads, 0, stream>>>(img, b, hl, wl, half);
      img = half;
    }
  }
  LVS_RETURN_LAST_ERROR();
}
