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
// card's float32 rate. Launch latency of the ~13 launches (and the top-K
// glue) bounds it in practice.
//
// Design, per level (the wrapper loops over levels; each launch covers the
// whole batch):
// - `orb_level0` widens the uint8 images to float32; `orb_halve` makes the
//   next level's 2x2 means (exact: every level is a multiple of 1/16).
// - `orb_pixels`, one thread per pixel: the 16 wrapped circle loads,
//   bright / dark as 16-bit masks, a run of 9 found on the doubled mask,
//   the score summed in circle order (exact), and the wrapped 3x3 box sum
//   that BRIEF compares (the reference divides it by 9, which orders the
//   values as the exact sums do).
// - `orb_keys`, one thread per pixel: wrapped 3x3 suppression, the border,
//   and the ranking key (score bits << 32 | ~flat index) that makes the
//   wrapper's top-K (torch.topk as glue) reproduce `lax.top_k`'s tie order.
// - `orb_describe`, one warp per keypoint: the disc moments in float64
//   (exact) with a warp reduction, theta = atan2 in float64 rounded to
//   float32 and its cos / sin likewise, 8 of the 256 pairs per lane rotated
//   in float64 (exact products) and rounded half to even (`rint`), clipped,
//   compared; `__ballot_sync` collects each 32-pair word and every lane
//   writes one descriptor byte in np.packbits order; lane 0 writes the
//   keypoint (times 2^level, int16 little-endian) and the valid flag.
#include "common.cuh"

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
                           float* __restrict__ score, float* __restrict__ blur) {
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(b) * h * w) return;
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

// per pixel: the ranking key (suppression with wrap, border)
__global__ void orb_keys(const float* __restrict__ score, int b, int h, int w, int border,
                         long long* __restrict__ keys) {
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(b) * h * w) return;
  int x = static_cast<int>(i % w);
  int y = static_cast<int>((i / w) % h);
  const float* sc = score + (i / (static_cast<long long>(h) * w)) * h * w;
  float s = sc[static_cast<long long>(y) * w + x];
  float nmax = s;
  for (int dy = -1; dy <= 1; ++dy)
    for (int dx = -1; dx <= 1; ++dx)
      nmax = fmaxf(nmax, sc[static_cast<long long>(wrap(y + dy, h)) * w + wrap(x + dx, w)]);
  bool inside = y >= border && y < h - border && x >= border && x < w - border;
  bool keep = s > 0.0f && s >= nmax && inside;
  unsigned idx = static_cast<unsigned>(y * w + x);
  unsigned long long low = 0xffffffffull - idx;
  unsigned long long key = keep ? (static_cast<unsigned long long>(__float_as_uint(s)) << 32) | low : low;
  keys[i] = static_cast<long long>(key);
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

extern "C" int lvs_orb_level0(const uint8_t* in, int n, float* out, cudaStream_t stream) {
  if (n > 0) orb_level0<<<lvs::blocks_for(n), lvs::kThreads, 0, stream>>>(in, n, out);
  LVS_RETURN_LAST_ERROR();
}

extern "C" int lvs_orb_halve(const float* in, int b, int h, int w, float* out, cudaStream_t stream) {
  long long n = static_cast<long long>(b) * (h / 2) * (w / 2);
  if (n > 0) orb_halve<<<lvs::blocks_for(n), lvs::kThreads, 0, stream>>>(in, b, h, w, out);
  LVS_RETURN_LAST_ERROR();
}

extern "C" int lvs_orb_pixels(const float* img, int b, int h, int w, float threshold, float* score, float* blur,
                              cudaStream_t stream) {
  long long n = static_cast<long long>(b) * h * w;
  if (n > 0) orb_pixels<<<lvs::blocks_for(n), lvs::kThreads, 0, stream>>>(img, b, h, w, threshold, score, blur);
  LVS_RETURN_LAST_ERROR();
}

extern "C" int lvs_orb_keys(const float* score, int b, int h, int w, int border, long long* keys,
                            cudaStream_t stream) {
  long long n = static_cast<long long>(b) * h * w;
  if (n > 0) orb_keys<<<lvs::blocks_for(n), lvs::kThreads, 0, stream>>>(score, b, h, w, border, keys);
  LVS_RETURN_LAST_ERROR();
}

extern "C" int lvs_orb_describe(const float* img, const float* blur, const long long* top, const int8_t* disc,
                                int n_disc, const int8_t* pattern, int b, int h, int w, int k, int level,
                                int row0, int rows_total, uint8_t* out, cudaStream_t stream) {
  long long threads = static_cast<long long>(b) * k * 32;
  if (threads > 0)
    orb_describe<<<lvs::blocks_for(threads), lvs::kThreads, 0, stream>>>(
        img, blur, top, disc, n_disc, pattern, b, h, w, k, level, row0, rows_total, out);
  LVS_RETURN_LAST_ERROR();
}
