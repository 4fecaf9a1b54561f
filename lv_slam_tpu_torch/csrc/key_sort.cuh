// A stable LSD radix sort of 64-bit keys carrying 32-bit values over the
// whole grid, one launch per 8-bit digit, in the onesweep style; and the
// decoupled look-back that places one tile's counts after every earlier
// tile's without a second launch.
//
// Used by kernel 1 (csrc/voxel_downsample.cu), whose keys are the voxel
// coordinates rebased into the fewest bits, by kernels 1b and 2 over kernel
// 1's keys (csrc/voxel_dedup.cu, through csrc/voxel_keys.cuh), by kernels
// 3, 14 and 9g, whose keys are the flat cell keys packed into the fewest
// bits (csrc/voxel_map.cu, csrc/centroid_grid.cu, csrc/knn_grid.cu), by
// kernel 9c, whose keys are the hashed buckets (csrc/cell_table.cu), and by
// kernel 8's placement of its picks (csrc/lfa_features.cu, the look-back
// only), and by kernel 2r over kernel 1's keys. K9a past its cluster's cap
// still sorts with torch.sort glue.
//
// What a caller provides: a `Control` block and the tile status words,
// zeroed by an earlier launch on the same stream; the global count of each
// digit of the valid keys for every pass it runs (`count_digits`), the
// number of valid keys and the number of passes, written by an earlier
// launch; and for pass 0 the keys in lane order, kInvalidKey on the lanes
// that take no part (they are dropped, not sorted to the back). Pass 0's
// values are the lane indices. Pass p reads its keys from one buffer and
// writes the other; after n passes the result is in the buffer pass n - 1
// wrote. A caller launches kMaxPasses passes with no host read between:
// a pass past `n_passes` returns at once, on the device value.
//
// One pass (`key_sort_pass`): a block takes the next tile of kThreads *
// Items keys (kItems, or kStagedItems in a staged pass, below) from a
// ticket counter, so every earlier tile belongs to a block that is already
// running and the look-back cannot wait on a block that has not started.
// The look-back reads kWindow earlier tiles a round trip. Warp w holds tile
// positions [w * 32 Items, (w + 1) * 32 Items), item i of lane l at
// w * 32 Items + i * 32 + l (coalesced loads). A key's rank among the
// keys of its digit is stable in three levels: within an item round by
// __match_any_sync (the lanes below it with the same digit), within the
// warp by the warp's running count of the digit over the earlier rounds,
// within the tile by the counts of the earlier warps. Thread d then owns
// digit d: it publishes the tile's count of d, sums the counts of the
// earlier tiles by decoupled look-back, and adds the digit's global base
// (the exclusive scan of the digit counts). From kStagedLanes lanes up, a
// tile holds 2048 keys, which go to shared memory in digit order first,
// then out in tile order, so neighbouring threads store one digit's keys to
// neighbouring places (a tile's keys fall in up to 256 digits: stored from
// registers, nearly every key takes its own 32-byte sector). Equal keys
// keep their input order, which the run reduction's summation order
// depends on.
#pragma once

#include "common.cuh"

namespace lvs {
namespace keysort {
namespace {  // internal linkage: each source that includes this file has its own copy

constexpr int kDigitBits = 8;
constexpr int kRadix = 1 << kDigitBits;  // 256 digits: thread d of a pass owns digit d
constexpr int kThreads = kRadix;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;  // 1024 keys a block
constexpr int kMaxPasses = 64 / kDigitBits;
constexpr unsigned long long kInvalidKey = ~0ull;

// A status word: tag (4 bits, 0 = not yet written), inclusive flag, count.
constexpr unsigned kTagShift = 28;
constexpr unsigned kInclusive = 1u << 27;
constexpr unsigned kCountMask = kInclusive - 1;  // counts below 2^27
constexpr int kMaxKeys = (1 << 27) - 1;
// Sorts of at least this many lanes take tiles of kStagedItems keys a thread
// and stage each tile's stores in shared memory (fewer blocks and store
// sectors; below it the staging's barrier and scan cost more than they
// save, and 16 keys a thread pass the 48 KB of static shared memory:
// scripts/sort_breakdown.py).
constexpr int kStagedLanes = 1 << 18;
constexpr int kStagedItems = 8;

// Device words of one sort; the caller's first launch zeroes them.
struct Control {
  unsigned tickets[kMaxPasses + 2];   // tile tickets: one per pass, two for the caller
  unsigned hist[kMaxPasses][kRadix];  // global count of each digit of the valid keys
  int n_valid;                        // keys that pass 0 keeps
  int n_passes;                       // 1..kMaxPasses
};

__device__ __forceinline__ void store_status(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned load_status(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Decoupled look-back for one column of tile status words (`words[t *
// stride]` is tile t's), by one thread: publishes `count` as tile `tile`'s
// aggregate, sums the earlier tiles' counts back to the nearest inclusive
// word, then publishes the inclusive prefix. Returns the exclusive prefix.
// The thread reads kWindow earlier tiles' words at once: when every tile
// ends at about the same time, each round trip covers kWindow tiles. `tag`
// (1-15) tells this use's words from a stale use of the same buffer.
constexpr int kWindow = 8;

__device__ __forceinline__ unsigned lookback(unsigned* words, long long stride, int tile, unsigned tag,
                                             unsigned count) {
  const unsigned t = tag << kTagShift;
  unsigned* mine = words + tile * stride;
  if (tile == 0) {
    store_status(mine, t | kInclusive | count);
    return 0;
  }
  store_status(mine, t | count);
  unsigned prefix = 0;
  for (int j = tile - 1;; j -= kWindow) {
    unsigned w[kWindow];
#pragma unroll
    for (int i = 0; i < kWindow; ++i) w[i] = j - i >= 0 ? load_status(words + (j - i) * stride) : (t | kInclusive);
    bool done = false;
#pragma unroll
    for (int i = 0; i < kWindow; ++i) {
      while ((w[i] >> kTagShift) != tag) w[i] = load_status(words + (j - i) * stride);
      if (!done) {
        prefix += w[i] & kCountMask;
        done = (w[i] & kInclusive) != 0;
      }
    }
    if (done) break;
  }
  store_status(mine, t | kInclusive | (prefix + count));
  return prefix;
}

// The same by a whole warp, 32 earlier tiles a round trip (lane i reads
// tile j - i); every lane gets the exclusive prefix.
__device__ __forceinline__ unsigned warp_lookback(unsigned* words, long long stride, int tile, unsigned tag,
                                                  unsigned count) {
  const unsigned t = tag << kTagShift;
  const int lane = threadIdx.x & 31;
  unsigned* mine = words + tile * stride;
  if (tile == 0) {
    if (lane == 0) store_status(mine, t | kInclusive | count);
    return 0;
  }
  if (lane == 0) store_status(mine, t | count);
  unsigned prefix = 0;
  for (int j = tile - 1;; j -= 32) {
    const int at = j - lane;
    unsigned w = at >= 0 ? load_status(words + at * stride) : (t | kInclusive);
    while ((w >> kTagShift) != tag) w = load_status(words + at * stride);
    const unsigned incl = __ballot_sync(0xffffffffu, (w & kInclusive) != 0);
    const int stop = incl ? __ffs(incl) - 1 : 31;  // the nearest inclusive word ends the sum
    prefix += __reduce_add_sync(0xffffffffu, lane <= stop ? (w & kCountMask) : 0u);
    if (incl) break;
  }
  if (lane == 0) store_status(mine, t | kInclusive | (prefix + count));
  return prefix;
}

// Exclusive prefix sum over the block (blockDim.x a multiple of 32, at most
// 1024); every thread gets its offset, and `total` the block's sum.
__device__ __forceinline__ unsigned block_exclusive_scan(unsigned v, unsigned* total) {
  __shared__ unsigned scratch[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  unsigned inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    unsigned o = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += o;
  }
  if (lane == 31) scratch[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    unsigned w = lane < n_warps ? scratch[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      unsigned o = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += o;
    }
    scratch[lane] = w;  // inclusive warp totals
  }
  __syncthreads();
  const unsigned base = warp > 0 ? scratch[warp - 1] : 0;
  *total = scratch[n_warps - 1];
  __syncthreads();  // scratch is reused by the next call
  return base + inc - v;
}

// Adds the digits of the passes below n_passes of a valid key to a block's
// shared counts; `flush_digits` adds those to the Control's (integer
// atomics: the totals do not depend on the order).
__device__ __forceinline__ void count_digits(unsigned (*counts)[kRadix], unsigned long long key, int n_passes) {
  for (int p = 0; p < n_passes; ++p) atomicAdd(&counts[p][(key >> (p * kDigitBits)) & (kRadix - 1)], 1u);
}

__device__ __forceinline__ void flush_digits(unsigned (*counts)[kRadix], int n_passes, Control* ctl) {
  for (int i = threadIdx.x; i < n_passes * kRadix; i += blockDim.x) {
    unsigned c = counts[i / kRadix][i % kRadix];
    if (c) atomicAdd(&ctl->hist[i / kRadix][i % kRadix], c);
  }
}

// One digit pass. `n_lanes` is the number of pass-0 keys (lanes); later
// passes sort the n_valid keys pass 0 kept. Launch with ceil(n_lanes /
// (kThreads * Items)) blocks of kThreads. Staged: the tile's keys go out
// through shared memory in digit order.
template <bool Staged, int Items>
__global__ void __launch_bounds__(kThreads) key_sort_pass(int pass, int n_lanes,
                                                          const unsigned long long* __restrict__ keys_in,
                                                          const unsigned* __restrict__ vals_in,
                                                          unsigned long long* __restrict__ keys_out,
                                                          unsigned* __restrict__ vals_out, Control* ctl,
                                                          unsigned* status) {
  __shared__ unsigned short warp_count[kThreads / 32][kRadix];
  __shared__ unsigned digit_base[kRadix];
  __shared__ int tile_id;
  if (pass >= ctl->n_passes) return;
  const int count = pass == 0 ? n_lanes : ctl->n_valid;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) tile_id = static_cast<int>(atomicAdd(&ctl->tickets[pass], 1u));
  for (int i = threadIdx.x; i < (kThreads / 32) * kRadix; i += kThreads) (&warp_count[0][0])[i] = 0;
  __syncthreads();
  const int tile = tile_id;
  const long long first = static_cast<long long>(tile) * (kThreads * Items);
  if (first >= count) return;  // whole block: no later tile holds keys either

  const unsigned digit_total = ctl->hist[pass][threadIdx.x];  // read early: it is not needed until the scan
  const int shift = pass * kDigitBits;
  const unsigned lt = (1u << lane) - 1u;
  unsigned long long key[Items];
  unsigned val[Items];
  int digit[Items];
  unsigned rank[Items];
#pragma unroll
  for (int i = 0; i < Items; ++i) {
    const long long pos = first + warp * (32 * Items) + i * 32 + lane;
    const bool in = pos < count;
    key[i] = in ? keys_in[pos] : kInvalidKey;
    val[i] = pass == 0 ? static_cast<unsigned>(pos) : (in ? vals_in[pos] : 0u);
    const bool take = in && (pass > 0 || key[i] != kInvalidKey);
    digit[i] = take ? static_cast<int>((key[i] >> shift) & (kRadix - 1)) : kRadix;
  }
#pragma unroll
  for (int i = 0; i < Items; ++i) {
    const unsigned peers = __match_any_sync(0xffffffffu, digit[i]);
    const unsigned below = __popc(peers & lt);
    const bool take = digit[i] < kRadix;
    const unsigned before = take ? warp_count[warp][digit[i]] : 0u;
    __syncwarp();
    if (take && below == 0) warp_count[warp][digit[i]] = static_cast<unsigned short>(before + __popc(peers));
    __syncwarp();
    rank[i] = before + below;
  }
  __syncthreads();

  // thread d: the earlier warps' counts of digit d, the tile's count
  const int d = threadIdx.x;
  unsigned in_tile = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    const unsigned c = warp_count[w][d];
    warp_count[w][d] = static_cast<unsigned short>(in_tile);
    in_tile += c;
  }
  unsigned n_all;
  const unsigned global = block_exclusive_scan(digit_total, &n_all);
  if constexpr (Staged) {
    __shared__ unsigned tile_start[kRadix];
    __shared__ unsigned long long staged_key[kThreads * Items];
    __shared__ unsigned staged_val[kThreads * Items];
    unsigned n_tile;
    const unsigned start = block_exclusive_scan(in_tile, &n_tile);  // ends with a barrier: warp_count is read below
    tile_start[d] = start;
    __syncthreads();
    // the tile's keys in digit order in shared memory, so that the stores
    // below write each digit's keys as one run of neighbouring threads
#pragma unroll
    for (int i = 0; i < Items; ++i) {
      if (digit[i] < kRadix) {
        const unsigned local = tile_start[digit[i]] + warp_count[warp][digit[i]] + rank[i];
        staged_key[local] = key[i];
        staged_val[local] = val[i];
      }
    }
    // its place after the earlier tiles' and the smaller digits': tile
    // position j of digit d goes to digit_base[d] + j (unsigned wrap-around)
    const unsigned earlier = lookback(status + d, kRadix, tile, static_cast<unsigned>(pass + 1), in_tile);
    digit_base[d] = global + earlier - start;
    __syncthreads();
    for (int j = threadIdx.x; j < static_cast<int>(n_tile); j += kThreads) {
      const unsigned long long k = staged_key[j];
      const unsigned at = digit_base[(k >> shift) & (kRadix - 1)] + j;
      keys_out[at] = k;
      vals_out[at] = staged_val[j];
    }
  } else {
    // its place after the earlier tiles' and after the smaller digits'
    const unsigned earlier = lookback(status + d, kRadix, tile, static_cast<unsigned>(pass + 1), in_tile);
    digit_base[d] = global + earlier;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < Items; ++i) {
      if (digit[i] < kRadix) {
        const unsigned at = digit_base[digit[i]] + warp_count[warp][digit[i]] + rank[i];
        keys_out[at] = key[i];
        vals_out[at] = val[i];
      }
    }
  }
}

// The passes of one sort, launched back to back on `stream`: keys and
// values end in (keys_a, vals_a) when n_passes is odd, else in (keys_b,
// vals_b). Pass 0 reads keys_b (the caller's keys in lane order). A caller
// whose keys are known on the host to hold at most 8 * max_passes bits
// launches only max_passes passes.
inline void launch_passes(int n_lanes, unsigned long long* keys_a, unsigned* vals_a, unsigned long long* keys_b,
                          unsigned* vals_b, Control* ctl, unsigned* status, cudaStream_t stream,
                          int max_passes = kMaxPasses) {
  const bool staged = n_lanes >= kStagedLanes;
  const int tile = kThreads * (staged ? kStagedItems : kItems);
  const int tiles = (n_lanes + tile - 1) / tile;
  auto* pass_fn = staged ? key_sort_pass<true, kStagedItems> : key_sort_pass<false, kItems>;
  for (int p = 0; p < max_passes; ++p) {
    const bool to_a = (p & 1) == 0;
    pass_fn<<<tiles, kThreads, 0, stream>>>(p, n_lanes, to_a ? keys_b : keys_a, to_a ? vals_b : vals_a,
                                            to_a ? keys_a : keys_b, to_a ? vals_a : vals_b, ctl, status);
  }
}

}  // namespace
}  // namespace keysort
}  // namespace lvs
