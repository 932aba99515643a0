// Bloom-filter query-and-insert with row-order semantics for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/bloom/kernel.py (_bloom_kernel
// and _murmur_scalar, launched by bloom_insert_pallas), alone and under
// vmap with one filter per lane (src/repro/core/shard.py, the lane
// engine).  For every valid row i of a lane's states (B rows of W words)
// it probes the lane's bit-packed filter at p_ij = (h1 + j*h2 mod 2^32)
// mod m_bits, j < k_hashes, with h1, h2 the murmur3 x86 32-bit hashes of
// the row under two seeds, sets those bits, and reports was_new[i]: did
// any of its probes find a zero bit in the filter as rows 0..i-1 left it?
// That is src/repro/kernels/bloom/ref.py (bloom_ref) bit for bit,
// duplicates and colliding rows included.
//
// The rule: row i is new exactly when one of its probes p finds bit p zero
// in the filter as the call found it and i is the lowest valid row of its
// lane that probes p.  Only those zero-bit probes ("claims") matter, and
// claims at different positions never meet.  So each lane's claims are
// grouped by position range (bucket: p >> shift, at most kMaxBuckets a
// lane) and each bucket is resolved by one warp.  No state per filter bit
// lives in device memory: the scratch (ops.scratch_plan) holds an 8-byte
// slot per probe, a few words per row and three counters per bucket,
// sized from the call's shapes.  One call is a memset of the counters and
// three launches on the caller's stream:
//   1. count: every row gets was_new = 0; a valid row hashes, loads all its
//      probed filter words at once, stores its claim masks, counts each
//      claim in its bucket (a block-local histogram, added to the lane's
//      counts once per block) and, if it claims, gets was_new = 1 and a
//      place in the lane's list of claiming rows.
//   2. scatter: each block turns its lane's counts into bucket offsets;
//      every listed row re-hashes and appends each claim (position, row)
//      to its bucket at an atomically taken slot, from its masks: the
//      filter is not read again.  Order inside a bucket does not matter.
//   3. resolve: one warp per bucket.  A bucket of at most 32 claims is
//      settled in registers (__match_any_sync on the position, then
//      __reduce_min_sync on the row); a larger one in a window of kSub
//      owner entries of the warp's own in shared memory.  The owner sets
//      the bit (atomicOr, words of the bucket's range); a row that loses
//      every one of its claims gets was_new = 0 back.
//
// What bounds it on this card: bytes, in random 32-byte sectors.  Each
// valid row reads W words and k_hashes random filter words; each claim
// moves an 8-byte slot out and back and sets one filter word; the hashes
// are a few dozen integer operations a row.  The random accesses, not
// the bytes, set the time, so the design spends as few per claim as it
// can: one filter read (from HBM), one slot atomic and one slot store in
// scatter, one atomicOr for an owned claim, and nothing for was_new
// unless a row loses.  The parent design kept an int32 owner entry per
// filter bit (64 MiB a lane at 2^24 bits, 512 MiB at 8 lanes, ten times
// L2), touched it three times per claim at random and read the filter
// twice; with that gone, 8 lanes cost about what their kept rows predict
// against one lane (chip_smoke.py phase 4; PERF.md).
//
// Rows and list entries are dealt to a lane's blocks (grid (X, lanes)) in
// chunks of 32, so that the valid rows, which the dedup leaves spread
// through a sorted prefix of the batch, spread over every SM.
#include <algorithm>
#include <atomic>
#include <climits>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

namespace cg = cooperative_groups;

constexpr unsigned kFull = 0xffffffffu;
// buckets a lane at most (the wrapper's ops.MAX_BUCKETS): 13.7 claims a
// bucket on average at phase 4's lane shape in chip_smoke.py
constexpr int kMaxBuckets = 1 << 12;
// warps of a resolve block, and the owner entries of each (4 KB): a
// bucket spans 4 windows at the default 2^24 bits
constexpr int kResolveWarps = 8;
constexpr int kSub = 1 << 10;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ uint32_t murmur3(const uint32_t* __restrict__ row,
                                            int w, uint32_t seed) {
  uint32_t h = seed;
  for (int j = 0; j < w; ++j) {
    uint32_t kv = row[j] * 0xCC9E2D51u;
    kv = rotl(kv, 15);
    kv *= 0x1B873593u;
    h ^= kv;
    h = rotl(h, 13);
    h = h * 5u + 0xE6546B64u;
  }
  h ^= (uint32_t)(w * 4);
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

constexpr uint32_t kSeed1 = 0x9747B28Cu;
constexpr uint32_t kSeed2 = 0x31415926u;
constexpr int kGroup = 32;           // probes in flight per row
constexpr int kBatch = 4;            // valid flags a thread loads at once
constexpr int kThreads = 256;        // block size of count and scatter

// The probe positions of one row: p_j = (h1 + j*h2 mod 2^32) mod m_bits,
// with a mask in place of the modulo when m_bits is a power of two.
// Recomputed where needed rather than held, to keep registers for loads.
struct Probes {
  uint32_t h1, h2, m_bits;
  __device__ __forceinline__ Probes(const uint32_t* __restrict__ row, int w,
                                    uint32_t m)
      : h1(murmur3(row, w, kSeed1)), h2(murmur3(row, w, kSeed2)),
        m_bits(m) {}
  __device__ __forceinline__ uint32_t at(int j) const {
    const uint32_t h = h1 + (uint32_t)j * h2;   // wraps at 2^32 first
    return (m_bits & (m_bits - 1)) == 0 ? h & (m_bits - 1) : h % m_bits;
  }
};

// Bit t is set when probe j0 + t (< k_hashes) finds its bit zero in filt:
// a claim.  The group's filter loads are issued together.
__device__ __forceinline__ uint32_t claims_of(
    const Probes& pr, int j0, int k_hashes,
    const uint32_t* __restrict__ filt) {
  uint32_t word[kGroup];
#pragma unroll
  for (int t = 0; t < kGroup; ++t)
    word[t] = j0 + t < k_hashes ? __ldg(filt + (pr.at(j0 + t) >> 5)) : kFull;
  uint32_t zero = 0;
#pragma unroll
  for (int t = 0; t < kGroup; ++t)
    zero |= ((~word[t] >> (pr.at(j0 + t) & 31)) & 1u) << t;
  return zero;
}

// The first index (row, or list entry) of this thread within its lane:
// chunks of 32 consecutive indices (one warp's) are dealt to the lane's
// blocks in turn, so that work packed at the front of a lane, such as
// the valid rows that the dedup leaves spread through a sorted prefix,
// spreads over every SM; the thread's next index is gridDim.x *
// blockDim.x further.
__device__ __forceinline__ int first_index() {
  return ((threadIdx.x / 32) * gridDim.x + blockIdx.x) * 32 +
         threadIdx.x % 32;
}

// The scratch of one call, all of it sized from lanes, n_rows and
// k_hashes (the wrapper's ops.scratch_plan).  Per lane and bucket: counts
// and fill, and per lane the length of its row list (all zero when count
// starts), and offsets (written by scatter); per lane a list of the rows
// that claim (n_rows entries at most); per row the claims it lost and
// ceil(k_hashes / 32) claim masks (bit t of mask g: probe 32 g + t is a
// claim); per probe of the lane an 8-byte slot.
struct Scratch {
  uint32_t* counts;
  uint32_t* fill;
  uint32_t* listed;
  uint32_t* offsets;
  uint32_t* rows;
  uint32_t* lost;
  uint32_t* masks;
  uint2* claims;
};

// offsets[0..n) = the exclusive prefix sums of counts[0..n), n at most
// kMaxBuckets, by one block: warp u scans its run of kRun entries in
// registers (kPer coalesced loads a lane), then the runs' totals are
// summed across the block.  Ends with the block synchronised.
__device__ void lane_offsets(const uint32_t* __restrict__ counts,
                             uint32_t* offsets, int n) {
  constexpr int kWarps = kThreads / 32, kRun = kMaxBuckets / kWarps;
  constexpr int kPer = kRun / 32;
  __shared__ uint32_t run_total[kWarps];
  const int lid = threadIdx.x % 32, warp = threadIdx.x / 32;
  uint32_t v[kPer];
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int j = warp * kRun + r * 32 + lid;
    v[r] = j < n ? counts[j] : 0;
  }
  uint32_t carry = 0;
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    uint32_t x = v[r];                   // inclusive scan within the warp
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(kFull, x, o);
      if (lid >= o) x += y;
    }
    v[r] = carry + x - v[r];
    carry += __shfl_sync(kFull, x, 31);
  }
  if (lid == 0) run_total[warp] = carry;
  __syncthreads();
  uint32_t base = 0;
  for (int u = 0; u < warp; ++u) base += run_total[u];
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int j = warp * kRun + r * 32 + lid;
    if (j < n) offsets[j] = base + v[r];
  }
  __syncthreads();
}

// count: was_new = 0 for every row, and 1 for a valid row that claims
// (resolve takes it back if the row loses every claim); for every valid
// row its claim masks, each claim counted in its bucket in a block-local
// histogram that is added to the lane's counts once per block, and the
// row appended to the lane's list when it claims (one atomic per warp).
__global__ void __launch_bounds__(kThreads, 4)
bloom_count_kernel(const uint32_t* __restrict__ states,
                   const uint8_t* __restrict__ valid, int w, int n_rows,
                   uint32_t m_bits, int k_hashes, int shift, int buckets,
                   const uint32_t* __restrict__ filt_all, Scratch sc,
                   uint8_t* __restrict__ was_new) {
  __shared__ uint32_t hist[kMaxBuckets];
  const int lane = blockIdx.y;
  for (int b = threadIdx.x; b < buckets; b += blockDim.x) hist[b] = 0;
  __syncthreads();
  const size_t row0 = (size_t)lane * n_rows;
  const int groups = (k_hashes + kGroup - 1) / kGroup;
  const uint32_t* filt = filt_all + (size_t)lane * (m_bits / 32);
  // a thread loads kBatch of its valid flags at once
  const int stride = gridDim.x * blockDim.x;
  for (int i0 = first_index(); i0 < n_rows; i0 += kBatch * stride) {
    uint32_t live = 0;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * stride;
      if (i < n_rows) {
        was_new[row0 + i] = 0;
        if (valid[row0 + i]) live |= 1u << u;
      }
    }
    for (; live; live &= live - 1) {
      const int i = i0 + (__ffs(live) - 1) * stride;
      const Probes pr(states + (row0 + i) * w, w, m_bits);
      uint32_t* mask = sc.masks + (row0 + i) * groups;
      uint32_t any = 0;
      for (int g = 0; g < groups; ++g) {
        const int j0 = g * kGroup;
        uint32_t z = claims_of(pr, j0, k_hashes, filt);
        mask[g] = z;
        any |= z;
        for (; z; z &= z - 1)
          atomicAdd(hist + (pr.at(j0 + __ffs(z) - 1) >> shift), 1u);
      }
      if (!any) continue;
      was_new[row0 + i] = 1;
      sc.lost[row0 + i] = 0;
      const cg::coalesced_group with = cg::coalesced_threads();
      uint32_t at = 0;
      if (with.thread_rank() == 0)
        at = atomicAdd(sc.listed + lane, with.size());
      sc.rows[row0 + with.shfl(at, 0) + with.thread_rank()] = (uint32_t)i;
    }
  }
  __syncthreads();
  uint32_t* counts = sc.counts + (size_t)lane * buckets;
  for (int b = threadIdx.x; b < buckets; b += blockDim.x)
    if (hist[b]) atomicAdd(counts + b, hist[b]);
}

// scatter: every block turns its lane's counts into bucket offsets (the
// lane's first block also stores them for resolve), then appends each
// claim of the rows in the lane's list to its bucket, at the bucket's
// offset plus a slot taken from its fill.  The positions come from the
// row's hashes and its claim masks, so the filter is not read again.  Up
// to 16 slot atomics are issued together before anything waits on one.
__global__ void __launch_bounds__(kThreads, 4)
bloom_scatter_kernel(const uint32_t* __restrict__ states, int w,
                     int n_rows, uint32_t m_bits, int k_hashes, int shift,
                     int buckets, Scratch sc) {
  __shared__ uint32_t off[kMaxBuckets];
  const int lane = blockIdx.y;
  const size_t lane_b = (size_t)lane * buckets;
  lane_offsets(sc.counts + lane_b, off, buckets);
  if (blockIdx.x == 0)
    for (int b = threadIdx.x; b < buckets; b += blockDim.x)
      sc.offsets[lane_b + b] = off[b];
  const size_t row0 = (size_t)lane * n_rows;
  const int groups = (k_hashes + kGroup - 1) / kGroup;
  uint32_t* fill = sc.fill + lane_b;
  uint2* claims = sc.claims + row0 * k_hashes;
  const uint32_t listed = sc.listed[lane];
  for (uint32_t e = first_index(); e < listed; e += gridDim.x * blockDim.x) {
    const uint32_t i = sc.rows[row0 + e];
    const uint32_t* mask = sc.masks + (row0 + i) * groups;
    const Probes pr(states + (row0 + i) * w, w, m_bits);
    for (int g = 0; g < groups; ++g) {
      const int j0 = g * kGroup;
      uint32_t z = mask[g];
      while (z) {
        uint32_t slot[16];
        uint32_t rest = z;
#pragma unroll
        for (int s = 0; s < 16; ++s)
          if (rest) {
            slot[s] =
                atomicAdd(fill + (pr.at(j0 + __ffs(rest) - 1) >> shift), 1u);
            rest &= rest - 1;
          }
#pragma unroll
        for (int s = 0; s < 16; ++s)
          if (z != rest) {
            const uint32_t p = pr.at(j0 + __ffs(z) - 1);
            claims[off[p >> shift] + slot[s]] = make_uint2(p, i);
            z &= z - 1;
          }
      }
    }
  }
}

// resolve: one warp per bucket (q = the warp's index + t * the grid's
// warps).  A bucket of at most 32 claims (nearly all of them at the
// default size) is resolved in registers.  A larger one goes through an
// owner window of kSub entries of the warp's own in shared memory, one
// window of its span at a time, skipping windows that hold no claim; the
// warp keeps the first 32 claims in registers and rereads the rest per
// pass.  Warps never wait for each other, so their loads overlap.
__global__ void __launch_bounds__(kResolveWarps * 32)
bloom_resolve_kernel(int n_rows, uint32_t m_bits, int k_hashes, int shift,
                     int buckets, int total, Scratch sc,
                     uint32_t* __restrict__ filt_all,
                     uint8_t* __restrict__ was_new) {
  __shared__ int owner_all[kResolveWarps][kSub];
  const int lid = threadIdx.x % 32, warp = threadIdx.x / 32;
  int* owner = owner_all[warp];
  const size_t lane_slots = (size_t)n_rows * k_hashes;
  const int groups = (k_hashes + kGroup - 1) / kGroup;
  for (int q = blockIdx.x * kResolveWarps + warp; q < total;
       q += gridDim.x * kResolveWarps) {
    const uint32_t n = sc.counts[q], start = sc.offsets[q];
    if (n == 0) continue;                // the same for the whole warp
    const int lane = q / buckets, b = q - lane * buckets;
    const uint2* claims = sc.claims + lane * lane_slots + start;
    uint32_t* filt = filt_all + (size_t)lane * (m_bits / 32);
    // The owner of a claim sets its bit.  Every row that claims has
    // was_new = 1 from count; the last claim a row loses takes it back.
    auto settle = [&](uint2 e, bool owns) {
      if (owns) {
        atomicOr(filt + (e.x >> 5), 1u << (e.x & 31));
        return;
      }
      const size_t g = lane * (size_t)n_rows + e.y;
      uint32_t claimed = 0;
      for (int m = 0; m < groups; ++m)
        claimed += __popc(sc.masks[g * groups + m]);
      if (atomicAdd(sc.lost + g, 1u) + 1 == claimed) was_new[g] = 0;
    };
    const uint2 mine = lid < n ? claims[lid] : make_uint2(0, 0);
    if (n <= 32) {
      // every claim is in a register: the lanes that share a position
      // take the lowest row among them
      const unsigned held = __ballot_sync(kFull, lid < n);
      if (lid < n)
        settle(mine, __reduce_min_sync(__match_any_sync(held, mine.x),
                                       mine.y) == mine.y);
      continue;
    }
    auto each = [&](auto&& fn) {
      if (lid < n) fn(mine);
      for (uint32_t c = 32 + lid; c < n; c += 32) fn(claims[c]);
    };
    const uint64_t end_pos = (uint64_t)(b + 1) << shift;
    const uint64_t hi = end_pos < m_bits ? end_pos : m_bits;
    for (uint64_t base64 = (uint64_t)b << shift; base64 < hi;
         base64 += kSub) {
      const uint32_t base = (uint32_t)base64;
      bool here = false;
      each([&](uint2 e) { here |= e.x - base < kSub; });
      if (!__any_sync(kFull, here)) continue;
      each([&](uint2 e) {
        if (e.x - base < kSub) owner[e.x - base] = INT_MAX;
      });
      __syncwarp();
      each([&](uint2 e) {
        if (e.x - base < kSub) atomicMin(owner + (e.x - base), (int)e.y);
      });
      __syncwarp();
      each([&](uint2 e) {
        if (e.x - base < kSub) settle(e, owner[e.x - base] == (int)e.y);
      });
      __syncwarp();
    }
  }
}

// Blocks of `threads` threads of `Kernel` that the device holds at once:
// its SM count times the blocks per SM.  Asked of the runtime once per
// kernel, device (below 64) and block size.
template <auto Kernel>
int resident_blocks(int threads) {
  static std::atomic<unsigned long long> cached[64];   // threads << 32 | n
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  const unsigned long long got =
      cached[dev & 63].load(std::memory_order_acquire);
  if (got >> 32 == (unsigned long long)threads)
    return (int)(got & 0xffffffffu);
  int sms = 0, per_sm = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel, threads,
                                                    0) != cudaSuccess)
    return 0;
  const int blocks = sms * per_sm;
  cached[dev & 63].store((unsigned long long)threads << 32 | (unsigned)blocks,
                         std::memory_order_release);
  return blocks;
}

}  // namespace

// Inserts n_rows rows of each of `lanes` lanes: states (lanes, n_rows, w),
// valid and was_new (lanes, n_rows), filt (lanes, m_bits / 32), all
// contiguous; m_bits is a multiple of 32.  Bucket b of a lane holds the
// positions [b << shift, (b + 1) << shift); `buckets` of them cover
// m_bits.  header holds lanes * (3 * buckets + 1) words, rows lanes *
// n_rows * (2 + ceil(k_hashes / 32)) words, claims (8-byte aligned) lanes
// * n_rows * k_hashes slots of 8 bytes; the kernels allocate nothing.
// Returns a cudaError_t: 0 when the memset and the three launches were
// accepted.
extern "C" int bloom_launch(const void* states, const void* valid, int w,
                            int n_rows, int lanes, unsigned m_bits,
                            int k_hashes, int shift, int buckets, void* filt,
                            void* header, void* rows, void* claims,
                            void* was_new, void* stream) {
  if (n_rows <= 0 || lanes <= 0) return cudaSuccess;
  if (n_rows >= (1 << 29) || m_bits == 0 || m_bits % 32 || k_hashes < 0 ||
      lanes > 65535 || shift < 0 || shift > 31 || buckets <= 0 ||
      buckets > kMaxBuckets || ((uint64_t)buckets << shift) < m_bits ||
      ((uint64_t)(buckets - 1) << shift) >= m_bits ||
      (long long)n_rows * k_hashes > INT_MAX ||
      (long long)lanes * buckets > INT_MAX ||
      reinterpret_cast<uintptr_t>(claims) % 8)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // blocks a lane needs for one batch of valid flags a thread
  const int per_lane = (n_rows + kThreads * kBatch - 1) / (kThreads * kBatch);
  const int count_res = resident_blocks<bloom_count_kernel>(kThreads);
  const int scatter_res = resident_blocks<bloom_scatter_kernel>(kThreads);
  const int resolve_res =
      resident_blocks<bloom_resolve_kernel>(kResolveWarps * 32);
  if (count_res <= 0 || scatter_res <= 0 || resolve_res <= 0)
    return cudaErrorInvalidValue;
  const dim3 count_grid(std::max(1, std::min(per_lane, count_res / lanes)),
                        lanes);
  const dim3 scatter_grid(
      std::max(1, std::min(per_lane, scatter_res / lanes)), lanes);
  const int total = lanes * buckets;
  const int resolve_grid =
      std::min((total + kResolveWarps - 1) / kResolveWarps, resolve_res);
  const size_t lane_buckets = (size_t)lanes * buckets;
  uint32_t* hd = static_cast<uint32_t*>(header);
  uint32_t* list = static_cast<uint32_t*>(rows);
  const size_t lane_rows = (size_t)lanes * n_rows;
  const Scratch sc{hd,
                   hd + lane_buckets,
                   hd + 2 * lane_buckets,
                   hd + 2 * lane_buckets + lanes,
                   list,
                   list + lane_rows,
                   list + 2 * lane_rows,
                   static_cast<uint2*>(claims)};
  const uint32_t* s = static_cast<const uint32_t*>(states);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  uint32_t* f = static_cast<uint32_t*>(filt);
  uint8_t* fresh = static_cast<uint8_t*>(was_new);
  cudaError_t err =
      cudaMemsetAsync(hd, 0, sizeof(uint32_t) * (2 * lane_buckets + lanes),
                      st);
  if (err != cudaSuccess) return err;
  bloom_count_kernel<<<count_grid, kThreads, 0, st>>>(
      s, v, w, n_rows, m_bits, k_hashes, shift, buckets, f, sc, fresh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bloom_scatter_kernel<<<scatter_grid, kThreads, 0, st>>>(
      s, w, n_rows, m_bits, k_hashes, shift, buckets, sc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bloom_resolve_kernel<<<resolve_grid, kResolveWarps * 32, 0, st>>>(
      n_rows, m_bits, k_hashes, shift, buckets, total, sc, f, fresh);
  return cudaGetLastError();
}
