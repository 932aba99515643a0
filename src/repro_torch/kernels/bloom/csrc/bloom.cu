// Bloom-filter query-and-insert with row-order semantics for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/bloom/kernel.py (_bloom_kernel
// and _murmur_scalar, launched by bloom_insert_pallas).  For every valid
// row i of states (B rows of W words) it probes the bit-packed filter at
// p_ij = (h1 + j*h2 mod 2^32) mod m_bits, j < k_hashes, with h1, h2 the
// murmur3 x86 32-bit hashes of the row under two seeds, sets those bits,
// and reports was_new[i]: did any of its probes find a zero bit in the
// filter as rows 0..i-1 left it?  That is src/repro/kernels/bloom/ref.py
// (bloom_ref) bit for bit, duplicates and colliding rows included.
//
// The Pallas kernel gets row order from its sequential grid.  Here blocks
// run in no order.  A bit p is zero when row i comes exactly when it was
// zero before the batch and no earlier valid row probes p, that is, when
// i is the lowest valid row that probes p.  So one call is two launches on
// the caller's stream:
//   1. claim: for every probe whose bit is zero in the filter as the batch
//      found it, owner[p] = min(owner[p], i) (atomicMin);
//   2. resolve: a probe of row i whose bit is still zero and whose owner
//      is i sets the bit (atomicOr) and resets owner[p] to INT_MAX;
//      was_new[i] = any probe of row i did so.
// Only the owner of p sets bit p in step 2, so a row never sees another
// row's insert of the same batch, and every claimed owner entry is reset.
// owner is an int32 scratch of m_bits entries that the wrapper keeps per
// filter size and device, all INT_MAX between calls.
//
// Lanes: one call inserts the rows of every lane of a multi-lane dispatch
// into that lane's own filter (the reference's batched Pallas kernel under
// vmap).  Rows are numbered lanes*B deep; row g belongs to lane g / B, has
// the lane-local index i = g mod B, and probes its lane's filter words and
// owner entries (one m_bits scratch per lane).  Claims are lane-local
// indices, so row order holds within each lane and lanes never meet.
//
// What bounds it on this card: bytes.  Each valid row reads W words and
// touches k_hashes random filter words (and owner entries where the bit
// is zero); the hashes are a few dozen integer operations a row.  In
// practice the latency of those random loads sets its time: the rows come
// sorted from the dedup with the invalid ones last, so the valid rows
// are a dense prefix of the batch, one to a few thousand rows.
//
// Design: one thread per row, on a grid of the blocks the card holds at
// once (threads stride over the rows past that), with chunks of 32 rows
// dealt to the blocks in turn, so that the dense prefix of valid rows
// spreads over every SM in one wave.  A valid row computes its
// probe positions for a group of 32 (k_hashes > 32 takes more groups),
// with a mask in place of the modulo when m_bits is a power of two, then
// issues the group's filter loads together, and in resolve the owner
// loads of its zero bits together, so it waits for one round trip per
// group and step rather than one per probe.
#include <algorithm>
#include <atomic>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

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

// Probe positions j0 .. j0 + kGroup - 1 of the row hashed to (h1, h2);
// positions past k_hashes are not used.
__device__ __forceinline__ void probe_group(uint32_t h1, uint32_t h2, int j0,
                                            uint32_t m_bits,
                                            uint32_t (&p)[kGroup]) {
  const bool pow2 = (m_bits & (m_bits - 1)) == 0;
#pragma unroll
  for (int t = 0; t < kGroup; ++t) {
    const uint32_t h = h1 + (uint32_t)(j0 + t) * h2;   // wraps at 2^32 first
    p[t] = pow2 ? h & (m_bits - 1) : h % m_bits;
  }
}

// The first row of this thread, and the stride to its next: chunks of 32
// consecutive rows (one warp's) are dealt to the blocks in turn.
__device__ __forceinline__ int first_row() {
  const int chunk = (threadIdx.x / 32) * gridDim.x + blockIdx.x;
  return chunk * 32 + threadIdx.x % 32;
}
__device__ __forceinline__ int row_stride() {
  return gridDim.x * blockDim.x;
}

// The lane of row g and its filter words and owner entries.
struct LaneRow {
  int i;                 // lane-local row index
  size_t filt_off;       // words from the first lane's filter
  size_t owner_off;      // entries from the first lane's owner scratch
};

__device__ __forceinline__ LaneRow lane_row(int g, int n_rows,
                                            uint32_t m_bits) {
  const int l = g / n_rows;
  return {g - l * n_rows, (size_t)l * (m_bits / 32), (size_t)l * m_bits};
}

__global__ void claim_kernel(const uint32_t* __restrict__ states,
                             const uint8_t* __restrict__ valid, int w,
                             int n_rows, int total_rows, uint32_t m_bits,
                             int k_hashes,
                             const uint32_t* __restrict__ filt_all,
                             int* __restrict__ owner_all) {
  for (int g = first_row(); g < total_rows; g += row_stride()) {
    if (!valid[g]) continue;
    const LaneRow lr = lane_row(g, n_rows, m_bits);
    const int i = lr.i;
    const uint32_t* filt = filt_all + lr.filt_off;
    int* owner = owner_all + lr.owner_off;
    const uint32_t* row = states + (size_t)g * w;
    const uint32_t h1 = murmur3(row, w, kSeed1);
    const uint32_t h2 = murmur3(row, w, kSeed2);
    for (int j0 = 0; j0 < k_hashes; j0 += kGroup) {
      uint32_t p[kGroup], word[kGroup];
      probe_group(h1, h2, j0, m_bits, p);
#pragma unroll
      for (int t = 0; t < kGroup; ++t)
        word[t] = j0 + t < k_hashes ? filt[p[t] >> 5] : kFull;
#pragma unroll
      for (int t = 0; t < kGroup; ++t)
        if (!((word[t] >> (p[t] & 31)) & 1u)) atomicMin(owner + p[t], i);
    }
  }
}

// filt is read and set here, so it is not read through the read-only
// path: a stale zero only costs an owner load, and a bit that a thread
// sees set was set by p's owner.
__global__ void resolve_kernel(const uint32_t* __restrict__ states,
                               const uint8_t* __restrict__ valid, int w,
                               int n_rows, int total_rows, uint32_t m_bits,
                               int k_hashes, uint32_t* filt_all,
                               int* owner_all,
                               uint8_t* __restrict__ was_new) {
  for (int g = first_row(); g < total_rows; g += row_stride()) {
    bool fresh = false;
    if (valid[g]) {
      const LaneRow lr = lane_row(g, n_rows, m_bits);
      const int i = lr.i;
      uint32_t* filt = filt_all + lr.filt_off;
      int* owner = owner_all + lr.owner_off;
      const uint32_t* row = states + (size_t)g * w;
      const uint32_t h1 = murmur3(row, w, kSeed1);
      const uint32_t h2 = murmur3(row, w, kSeed2);
      for (int j0 = 0; j0 < k_hashes; j0 += kGroup) {
        uint32_t p[kGroup], word[kGroup];
        probe_group(h1, h2, j0, m_bits, p);
#pragma unroll
        for (int t = 0; t < kGroup; ++t)
          word[t] = j0 + t < k_hashes ? filt[p[t] >> 5] : kFull;
        int own[kGroup];
#pragma unroll
        for (int t = 0; t < kGroup; ++t)
          own[t] = ((word[t] >> (p[t] & 31)) & 1u) ? INT_MAX : owner[p[t]];
#pragma unroll
        for (int t = 0; t < kGroup; ++t) {
          if (own[t] == i) {
            atomicOr(filt + (p[t] >> 5), 1u << (p[t] & 31));
            owner[p[t]] = INT_MAX;
            fresh = true;
          }
        }
      }
    }
    was_new[g] = fresh ? 1 : 0;
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
// valid and was_new (lanes, n_rows), filt (lanes, m_bits / 32) and owner
// (lanes, m_bits), all contiguous; m_bits is a multiple of 32.  Returns a
// cudaError_t: 0 when both launches were accepted.  threads is a multiple
// of 32.
extern "C" int bloom_launch(const void* states, const void* valid, int w,
                            int n_rows, int lanes, unsigned m_bits,
                            int k_hashes, void* filt, void* owner,
                            void* was_new, int threads, void* stream) {
  if (n_rows <= 0 || lanes <= 0) return cudaSuccess;
  if (threads <= 0 || threads % 32 || m_bits % 32 ||
      (long long)n_rows * lanes > INT_MAX)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int total = n_rows * lanes;
  const int needed = (total + threads - 1) / threads;
  const int claim_blocks =
      std::min(needed, resident_blocks<claim_kernel>(threads));
  const int resolve_blocks =
      std::min(needed, resident_blocks<resolve_kernel>(threads));
  if (claim_blocks <= 0 || resolve_blocks <= 0) return cudaErrorInvalidValue;
  const uint32_t* s = static_cast<const uint32_t*>(states);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  int* own = static_cast<int*>(owner);
  uint32_t* f = static_cast<uint32_t*>(filt);
  claim_kernel<<<claim_blocks, threads, 0, st>>>(s, v, w, n_rows, total,
                                                 m_bits, k_hashes, f, own);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  resolve_kernel<<<resolve_blocks, threads, 0, st>>>(
      s, v, w, n_rows, total, m_bits, k_hashes, f, own,
      static_cast<uint8_t*>(was_new));
  return cudaGetLastError();
}
