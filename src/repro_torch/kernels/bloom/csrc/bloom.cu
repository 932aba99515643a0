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
// run in no order, so one call is three launches on the caller's stream:
//   1. owner[p_ij] = min i over the valid rows that probe p_ij (atomicMin);
//   2. was_new[i] = any_j (bit p_ij is 0 in the filter before the batch
//      and owner[p_ij] == i): the bit was still zero when row i came,
//      exactly when no earlier row probed it;
//   3. atomicOr every probe bit into the filter and reset owner[p_ij] to
//      INT_MAX for the next call.
// owner is an int32 scratch of m_bits entries that the wrapper keeps per
// filter size and device, all INT_MAX between calls.
//
// What bounds it on this card: bytes.  Each valid row reads W words and
// touches k_hashes random filter words and owner entries three times (32
// bytes a sector); the hashes are a few dozen integer operations a row.
// Design: one thread per row, recomputing the two hashes in each launch
// (cheaper than storing k_hashes positions a row).
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

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

struct Probes {
  uint32_t h1, h2;
  __device__ __forceinline__ uint32_t at(int j, uint32_t m_bits) const {
    return (h1 + (uint32_t)j * h2) % m_bits;     // wraps at 2^32 first
  }
};

__device__ __forceinline__ Probes probes(const uint32_t* __restrict__ states,
                                         int w, int i) {
  const uint32_t* row = states + (size_t)i * w;
  return Probes{murmur3(row, w, kSeed1), murmur3(row, w, kSeed2)};
}

__global__ void claim_kernel(const uint32_t* __restrict__ states,
                             const uint8_t* __restrict__ valid, int w,
                             int n_rows, uint32_t m_bits, int k_hashes,
                             int* __restrict__ owner) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rows || !valid[i]) return;
  const Probes p = probes(states, w, i);
  for (int j = 0; j < k_hashes; ++j) atomicMin(owner + p.at(j, m_bits), i);
}

__global__ void query_kernel(const uint32_t* __restrict__ states,
                             const uint8_t* __restrict__ valid, int w,
                             int n_rows, uint32_t m_bits, int k_hashes,
                             const uint32_t* __restrict__ filt,
                             const int* __restrict__ owner,
                             uint8_t* __restrict__ was_new) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rows) return;
  bool fresh = false;
  if (valid[i]) {
    const Probes p = probes(states, w, i);
    for (int j = 0; j < k_hashes; ++j) {
      const uint32_t idx = p.at(j, m_bits);
      const bool zero = ((filt[idx >> 5] >> (idx & 31)) & 1u) == 0u;
      fresh |= zero && owner[idx] == i;
    }
  }
  was_new[i] = fresh ? 1 : 0;
}

__global__ void insert_kernel(const uint32_t* __restrict__ states,
                              const uint8_t* __restrict__ valid, int w,
                              int n_rows, uint32_t m_bits, int k_hashes,
                              uint32_t* __restrict__ filt,
                              int* __restrict__ owner) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rows || !valid[i]) return;
  const Probes p = probes(states, w, i);
  for (int j = 0; j < k_hashes; ++j) {
    const uint32_t idx = p.at(j, m_bits);
    atomicOr(filt + (idx >> 5), 1u << (idx & 31));
    owner[idx] = INT_MAX;
  }
}

}  // namespace

// Returns a cudaError_t: 0 when all three launches were accepted.
extern "C" int bloom_launch(const void* states, const void* valid, int w,
                            int n_rows, unsigned m_bits, int k_hashes,
                            void* filt, void* owner, void* was_new,
                            int threads, void* stream) {
  if (n_rows <= 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (n_rows + threads - 1) / threads;
  const uint32_t* s = static_cast<const uint32_t*>(states);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  int* own = static_cast<int*>(owner);
  uint32_t* f = static_cast<uint32_t*>(filt);
  claim_kernel<<<blocks, threads, 0, st>>>(s, v, w, n_rows, m_bits, k_hashes,
                                           own);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  query_kernel<<<blocks, threads, 0, st>>>(s, v, w, n_rows, m_bits, k_hashes,
                                           f, own,
                                           static_cast<uint8_t*>(was_new));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  insert_kernel<<<blocks, threads, 0, st>>>(s, v, w, n_rows, m_bits,
                                            k_hashes, f, own);
  return cudaGetLastError();
}
