// Cross-block exchange kernels of the blocked wave solve, for Hopper (sm_90a).
//
// Replaces the TPU ring engine `_ring_call` / `_ring_kernel_body`
// (scheduler_plugins_tpu/parallel/kernels.py:272 / :217; the
// `pl.pallas_call` is at :297) and its three families:
//
//   block_offsets   <- ring_offsets_f64 / ring_offsets_i32 (kernels.py:370,
//                      :357, body `_offsets_rows` :328): per column, the
//                      exclusive prefix over the block axis and the total.
//   elect_min       <- elect_min (kernels.py:387): per column, the minimum
//                      over the block axis.
//   fused_election  <- fused_election (kernels.py:411): per column, the
//                      minimum key and the payload column of the block that
//                      holds it (the first such block; keys are unique
//                      except the shared "no candidate" sentinel, whose
//                      payload is zero in every block).
//
// The TPU kernels pass each shard's row around an (S-1)-step neighbour-DMA
// ring and carry f64/i64 values as three base-2^18 int32 limbs, because
// Mosaic has no 64-bit vector units. On one card all S blocks sit in one
// (S, H, L) tensor, so there is no ring: one thread owns one column and
// walks s = 0 .. S-1 in order, which makes the exclusive prefix exact and
// the first-minimum choice deterministic. Hopper has native int64, so there
// are no limbs: block_offsets sums int64 (the f64 caller converts its
// exact-integer values, bit-identical below 2^53) and fused_election moves
// the winner's int64 free row directly.
//
// Bound: every kernel reads each input it needs once and writes each output
// once (S*H*L*8 bytes at most; fused_election reads all S keys but only the
// winner's payload column — a few MB at the solve's shapes), which is a
// microsecond or less at 3.35 TB/s. Launch latency (a few microseconds)
// dominates; consecutive threads touch consecutive columns, so every warp
// access is coalesced. A later step would fuse the exchanges of one wave
// (or the whole wave) into one launch, or capture the wave loop in a CUDA
// graph, rather than tune these kernels.
//
// Each entry point launches on the given stream, allocates nothing and
// returns cudaGetLastError() so the caller can raise on a refused launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

inline int blocks_for(long long columns) {
  return static_cast<int>((columns + kThreads - 1) / kThreads);
}

// x (S, L) -> excl (S, L), total (L)
__global__ void block_offsets_kernel(const int64_t* __restrict__ x,
                                     int64_t* __restrict__ excl,
                                     int64_t* __restrict__ total,
                                     int S, long long L) {
  long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= L) return;
  int64_t acc = 0;
  for (int s = 0; s < S; ++s) {
    excl[s * L + j] = acc;
    acc += x[s * L + j];
  }
  total[j] = acc;
}

// x (S, L) -> out (L)
__global__ void elect_min_kernel(const int32_t* __restrict__ x,
                                 int32_t* __restrict__ out,
                                 int S, long long L) {
  long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= L) return;
  int32_t best = x[j];
  for (int s = 1; s < S; ++s) {
    best = min(best, x[s * L + j]);
  }
  out[j] = best;
}

// keys (S, L), payload (S, H, L) -> key_out (L), payload_out (H, L)
__global__ void fused_election_kernel(const int32_t* __restrict__ keys,
                                      const int64_t* __restrict__ payload,
                                      int32_t* __restrict__ key_out,
                                      int64_t* __restrict__ payload_out,
                                      int S, int H, long long L) {
  long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= L) return;
  int32_t best = keys[j];
  int src = 0;
  for (int s = 1; s < S; ++s) {
    int32_t k = keys[s * L + j];
    if (k < best) {  // strict: the first block holding the minimum wins
      best = k;
      src = s;
    }
  }
  key_out[j] = best;
  const int64_t* row = payload + static_cast<long long>(src) * H * L;
  for (int h = 0; h < H; ++h) {
    payload_out[h * L + j] = row[h * L + j];
  }
}

}  // namespace

extern "C" {

int spt_block_offsets(const void* x, void* excl, void* total, int S,
                      long long L, void* stream) {
  if (L > 0) {
    block_offsets_kernel<<<blocks_for(L), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(x), static_cast<int64_t*>(excl),
        static_cast<int64_t*>(total), S, L);
  }
  return static_cast<int>(cudaGetLastError());
}

int spt_elect_min(const void* x, void* out, int S, long long L,
                  void* stream) {
  if (L > 0) {
    elect_min_kernel<<<blocks_for(L), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(x), static_cast<int32_t*>(out), S, L);
  }
  return static_cast<int>(cudaGetLastError());
}

int spt_fused_election(const void* keys, const void* payload, void* key_out,
                       void* payload_out, int S, int H, long long L,
                       void* stream) {
  if (L > 0) {
    fused_election_kernel<<<blocks_for(L), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(keys),
        static_cast<const int64_t*>(payload),
        static_cast<int32_t*>(key_out), static_cast<int64_t*>(payload_out),
        S, H, L);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
