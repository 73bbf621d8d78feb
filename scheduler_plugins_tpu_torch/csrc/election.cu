// Cross-block exchange kernels of the blocked wave solve, for Hopper (sm_90a).
//
// Replaces the TPU ring engine `_ring_call` / `_ring_kernel_body`
// (scheduler_plugins_tpu/parallel/kernels.py:272 / :217; the
// `pl.pallas_call` is at :297) and its three families:
//
//   block_offsets   <- ring_offsets_f64 / ring_offsets_i32 (kernels.py:370,
//                      :357, body `_offsets_rows` :328): per column, the
//                      exclusive prefix over the block axis and the total.
//                      One instantiation per dtype the solve produces:
//                      float64 (the lite wave's cumulative-free bases) and
//                      int64 (the rescue wave's feasible counts).
//   elect_min       <- elect_min (kernels.py:387): per column, the minimum
//                      over the block axis; int32 and int64.
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
// walks s = 0 .. S-1 in order, which makes the first-minimum choice
// deterministic. Hopper has native 64-bit types, so there are no limbs and
// no casts: each kernel takes the dtype its producer gives it. The float64
// block_offsets adds in block order s = 0 .. S-1; on exact integers whose
// sum stays below 2^53 every partial sum is exact, so it is bit-identical
// to the int64 sum and to the TPU kernel's limb sum.
//
// block_offsets reads its input through a row stride, so the lite wave's
// `cumfree[:, -1, :]` (rows BS*R apart) is read in place, with no copy.
//
// Bound: each kernel reads each input it needs once and writes each output
// once, S*H*L*8 bytes at most (fused_election reads all S keys but only the
// winner's payload column). At the solve's shapes that is 2e-7 ms
// (block_offsets, (8, 4) float64) to 7e-4 ms (elect_min, (8, 4, 8192)
// int64) at 3.35 TB/s, and a few hundred to a few thousand additions or
// comparisons: neither the bytes nor the operations limit these kernels.
// What does is fixed cost per call: the launch (a few microseconds on the
// device) and, before it, the host's work to dispatch it. So the kernels stay
// one thread per column with coalesced loads, and the design goes after
// the host: no cast or copy launches around a call (the dtype and stride
// contracts above), one output allocation per call, and entry points bound
// once and called with plain integers (parallel/kernels.py).
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

// x (S, L) with row stride ld -> out (S + 1, L): rows 0 .. S-1 the
// exclusive prefix, row S the total
template <typename T>
__global__ void block_offsets_kernel(const T* __restrict__ x, long long ld,
                                     T* __restrict__ out, int S,
                                     long long L) {
  long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= L) return;
  T acc = 0;
  for (int s = 0; s < S; ++s) {
    out[s * L + j] = acc;
    acc += x[s * ld + j];
  }
  out[S * L + j] = acc;
}

// x (S, L) -> out (L)
template <typename T>
__global__ void elect_min_kernel(const T* __restrict__ x,
                                 T* __restrict__ out, int S, long long L) {
  long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= L) return;
  T best = x[j];
  for (int s = 1; s < S; ++s) {
    T v = x[s * L + j];
    best = v < best ? v : best;
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

template <typename T>
int launch_block_offsets(const void* x, long long ld, void* out, int S,
                         long long L, void* stream) {
  if (L > 0) {
    block_offsets_kernel<T><<<blocks_for(L), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), ld, static_cast<T*>(out), S, L);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_elect_min(const void* x, void* out, int S, long long L,
                     void* stream) {
  if (L > 0) {
    elect_min_kernel<T><<<blocks_for(L), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<T*>(out), S, L);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int spt_block_offsets_i64(const void* x, long long ld, void* out, int S,
                          long long L, void* stream) {
  return launch_block_offsets<int64_t>(x, ld, out, S, L, stream);
}

int spt_block_offsets_f64(const void* x, long long ld, void* out, int S,
                          long long L, void* stream) {
  return launch_block_offsets<double>(x, ld, out, S, L, stream);
}

int spt_elect_min_i32(const void* x, void* out, int S, long long L,
                      void* stream) {
  return launch_elect_min<int32_t>(x, out, S, L, stream);
}

int spt_elect_min_i64(const void* x, void* out, int S, long long L,
                      void* stream) {
  return launch_elect_min<int64_t>(x, out, S, L, stream);
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
