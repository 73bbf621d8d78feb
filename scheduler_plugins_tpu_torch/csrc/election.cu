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
//   fused_election  <- fused_election (kernels.py:411) together with the
//                      payload its caller builds (`winner_payload`,
//                      scheduler_plugins_tpu/ops/assign.py:910): per
//                      column, the minimum proposed rank over the blocks,
//                      and the node id + 1 and free row of that rank, read
//                      by index from the solve's resident `node_ids` and
//                      `rank_free`.
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
// fused_election needs no payload. On the TPU each shard holds only its own
// block, so the winner's node id and free row have to travel through the
// ring beside its key. On one card every block's rows are resident, so the
// kernel elects the key and then gathers the winner's 4-byte id and its
// contiguous R*8-byte row (one 32-byte sector at R = 4) from the carry,
// which it never writes. The winner is taken only where the key is a real
// rank inside the electing block (the payload rule of `winner_payload`), so
// a column of sentinels gives zeros whichever block holds it. Its one
// output buffer is laid out [rank (L) | node id + 1 (L) | rows (L, R)]: the
// wrapper returns three contiguous views, the two vectors for the
// elementwise ops that read them and the rows row-major, so that the
// wave's `win_row[order]` gathers whole rows.
//
// Bound: each kernel reads each input it needs once and writes each output
// once: S*H*L*8 bytes at most for block_offsets and elect_min;
// fused_election reads all S int64 keys of a column and, for a column that
// has a winner, that winner's id and row (8*S*L + winners*(4 + 8*R) bytes)
// and writes 8*L*(2 + R). At the solve's shapes that is 2e-7 ms
// (block_offsets, (8, 4) float64) to 7e-4 ms (elect_min, (8, 4, 8192)
// int64) at 3.35 TB/s, and a few hundred to a few thousand additions or
// comparisons: neither the bytes nor the operations limit these kernels.
// What does is fixed cost per call: the launch (a few microseconds on the
// device) and, before it, the host's work to dispatch it. So the kernels stay
// one thread per column with coalesced loads, and the design goes after
// the host: no cast or copy launches around a call (the dtype and stride
// contracts above), one output allocation per call, entry points bound
// once and called with plain integers (parallel/kernels.py), and, for
// fused_election, the carry read in place instead of a payload built by
// a dozen launches before each call. Tensor cores, TMA and shared-memory
// tiling have nothing to do at these shapes: no product, and every value
// is read once.
//
// Each entry point launches on the given stream, allocates nothing and
// returns cudaGetLastError() so the caller can raise on a refused launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// fused_election's per-column gathers are scattered, 8 bytes a thread per
// load and store, and an SM's load/store unit takes them one sector at a
// time: small blocks spread them over more SMs (W = 8192 is 128 blocks,
// one wave over the 132 SMs), which measured faster than 256-thread blocks
// at every W of the solve. A shared-memory gather that reads each row as
// one sector per four threads, and 16-byte vector loads, did not.
constexpr int kElectionThreads = 64;

inline int blocks_for(long long columns, int threads = kThreads) {
  return static_cast<int>((columns + threads - 1) / threads);
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

// prop (S, L) proposed global ranks (sentinel N = S*BS: no proposal),
// node_ids (S, BS), rank_free (S, BS, R) -> out [rank (L) | node id + 1 (L)
// | winner free rows (L, R)]
__global__ void fused_election_kernel(const int64_t* __restrict__ prop,
                                      const int32_t* __restrict__ node_ids,
                                      const int64_t* __restrict__ rank_free,
                                      int64_t* __restrict__ out, int S,
                                      int BS, int R, long long L) {
  long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= L) return;
  int64_t best = prop[j];
  int src = 0;
  for (int s = 1; s < S; ++s) {
    int64_t k = prop[s * L + j];
    if (k < best) {  // strict: the first block holding the minimum wins
      best = k;
      src = s;
    }
  }
  const long long n = static_cast<long long>(S) * BS;
  const long long local = best - static_cast<long long>(src) * BS;
  const bool has = best < n && local >= 0 && local < BS;
  out[j] = best;
  int64_t* row_out = out + 2 * L + j * R;
  if (has) {
    // block src, local row `local` is global row `best` of the carry
    out[L + j] = static_cast<int64_t>(node_ids[best]) + 1;
    const int64_t* row = rank_free + best * R;
    for (int r = 0; r < R; ++r) row_out[r] = row[r];
  } else {
    out[L + j] = 0;
    for (int r = 0; r < R; ++r) row_out[r] = 0;
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

int spt_fused_election(const void* prop, const void* node_ids,
                       const void* rank_free, void* out, int S, int BS, int R,
                       long long L, void* stream) {
  if (L > 0) {
    fused_election_kernel<<<blocks_for(L, kElectionThreads),
                            kElectionThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(prop),
        static_cast<const int32_t*>(node_ids),
        static_cast<const int64_t*>(rank_free), static_cast<int64_t*>(out),
        S, BS, R, L);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
