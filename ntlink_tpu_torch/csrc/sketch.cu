// ntHash2 canonical k-mer hashes + leftmost-argmin minimizer windows, for
// NVIDIA Hopper (sm_90a).
//
// Replaces both TPU kernels of ntlink_tpu/ops/sketch_pallas.py:
//   sketch_batch_pallas          (single VMEM tile, pads <= 16384)
//   sketch_batch_pallas_chunked  (chunk + halo grid, pads 32768 .. 2^21)
// The 16384 split was the v5e VMEM limit; here one kernel covers every pad
// from 1024 to 2^21, because a block only ever holds one segment of a row.
//
// Contract (the plain version is ntlink_tpu_torch/ops/sketch_torch.py
// sketch_rows_ref, which the wrapper ops/sketch_cuda.py runs on the CPU):
//   in   codes (B, L) uint8 0..3, lengths (B,) int32
//   out  can (B, L) int64 = fh + rh mod 2^64, fwd (B, L) uint8 = fh <= rh,
//        winner (B, NW) int32 = leftmost argmin of keys[j .. j+w-1],
//        emit (B, NW) uint8 = winner != previous window's winner, window
//        inside the row (j < len-k-w+2), winner key's high half not all ones
//   key[p] = can[p] for p <= len-k, else all ones; NW = L-k-w+2.
//   can/fwd are right on columns [0, len-k] (later columns are defined but
//   not part of the contract).
//
// What bounds it on the H100: integer work, not memory. Per base it reads
// one byte and writes 8 + 1 bytes of hash planes plus ~5 bytes of window
// outputs (~15 bytes of HBM traffic per base), while the direct O(k) hash
// costs 2k 64-bit XORs + 2k shared-memory table reads, and the window scan
// w 64-bit compares per window (measured: 0.53 ms per 8.4 M bases at k=32,
// w=100 on an H100 SXM at 700 W, i.e. ~0.25 TB/s of HBM traffic, far below
// the 3.35 TB/s peak). The design keeps everything between the code read
// and the output writes in shared memory:
//   - one block = one (row, segment of kSeg columns) tile; it loads the
//     segment's codes plus a halo of w+k-1 bases once, coalesced;
//   - every key of the segment and its halo is hashed directly from a
//     per-block srol table (4k entries per strand, 64-bit native math; the
//     TPU's (hi, lo) uint32 split and log-doubling are not carried over);
//   - each thread scans one window's w keys for the leftmost minimum;
//   - emit needs the previous window's winner, so the block also computes
//     the winner of the window before its segment (one extra key and one
//     extra window) instead of reading another block's output: blocks run
//     in no order.
// Faster variants (rolling hash, shared sliding minimum, fewer output
// planes) are later work; this one is simple and exact.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSeg = 1024;      // columns (positions and windows) per block
constexpr int kThreads = 256;

__constant__ uint64_t kSeed[4] = {
    0x3C8BFBB395C60474ULL, 0x3193C18562A02B4CULL,
    0x20323ED082572324ULL, 0x295549F54BE24456ULL,
};

// ntHash2 split rotation applied d times: bits 33..63 rotate as a 31-bit
// field, bits 0..32 as a 33-bit field (nthash_np.srol).
__device__ __forceinline__ uint64_t srol_pow(uint64_t x, int d) {
  uint64_t hi = x >> 33;
  uint64_t lo = x & ((1ULL << 33) - 1);
  const int a = d % 31, b = d % 33;
  if (a) hi = ((hi << a) | (hi >> (31 - a))) & ((1ULL << 31) - 1);
  if (b) lo = ((lo << b) | (lo >> (33 - b))) & ((1ULL << 33) - 1);
  return (hi << 33) | lo;
}

__global__ void __launch_bounds__(kThreads)
sketch_rows_kernel(const uint8_t* __restrict__ codes,
                   const int32_t* __restrict__ lengths,
                   int64_t* __restrict__ can, uint8_t* __restrict__ fwd,
                   int32_t* __restrict__ winner, uint8_t* __restrict__ emit,
                   int L, int NW, int k, int w) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nkeys = kSeg + w;         // keys of columns first .. first+nkeys-1
  const int nbases = nkeys + k - 1;
  uint64_t* tab_f = reinterpret_cast<uint64_t*>(smem);   // [k][4]
  uint64_t* tab_r = tab_f + 4 * k;                        // [k][4]
  uint64_t* keys = tab_r + 4 * k;                         // [nkeys]
  int32_t* wins = reinterpret_cast<int32_t*>(keys + nkeys);  // [kSeg + 1]
  uint8_t* win_ok = reinterpret_cast<uint8_t*>(wins + kSeg + 1);
  uint8_t* bases = win_ok + kSeg + 1;                     // [nbases]

  const int row = blockIdx.y;
  const int s0 = blockIdx.x * kSeg;   // first column this block writes
  const int first = s0 - 1;           // first column it hashes (may be -1)
  const uint8_t* crow = codes + static_cast<size_t>(row) * L;

  for (int i = threadIdx.x; i < 4 * k; i += blockDim.x) {
    const int j = i >> 2, b = i & 3;
    tab_f[i] = srol_pow(kSeed[b], k - 1 - j);
    tab_r[i] = srol_pow(kSeed[3 - b], j);
  }
  for (int i = threadIdx.x; i < nbases; i += blockDim.x) {
    const int p = first + i;
    bases[i] = (p >= 0 && p < L) ? (crow[p] & 3) : 0;
  }
  __syncthreads();

  const int len = lengths[row];
  const int last_valid = len - k;     // keys of columns > len-k are all ones
  for (int i = threadIdx.x; i < nkeys; i += blockDim.x) {
    const int p = first + i;
    uint64_t fh = 0, rh = 0;
    const uint8_t* b = bases + i;
    for (int j = 0; j < k; ++j) {
      const int c = b[j];
      fh ^= tab_f[4 * j + c];
      rh ^= tab_r[4 * j + c];
    }
    const uint64_t cn = fh + rh;
    keys[i] = (p >= 0 && p <= last_valid) ? cn : ~0ULL;
    if (p >= s0 && p < s0 + kSeg && p < L) {
      const size_t o = static_cast<size_t>(row) * L + p;
      can[o] = static_cast<int64_t>(cn);
      fwd[o] = fh <= rh;
    }
  }
  __syncthreads();

  // window first+i covers keys[i .. i+w-1]; strict < keeps the leftmost
  for (int i = threadIdx.x; i < kSeg + 1; i += blockDim.x) {
    const int j = first + i;
    if (j < 0 || j >= NW) {
      wins[i] = -1;
      win_ok[i] = 0;
      continue;
    }
    uint64_t best = keys[i];
    int bi = 0;
    for (int t = 1; t < w; ++t) {
      const uint64_t v = keys[i + t];
      if (v < best) {
        best = v;
        bi = t;
      }
    }
    wins[i] = j + bi;
    win_ok[i] = (best >> 32) != 0xFFFFFFFFULL;
  }
  __syncthreads();

  const int n_win = max(len - k - w + 2, 0);
  for (int i = 1 + threadIdx.x; i < kSeg + 1; i += blockDim.x) {
    const int j = first + i;
    if (j >= NW) break;
    const size_t o = static_cast<size_t>(row) * NW + j;
    winner[o] = wins[i];
    emit[o] = (wins[i] != wins[i - 1]) && (j < n_win) && win_ok[i];
  }
}

size_t smem_bytes(int k, int w) {
  const size_t nkeys = kSeg + w;
  return 2 * 4 * static_cast<size_t>(k) * 8 + nkeys * 8 + (kSeg + 1) * 5 +
         nkeys + k - 1;
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t passed as void*). Returns the CUDA
// error code of the launch (0 = success; cudaErrorInvalidValue when k and w
// need more shared memory than a block may have); never synchronises.
int ntl_sketch_rows(const void* codes, const void* lengths, void* can,
                    void* fwd, void* winner, void* emit, int B, int L, int k,
                    int w, void* stream) {
  const int NW = L - k - w + 2 > 0 ? L - k - w + 2 : 0;
  if (B <= 0 || L <= 0) return 0;
  const size_t smem = smem_bytes(k, w);
  cudaError_t err = cudaFuncSetAttribute(
      sketch_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((L + kSeg - 1) / kSeg, B);
  sketch_rows_kernel<<<grid, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes),
      static_cast<const int32_t*>(lengths), static_cast<int64_t*>(can),
      static_cast<uint8_t*>(fwd), static_cast<int32_t*>(winner),
      static_cast<uint8_t*>(emit), L, NW, k, w);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
