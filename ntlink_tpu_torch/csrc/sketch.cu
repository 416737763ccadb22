// ntHash2 canonical k-mer hashes + leftmost-argmin minimizer windows, for
// NVIDIA Hopper (sm_90a).
//
// Replaces both TPU kernels of ntlink_tpu/ops/sketch_pallas.py:
//   sketch_batch_pallas          (single VMEM tile, pads <= 16384)
//   sketch_batch_pallas_chunked  (chunk + halo grid, pads 32768 .. 2^21)
// One kernel covers every pad from 1024 to 2^21, because a block only ever
// holds one segment of a row.
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
//   not part of the contract: this kernel writes the key there).
//
// What bounds it on the H100: by the roofline, bytes. Per base the function
// reads 1 byte and writes 8 (can) + 1 (fwd) + 4 (winner) + 1 (emit) = 15
// bytes, so a batch of 8.39 M bases moves 125.8 MB: 0.038 ms at 3.35 TB/s,
// against ~50 32-bit integer instructions per base that any version needs
// (0.025 ms at the card's 16.7 T instr/s INT32 instruction rate). This design
// executes ~95 per base (counted from its SASS and loop counts at k = 32,
// w = 100: ~28 per rolled key, ~18 for the amortised direct hash of a
// run's first key, ~25 per key for the two window scans with their idle
// lanes, ~15 per window for the combine and the emit, ~9 for staging and
// copies), so in practice it is bound by its integer instructions: 0.12 ms per 8.39 M
// bases measured on an H100 SXM at 700 W (512 x 16384, L2 flushed), 0.31
// of the byte bound, where the direct O(k) hash and O(w) scan it replaced
// took 0.53 ms. What the design does about each:
//   - hash, O(1) per key: a thread owns a run of kRun = 16 consecutive
//     keys. It hashes the first directly (k lookups in a per-block table of
//     rotated seeds) and rolls the others:
//       fh' = srol(fh) ^ seed[in] ^ srol^k(seed[out])
//       rh' = sror(rh ^ seed'[out]) ^ srol^(k-1)(seed'[in]),  seed'[c] =
//       seed[3-c],
//     native 64-bit math, the four seed terms of a step as two 16-byte
//     shared-memory lookups. A run's bases sit in registers: one 16-byte
//     load of the outgoing bases and one of a copy of the tile shifted by
//     k (the incoming ones);
//   - window minimum, amortised O(1) per window: the tile's keys are cut
//     into groups of w; one pass takes the leftmost prefix argmin inside
//     each group and one the leftmost suffix argmin. A window is a suffix
//     of one group followed by a prefix of the next, so its winner is one
//     64-bit compare of two keys; "keep the suffix side on ties" is the
//     leftmost rule, because the suffix lies to the left;
//   - tile: a block owns 4096 columns of a row (less for shorter rows), so
//     the halo of w + k - 1 = 131 bases is 3.2% of it; ~52 KB of shared
//     memory per block at k = 32, w = 100, four blocks to an SM;
//   - traffic: codes come in as 16 bytes per thread; keys are staged in
//     shared memory (padded by one slot per run so that the stride-16
//     stores of the hash phase spread over the banks) and leave as 16-byte
//     stores; fwd leaves as one 16-byte store per run; winner leaves as
//     int4 and emit as uchar4, in quads aligned on the global element
//     index because NW is rarely a multiple of 4. Rows whose L is not a
//     multiple of 16 take scalar loads and stores;
//   - rows and segments share a 1-D grid, so the batch height is not bound
//     by gridDim.y;
//   - emit needs the previous window's winner, so the block also computes
//     the window before its segment instead of reading another block's
//     output: blocks run in no order.
#include <cstdint>
#include <mutex>
#include <cuda_runtime.h>

namespace {

constexpr int kRun = 16;         // consecutive keys hashed by one thread
constexpr int kMaxSeg = 4096;    // columns (positions and windows) per block
constexpr int kMaxThreads = 320;  // four blocks of 288 threads fit an SM

// one step of the split rotation, and its inverse
__device__ __forceinline__ uint64_t srol1(uint64_t x) {
  const uint64_t m = ((x & 0x8000000000000000ULL) >> 30) |
                     ((x & 0x0000000100000000ULL) >> 32);
  return ((x << 1) & 0xFFFFFFFDFFFFFFFFULL) | m;
}

__device__ __forceinline__ uint64_t sror1(uint64_t x) {
  const uint64_t m = ((x & 0x0000000200000000ULL) << 30) | ((x & 1ULL) << 32);
  return ((x >> 1) & 0x7FFFFFFEFFFFFFFFULL) | m;
}

// slot of local key i in the padded key array
__device__ __forceinline__ int slot(int i) { return i + (i >> 4); }

// byte t (0..15) of a 16-byte register quad, as a table offset c * 16
__device__ __forceinline__ uint32_t code16(const uint32_t (&q)[4], int t) {
  const int sh = 8 * (t & 3);
  return sh >= 4 ? (q[t >> 2] >> (sh - 4)) & 0x30u : (q[t >> 2] << 4) & 0x30u;
}

struct Layout {
  int n;        // local keys: kRun * nruns
  int nb;       // bytes of the base tile
  size_t tab, keys, bases, bases_in, sfx, pfx, total;
};

__host__ __device__ inline size_t up16(size_t x) { return (x + 15) & ~size_t(15); }

__host__ __device__ inline Layout layout(int k, int nruns) {
  Layout o;
  o.n = kRun * nruns;
  o.nb = o.n + static_cast<int>(up16(k)) + 16;
  size_t at = 0;
  o.tab = at;      at += static_cast<size_t>(k) * 4 * 16;
  o.keys = at;     at += up16(static_cast<size_t>(o.n + nruns) * 8);
  // the suffix indices (n + 8 of 16 bits) take the place of the two base
  // tiles (nb + n bytes), which are dead once the keys are hashed
  o.sfx = at;
  o.bases = at;    at += up16(o.nb);
  o.bases_in = at; at += up16(o.n);
  o.pfx = at;      at += up16(static_cast<size_t>(o.n + 8) * 2);
  o.total = at;
  return o;
}

// Local index i of a tile is column s0 - kRun + i: run 0 holds the key of
// column s0 - 1 (the window before the segment), runs 1.. hold the
// segment's keys and the w - 1 keys after it.
__global__ void __launch_bounds__(kMaxThreads, 4)
sketch_rows_kernel(const uint8_t* __restrict__ codes,
                   const int32_t* __restrict__ lengths,
                   const ulonglong2* __restrict__ tables,
                   int64_t* __restrict__ can, uint8_t* __restrict__ fwd,
                   int32_t* __restrict__ winner, uint8_t* __restrict__ emit,
                   int L, int NW, int k, int w, int seg, int nruns, int tiles,
                   int vec, unsigned long long* __restrict__ phases) {
  extern __shared__ __align__(16) unsigned char smem[];
  // with `phases`, thread 0 adds the clocks its block spent between the
  // barriers to phases[0..4]: tables and bases, hash, can copy and group
  // scans, window combine, winner and emit
  long long t_mark = phases ? clock64() : 0;
  auto mark = [&](int i) {
    if (phases && threadIdx.x == 0) {
      const long long t = clock64();
      atomicAdd(phases + i, static_cast<unsigned long long>(t - t_mark));
      t_mark = t;
    }
  };
  const Layout lay = layout(k, nruns);
  // rolling-step terms of the incoming ([0..3]) and outgoing ([4..7]) base
  __shared__ ulonglong2 t_io[8];
  ulonglong2* tab = reinterpret_cast<ulonglong2*>(smem + lay.tab);  // [k][4]
  uint64_t* keys = reinterpret_cast<uint64_t*>(smem + lay.keys);
  uint8_t* bases = smem + lay.bases;
  uint8_t* bases_in = smem + lay.bases_in;
  uint16_t* sfx = reinterpret_cast<uint16_t*>(smem + lay.sfx);
  uint16_t* pfx = reinterpret_cast<uint16_t*>(smem + lay.pfx);

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int row = blockIdx.x / tiles;
  const int s0 = (blockIdx.x - row * tiles) * seg;  // first column written
  const int o = s0 - kRun;                           // column of local 0
  const int n = lay.n;
  const size_t row_at = static_cast<size_t>(row) * L;
  const uint8_t* crow = codes + row_at;

  // the rotated seeds of this k (see ntl_sketch_tables)
  for (int i = tid; i < 8 + 4 * k; i += nthreads) {
    const ulonglong2 e = __ldg(tables + i);
    if (i < 8) t_io[i] = e; else tab[i - 8] = e;
  }
  // the tile's bases, 0 outside the row
  if (vec) {
    for (int v = tid; v < lay.nb / 16; v += nthreads) {
      const int p = o + 16 * v;
      uint4 q = make_uint4(0, 0, 0, 0);
      if (p >= 0 && p + 16 <= L) {
        q = __ldg(reinterpret_cast<const uint4*>(crow + p));
        q.x &= 0x03030303u; q.y &= 0x03030303u;
        q.z &= 0x03030303u; q.w &= 0x03030303u;
      }
      reinterpret_cast<uint4*>(bases)[v] = q;
    }
  } else {
    for (int i = tid; i < lay.nb; i += nthreads) {
      const int p = o + i;
      bases[i] = (p >= 0 && p < L) ? (crow[p] & 3) : 0;
    }
  }
  __syncthreads();
  // bases_in[i] = bases[i + k]: the base that enters when key i rolls on
  {
    const uint32_t* bw = reinterpret_cast<const uint32_t*>(bases);
    uint32_t* iw = reinterpret_cast<uint32_t*>(bases_in);
    const int wo = k >> 2, sh = 8 * (k & 3);
    for (int v = tid; v < n / 4; v += nthreads)
      iw[v] = __funnelshift_r(bw[v + wo], bw[v + wo + 1], sh);
  }
  __syncthreads();
  mark(0);

  const int len = lengths[row];
  const int last_valid = len - k;   // keys of columns > len-k are all ones

  // hash phase: run r = tid, local keys [16 r, 16 r + 16)
  if (tid < nruns) {
    const uint8_t* b = bases + kRun * tid;
    uint64_t fh = 0, rh = 0;
    for (int jc = 0; jc < k; jc += 16) {
      const uint4 v = *reinterpret_cast<const uint4*>(b + jc);
      const uint32_t q[4] = {v.x, v.y, v.z, v.w};
      const unsigned char* tj =
          reinterpret_cast<const unsigned char*>(tab + 4 * jc);
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        if (jc + t < k) {
          const ulonglong2 e = *reinterpret_cast<const ulonglong2*>(
              tj + 64 * t + code16(q, t));
          fh ^= e.x;
          rh ^= e.y;
        }
      }
    }
    const uint4 vo = *reinterpret_cast<const uint4*>(b);
    const uint4 vi = *reinterpret_cast<const uint4*>(bases_in + kRun * tid);
    const uint32_t qo[4] = {vo.x, vo.y, vo.z, vo.w};
    const uint32_t qi[4] = {vi.x, vi.y, vi.z, vi.w};
    const unsigned char* tin = reinterpret_cast<const unsigned char*>(t_io);
    const unsigned char* tout = tin + 64;
    uint64_t* kout = keys + slot(kRun * tid);
    const int col0 = o + kRun * tid;
    // bit i set: key i of the run is a k-mer of the row
    const int lo = min(kRun, max(0, -col0));
    const int hi = min(kRun, max(0, last_valid - col0 + 1));
    const uint32_t inside = ((1u << hi) - 1u) & ~((1u << lo) - 1u);
    uint32_t fw[4] = {0, 0, 0, 0};
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      const uint64_t cn = fh + rh;
      kout[i] = (inside >> i) & 1u ? cn : ~0ULL;
      fw[i >> 2] |= static_cast<uint32_t>(fh <= rh) << (8 * (i & 3));
      if (i + 1 < kRun) {
        const ulonglong2 ein =
            *reinterpret_cast<const ulonglong2*>(tin + code16(qi, i));
        const ulonglong2 eout =
            *reinterpret_cast<const ulonglong2*>(tout + code16(qo, i));
        fh = srol1(fh) ^ ein.x ^ eout.x;
        rh = sror1(rh ^ eout.y) ^ ein.y;
      }
    }
    // fwd of the segment's own runs
    if (tid >= 1 && col0 < s0 + seg && col0 < L) {
      if (vec) {
        *reinterpret_cast<uint4*>(fwd + row_at + col0) =
            make_uint4(fw[0], fw[1], fw[2], fw[3]);
      } else {
        for (int i = 0; i < kRun && col0 + i < L; ++i)
          fwd[row_at + col0 + i] = (fw[i >> 2] >> (8 * (i & 3))) & 1;
      }
    }
  }
  __syncthreads();
  mark(1);

  // can of the segment, from the staged keys
  {
    const int ncols = min(seg, L - s0);
    if (vec) {
      for (int e = tid; e < ncols / 2; e += nthreads) {
        const int i = kRun + 2 * e;
        const uint64_t* kp = keys + slot(i);
        *reinterpret_cast<ulonglong2*>(can + row_at + s0 + 2 * e) =
            make_ulonglong2(kp[0], kp[1]);
      }
    } else {
      for (int e = tid; e < ncols; e += nthreads)
        can[row_at + s0 + e] = static_cast<int64_t>(keys[slot(kRun + e)]);
    }
  }

  // groups of w keys: leftmost prefix argmin (first half of the warps) and
  // leftmost suffix argmin (the other half)
  {
    const int ngroups = (n + w - 1) / w;
    const int half = (nthreads >> 6) << 5;
    // each chain loads kAhead keys before it compares them, so that the
    // shared-memory latency is paid once per kAhead steps
    constexpr int kAhead = 4;
    if (tid < half) {
      for (int g = tid; g < ngroups; g += half) {
        const int a = g * w, e = min(a + w, n);
        uint64_t best = keys[slot(a)];
        int bi = a;
        pfx[a] = static_cast<uint16_t>(a);
        int i = a + 1;
        for (; i + kAhead <= e; i += kAhead) {
          uint64_t v[kAhead];
#pragma unroll
          for (int t = 0; t < kAhead; ++t) v[t] = keys[slot(i + t)];
#pragma unroll
          for (int t = 0; t < kAhead; ++t) {
            if (v[t] < best) {   // strict: ties keep the left
              best = v[t];
              bi = i + t;
            }
            pfx[i + t] = static_cast<uint16_t>(bi);
          }
        }
        for (; i < e; ++i) {
          const uint64_t v = keys[slot(i)];
          if (v < best) {
            best = v;
            bi = i;
          }
          pfx[i] = static_cast<uint16_t>(bi);
        }
      }
    } else {
      for (int g = tid - half; g < ngroups; g += nthreads - half) {
        const int a = g * w, e = min(a + w, n);
        uint64_t best = keys[slot(e - 1)];
        int bi = e - 1;
        sfx[e - 1] = static_cast<uint16_t>(bi);
        int i = e - 2;
        for (; i - kAhead + 1 >= a; i -= kAhead) {
          uint64_t v[kAhead];
#pragma unroll
          for (int t = 0; t < kAhead; ++t) v[t] = keys[slot(i - t)];
#pragma unroll
          for (int t = 0; t < kAhead; ++t) {
            if (v[t] <= best) {  // the new key lies to the left: takes ties
              best = v[t];
              bi = i - t;
            }
            sfx[i - t] = static_cast<uint16_t>(bi);
          }
        }
        for (; i >= a; --i) {
          const uint64_t v = keys[slot(i)];
          if (v <= best) {
            best = v;
            bi = i;
          }
          sfx[i] = static_cast<uint16_t>(bi);
        }
      }
    }
  }
  __syncthreads();
  mark(2);

  // window of local index i covers local keys [i, i + w): the suffix of
  // i's group from i on, then the prefix of the next group up to i + w - 1
  // (both are the whole group when i starts one). The winner's local index
  // goes back into sfx[i], bit 15 set when its key's high half is not all
  // ones. Windows s0-1 .. s0+seg-1, so that each has its predecessor.
#pragma unroll 4
  for (int i = kRun - 1 + tid; i < kRun + seg; i += nthreads) {
    const int j = o + i;
    const bool live = j >= 0 && j < NW;
    const int si = sfx[i], pi = live ? pfx[i + w - 1] : si;
    const uint64_t ks = keys[slot(si)], kp = keys[slot(pi)];
    const bool take = kp < ks;  // strict: ties keep the suffix side (left)
    const uint32_t top = static_cast<uint32_t>((take ? kp : ks) >> 32);
    if (live)
      sfx[i] = static_cast<uint16_t>((take ? pi : si) |
                                     (top != 0xFFFFFFFFu ? 0x8000 : 0));
  }
  __syncthreads();
  mark(3);

  // winner and emit, in quads aligned on the global element index
  {
    const long long base = static_cast<long long>(row) * NW;
    const int jend = min(s0 + seg, NW);
    const int n_win = max(len - k - w + 2, 0);
    const int shift = static_cast<int>((base + s0) & 3);
    const int nquads = jend > s0 ? (jend - s0 + shift + 3) / 4 : 0;
    for (int q = tid; q < nquads; q += nthreads) {
      const int j0 = s0 - shift + 4 * q;
      int wv[4];
      uint32_t ev = 0;
      uint32_t prev = sfx[j0 - o - 1];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int j = j0 + t;
        const uint32_t cur = sfx[j - o];
        const int win = o + static_cast<int>(cur & 0x7FFFu);
        const int pwin = j == 0 ? -1 : o + static_cast<int>(prev & 0x7FFFu);
        wv[t] = win;
        const bool em = win != pwin && j < n_win && (cur & 0x8000u);
        ev |= static_cast<uint32_t>(em) << (8 * t);
        prev = cur;
      }
      if (j0 >= s0 && j0 + 3 < jend) {
        *reinterpret_cast<int4*>(winner + base + j0) =
            make_int4(wv[0], wv[1], wv[2], wv[3]);
        *reinterpret_cast<uint32_t*>(emit + base + j0) = ev;
      } else {
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int j = j0 + t;
          if (j >= s0 && j < jend) {
            winner[base + j] = wv[t];
            emit[base + j] = (ev >> (8 * t)) & 1;
          }
        }
      }
    }
  }
  mark(4);
}

struct Launch {
  int seg, nruns, threads, tiles;
  size_t smem;
};

// The tile geometry of a launch; threads = 0 when w leaves no room for a
// segment within kMaxThreads runs.
Launch plan(int L, int k, int w) {
  Launch p{};
  int seg = static_cast<int>(up16(L < kMaxSeg ? L : kMaxSeg));
  const int room = kRun * (kMaxThreads - 1) - (w - 1);
  if (room < kRun) return p;
  if (seg > room) seg = room & ~(kRun - 1);
  p.seg = seg;
  p.nruns = 1 + (seg + w - 1 + kRun - 1) / kRun;
  p.threads = (p.nruns + 31) & ~31;
  if (p.threads < 64) p.threads = 64;
  p.tiles = (L + seg - 1) / seg;
  p.smem = layout(k, p.nruns).total;
  return p;
}

constexpr uint64_t kSeed[4] = {
    0x3C8BFBB395C60474ULL, 0x3193C18562A02B4CULL,
    0x20323ED082572324ULL, 0x295549F54BE24456ULL,
};

// ntHash2 split rotation applied d times: bits 33..63 rotate as a 31-bit
// field, bits 0..32 as a 33-bit field (nthash_np.srol).
uint64_t srol_pow(uint64_t x, int d) {
  uint64_t hi = x >> 33;
  uint64_t lo = x & ((1ULL << 33) - 1);
  const int a = d % 31, b = d % 33;
  if (a) hi = ((hi << a) | (hi >> (31 - a))) & ((1ULL << 31) - 1);
  if (b) lo = ((lo << b) | (lo >> (33 - b))) & ((1ULL << 33) - 1);
  return (hi << 33) | lo;
}

// The kernel's dynamic shared-memory limit (and its carveout) is a
// function attribute of the current device. It is raised to the largest
// launch seen on that device and never lowered, once per new maximum, not
// set on every launch: a launch inside a CUDA graph capture then makes no
// attribute call (the step graphs of ntlink_tpu_torch/step_graph.py run
// each shape eagerly before they capture it), and a smaller launch on
// another thread cannot lower the limit under a larger one.
constexpr int kMaxDevices = 64;
std::mutex g_smem_mu;
size_t g_smem_allowed[kMaxDevices] = {};

cudaError_t allow_smem(size_t smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(g_smem_mu);
  if (g_smem_allowed[dev] >= smem) return cudaSuccess;
  err = cudaFuncSetAttribute(sketch_rows_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(sketch_rows_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) g_smem_allowed[dev] = smem;
  return err;
}

}  // namespace

extern "C" {

// Fill `out` (8 + 4k pairs of uint64, on the host) with the rotated seeds
// the kernel reads for this k: [c] and [4 + c] the (forward, reverse) terms
// of a rolling step for the incoming and the outgoing base c, then
// [8 + 4j + c] the terms of base c at offset j of a k-mer hashed directly.
void ntl_sketch_tables(int k, unsigned long long* out) {
  for (int c = 0; c < 4; ++c) {
    out[2 * c] = kSeed[c];
    out[2 * c + 1] = srol_pow(kSeed[3 - c], k - 1);
    out[2 * (4 + c)] = srol_pow(kSeed[c], k);
    out[2 * (4 + c) + 1] = kSeed[3 - c];
  }
  for (int j = 0; j < k; ++j)
    for (int c = 0; c < 4; ++c) {
      out[2 * (8 + 4 * j + c)] = srol_pow(kSeed[c], k - 1 - j);
      out[2 * (8 + 4 * j + c) + 1] = srol_pow(kSeed[3 - c], j);
    }
}

// Blocks of the (L, k, w) launch that fit one SM at once; a negative CUDA
// error code on failure.
int ntl_sketch_blocks_per_sm(int L, int k, int w) {
  const Launch p = plan(L, k, w);
  if (p.threads == 0) return -static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(p.smem);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, sketch_rows_kernel, p.threads, p.smem);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// Launch on `stream` (a cudaStream_t passed as void*). Returns the CUDA
// error code of the launch (0 = success; cudaErrorInvalidValue when k and w
// need more shared memory or threads than a block may have); never
// synchronises. The pointers must be 16-byte aligned; `tables` is
// ntl_sketch_tables(k) on the device; `phases` is null or five zeroed
// 64-bit counters on the device (see the kernel).
int ntl_sketch_rows(const void* codes, const void* lengths,
                    const void* tables, void* can, void* fwd, void* winner,
                    void* emit, int B, int L, int k, int w, void* stream,
                    void* phases) {
  const int NW = L - k - w + 2 > 0 ? L - k - w + 2 : 0;
  if (B <= 0 || L <= 0) return 0;
  const Launch p = plan(L, k, w);
  if (p.threads == 0 || layout(k, p.nruns).n > 0x7FFF)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(B) * p.tiles > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_smem(p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  sketch_rows_kernel<<<B * p.tiles, p.threads, p.smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes),
      static_cast<const int32_t*>(lengths),
      static_cast<const ulonglong2*>(tables), static_cast<int64_t*>(can),
      static_cast<uint8_t*>(fwd), static_cast<int32_t*>(winner),
      static_cast<uint8_t*>(emit), L, NW, k, w, p.seg, p.nruns, p.tiles,
      L % 16 == 0, static_cast<unsigned long long*>(phases));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
