// Integer peak probe for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel bench.py:273 (_kernel_bench -> make_micro.kern,
// :250-276), the Pallas microkernel behind the VPU peak reading: each
// element runs `iters` iterations of an independent uint32 xor/add DAG of
// `W` lanes. The plain version is ntlink_tpu_torch/ops/alu_peak_torch.py
// alu_peak_ref (the wrapper ops/alu_peak_cuda.py runs it on the CPU); the
// output is the same bit for bit.
//
//   in   x (n,) uint32;  out  o (n,) uint32 = a ^ b after the loop, where
//   b = a ^ 0xDEADBEEF and each iteration, for i < W/2,
//     t_i = a ^ (0x9E3779B1 + i), u_i = b + (0x85EBCA6B + i), v_i = t_i + u_i
//     a = v_0 ^ .. ^ v_{W/4-1},  b = v_{W/4} + .. + v_{W/2-1}
//
// What bounds it: integer issue, nothing else. One thread per element, the
// operands live in registers, and the W/2 lanes of an iteration are
// independent, so each warp has W/2 instructions in flight without any
// memory traffic inside the loop. The constants stay immediates (few
// registers, so the whole (256, 1024) probe fits the card in one wave).
//
// What the compiler may do to the source DAG: fuse it (xors into 3-input
// LOP3, adds into 3-input IADD3: real work in fewer instructions), or
// reassociate the second half's sum b + d_8 + .. + b + d_15 into 8*b + a
// loop-invariant constant, which drops adds the source asks for. The empty
// asm below hides u_i's value from the front end, so no such fold happens;
// ptxas still fuses. On sm_90a the loop body is, per lane, one LOP3
// (t_i) and one IADD3 (t_i + c_i + b), then 3-input LOP3 / IADD3 trees for
// the two accumulators: 20 LOP3, 19 IADD3 and one IMAD.IADD at W = 32.
// The loop is kept rolled (`#pragma unroll 1`) so that the SASS between
// the loop's label and its back edge is exactly one iteration; the kernel
// bench counts it there (cuobjdump -sass) and reports instructions per
// second beside the source-op rate.
#include <cstdint>
#include <cuda_runtime.h>

constexpr int kThreads = 256;

template <int W>
__global__ void __launch_bounds__(kThreads)
ntl_alu_peak_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ o,
                    int n, int iters) {
  constexpr int H = W / 2;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  uint32_t a = x[e];
  uint32_t b = a ^ 0xDEADBEEFu;
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    uint32_t v[H];
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const uint32_t t = a ^ (0x9E3779B1u + i);
      uint32_t u = b + (0x85EBCA6Bu + i);
      asm volatile("" : "+r"(u));
      v[i] = t + u;
    }
    uint32_t acc1 = v[0];
#pragma unroll
    for (int i = 1; i < H / 2; ++i) acc1 ^= v[i];
    uint32_t acc2 = v[H / 2];
#pragma unroll
    for (int i = H / 2 + 1; i < H; ++i) acc2 += v[i];
    a = acc1;
    b = acc2;
  }
  o[e] = a ^ b;
}

template <int W>
static int launch(const void* x, void* o, int n, int iters, void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  ntl_alu_peak_kernel<W><<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(o), n, iters);
  return static_cast<int>(cudaGetLastError());
}

extern "C" {

// Launch on `stream` (a cudaStream_t passed as void*). Returns the CUDA
// error code of the launch (0 = success; cudaErrorInvalidValue for a width
// other than 8, 16 or 32); never synchronises.
int ntl_alu_peak(const void* x, void* o, int n, int iters, int width,
                 void* stream) {
  if (n <= 0) return 0;
  switch (width) {
    case 8: return launch<8>(x, o, n, iters, stream);
    case 16: return launch<16>(x, o, n, iters, stream);
    case 32: return launch<32>(x, o, n, iters, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
