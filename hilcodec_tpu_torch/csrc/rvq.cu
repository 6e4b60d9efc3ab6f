/*
 * Fused residual-VQ cascade for Hopper (sm_90a), with a plain C interface.
 *
 * Replaces hilcodec_tpu/ops/pallas_rvq.py::_rvq_kernel (codebook stack
 * resident in VMEM) and ::_rvq_staged_kernel (one codebook per grid step).
 * One kernel covers both: it streams the codebooks through shared memory,
 * so the size of the stack does not matter.
 *
 * What it computes, for stage s < n and row m < M, with r = x[m] at first:
 *   dist[k]   = (||r||^2 - 2 r.E_s[k]) + ||E_s[k]||^2    (IEEE f32)
 *   idx[s, m] = the first k with the least dist
 *   r        -= E_s[idx[s, m]]
 * ||E_s[k]||^2 comes from the wrapper, computed once per codebook stack.
 *
 * Bound on an H100 SXM (67 TFLOP/s f32 on the CUDA cores, 3.35 TB/s HBM):
 * at M = 128 rows, n = 8, K = 1024, C = 128 the dot products are
 * 2*M*K*C*n = 0.27 GFLOP -> 4.0 us, against 4.2 MB of codebooks read once
 * -> 1.3 us, so f32 arithmetic bounds it. At M = 16 (16 serving slots) the
 * codebook read bounds it (1.3 us against 0.5 us of arithmetic).
 *
 * Design: a block of 256 threads owns 8 rows, whose residuals stay in
 * shared memory for all stages. Each stage streams its codebook through
 * shared memory in chunks of 128 codewords (rows padded by 4 floats, so
 * 16-byte reads of 8 neighbouring codewords hit distinct banks), double
 * buffered with cp.async: the next chunk, also across a stage boundary,
 * loads while this one is scored. Thread t scores codeword t % 128 of the
 * chunk against 4 of the 8 rows (t / 128 picks which four) and keeps a
 * running (min, argmin) per row in registers; each thread visits its
 * codewords in increasing order, so a strict < keeps the first index. At
 * the end of a stage the 128 candidates of each row are reduced with the
 * rule "smaller distance, then smaller index", the index is written, and
 * the residual is updated by a direct gather (no one-hot). The design keeps
 * the codebook traffic off the critical path but runs only ceil(M/8)
 * blocks, so at serving sizes most SMs idle; splitting K across blocks and
 * tensor-core distances are later work.
 */
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCodes = 128;                         // codewords per chunk
constexpr int kGroups = kThreads / kCodes;          // row groups: 2
constexpr int kRowsPerThread = 4;
constexpr int kRows = kGroups * kRowsPerThread;     // rows per block: 8
constexpr int kWarpsPerGroup = kCodes / 32;         // 4
constexpr int kPad = 4;                             // floats per smem row
constexpr unsigned kFull = 0xffffffffu;

static_assert(kRows == kThreads / 32, "one warp per row for ||r||^2");

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// (d, i) beats (bd, bi): smaller distance, then smaller index.
__device__ __forceinline__ bool better(float d, int i, float bd, int bi) {
  return d < bd || (d == bd && i < bi);
}

// Start copying chunk q (stage q / nchunks, codewords from
// (q % nchunks) * kCodes on) into buf.
__device__ __forceinline__ void load_chunk(float* buf,
                                           const float* __restrict__ books,
                                           int q, int nchunks, int K, int C) {
  const int s = q / nchunks;
  const int k0 = (q % nchunks) * kCodes;
  const int ncodes = min(kCodes, K - k0);
  const int vecs = C / 4;
  const int ld = C + kPad;
  const float* src = books + ((size_t)s * K + k0) * C;
  for (int v = threadIdx.x; v < ncodes * vecs; v += kThreads) {
    const int code = v / vecs;
    const int c = (v - code * vecs) * 4;
    cp_async16(buf + code * ld + c, src + (size_t)code * C + c);
  }
}

__global__ void __launch_bounds__(kThreads)
rvq_cascade_kernel(const float* __restrict__ x,
                   const float* __restrict__ books,
                   const float* __restrict__ norms,
                   int32_t* __restrict__ idx, int M, int K, int C, int n) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ld = C + kPad;
  float* bufs = smem;                                // [2][kCodes][ld]
  float* res = smem + 2 * kCodes * ld;               // [kRows][C]
  float* rnorm = res + kRows * C;                    // [kRows]
  float* cand_d = rnorm + kRows;                     // [kRows][4]
  int* cand_i = reinterpret_cast<int*>(cand_d + kRows * kWarpsPerGroup);
  int* best = cand_i + kRows * kWarpsPerGroup;       // [kRows]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int code_l = tid % kCodes;
  const int group = tid / kCodes;
  const int row0 = blockIdx.x * kRows;
  const int nchunks = (K + kCodes - 1) / kCodes;
  const int total = n * nchunks;

  load_chunk(bufs, books, 0, nchunks, K, C);
  cp_async_commit();
  // ragged M: rows past the end score a zero residual and write nothing
  for (int v = tid; v < kRows * C; v += kThreads) {
    res[v] = (row0 + v / C < M) ? x[(size_t)row0 * C + v] : 0.f;
  }

  const float* myres = res + group * kRowsPerThread * C;
  float bd[kRowsPerThread];
  int bi[kRowsPerThread];

  for (int q = 0; q < total; ++q) {
    const int s = q / nchunks;
    const int j = q - s * nchunks;
    if (j == 0) {
      __syncthreads();  // this stage's residual is in place
      float acc = 0.f;  // warp w: ||r_w||^2
      for (int c = lane; c < C; c += 32) {
        acc = fmaf(res[warp * C + c], res[warp * C + c], acc);
      }
      for (int off = 16; off > 0; off >>= 1) {
        acc += __shfl_xor_sync(kFull, acc, off);
      }
      if (lane == 0) rnorm[warp] = acc;
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        bd[r] = INFINITY;
        bi[r] = code_l;
      }
    }
    if (q + 1 < total) {
      load_chunk(bufs + ((q + 1) & 1) * kCodes * ld, books, q + 1, nchunks,
                 K, C);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // chunk q and rnorm are visible

    const int code = j * kCodes + code_l;
    if (code < K) {
      const float* e = bufs + (q & 1) * kCodes * ld + code_l * ld;
      float acc[kRowsPerThread];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) acc[r] = 0.f;
      for (int c = 0; c < C; c += 4) {
        const float4 ev = *reinterpret_cast<const float4*>(e + c);
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r) {
          const float4 rv =
              *reinterpret_cast<const float4*>(myres + r * C + c);
          acc[r] = fmaf(rv.x, ev.x, acc[r]);
          acc[r] = fmaf(rv.y, ev.y, acc[r]);
          acc[r] = fmaf(rv.z, ev.z, acc[r]);
          acc[r] = fmaf(rv.w, ev.w, acc[r]);
        }
      }
      const float en = norms[(size_t)s * K + code];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        // the reference's order: (||r||^2 - 2 r.e) + ||e||^2, no contraction
        const float d = __fadd_rn(
            __fsub_rn(rnorm[group * kRowsPerThread + r],
                      __fmul_rn(2.f, acc[r])),
            en);
        if (d < bd[r]) {
          bd[r] = d;
          bi[r] = code;
        }
      }
    }
    __syncthreads();  // chunk q is consumed; its buffer may be refilled

    if (j == nchunks - 1) {
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        float d = bd[r];
        int i = bi[r];
        for (int off = 16; off > 0; off >>= 1) {
          const float od = __shfl_xor_sync(kFull, d, off);
          const int oi = __shfl_xor_sync(kFull, i, off);
          if (better(od, oi, d, i)) {
            d = od;
            i = oi;
          }
        }
        if (lane == 0) {
          const int slot = (group * kRowsPerThread + r) * kWarpsPerGroup +
                           warp % kWarpsPerGroup;
          cand_d[slot] = d;
          cand_i[slot] = i;
        }
      }
      __syncthreads();
      if (tid < kRows) {
        float d = cand_d[tid * kWarpsPerGroup];
        int i = cand_i[tid * kWarpsPerGroup];
        for (int w = 1; w < kWarpsPerGroup; ++w) {
          const float od = cand_d[tid * kWarpsPerGroup + w];
          const int oi = cand_i[tid * kWarpsPerGroup + w];
          if (better(od, oi, d, i)) {
            d = od;
            i = oi;
          }
        }
        best[tid] = i;
        if (row0 + tid < M) idx[(size_t)s * M + row0 + tid] = i;
      }
      __syncthreads();
      const float* book = books + (size_t)s * K * C;
      for (int v = tid; v < kRows * C; v += kThreads) {
        const int r = v / C;
        res[v] -= book[(size_t)best[r] * C + (v - r * C)];
      }
    }
  }
  cp_async_wait<0>();
}

size_t smem_bytes(int C) {
  return sizeof(float) * (2 * (size_t)kCodes * (C + kPad) + kRows * C +
                          kRows + 2 * kRows * kWarpsPerGroup + kRows);
}

}  // namespace

extern "C" {

// Dynamic shared memory a launch with row width C needs.
int rvq_cascade_smem_bytes(int C) { return (int)smem_bytes(C); }

// Allow launches of up to `max_smem` bytes of dynamic shared memory on the
// current device. Call once per device before the first launch there;
// returns the cudaError_t (0 on success).
int rvq_cascade_init(int max_smem) {
  return (int)cudaFuncSetAttribute(rvq_cascade_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   max_smem);
}

// x [M, C], books [>=n, K, C], norms [>=n, K] (all f32, contiguous,
// 16-byte aligned), idx [n, M] int32. Launches on `stream`, which belongs
// to the current device, and returns the cudaError_t of the launch (0 on
// success).
int rvq_cascade(const float* x, const float* books, const float* norms,
                int32_t* idx, int M, int K, int C, int n, void* stream) {
  if (M <= 0 || n <= 0) return 0;
  if (K <= 0 || C <= 0 || C % 4 != 0) return (int)cudaErrorInvalidValue;
  const int blocks = (M + kRows - 1) / kRows;
  rvq_cascade_kernel<<<blocks, kThreads, smem_bytes(C),
                       static_cast<cudaStream_t>(stream)>>>(
      x, books, norms, idx, M, K, C, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
