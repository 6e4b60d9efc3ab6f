/*
 * Fused residual-VQ cascade for Hopper (sm_90a), with a plain C interface.
 *
 * Replaces hilcodec_tpu/ops/pallas_rvq.py::_rvq_kernel (K1: codebook stack
 * resident in VMEM, call at :148) and ::_rvq_staged_kernel (K2: one
 * codebook per grid step, for stacks over 12 MB, call at :130). One kernel
 * covers both: it streams the codebooks through shared memory, so the size
 * of the stack does not matter.
 *
 * What it computes, for stage s < n and row m < M, with r = x[m] at first:
 *   dist[k]   = (||r||^2 - 2 r.E_s[k]) + ||E_s[k]||^2    (IEEE f32)
 *   idx[s, m] = the first k with the least dist
 *   r        -= E_s[idx[s, m]]
 * ||E_s[k]||^2 comes from the wrapper, computed once per codebook stack.
 *
 * Bound on an H100 SXM (67 TFLOP/s f32 on the CUDA cores, 3.35 TB/s HBM),
 * n = 8, K = 1024, C = 128: the codebooks, 4.2 MB read once, take 1.26 us;
 * the dot products, 2*M*K*C*n FLOP, take 0.50 us at M = 16 rows (16
 * serving slots: bytes bound it) and 4.0 us at M = 128 (the frame-kernel
 * path at 128 streams: operations bound it).
 *
 * Design. A thread-block cluster of G CTAs (16, or 8) owns a tile of TM
 * rows (8 or 16); CTA `rank` owns the contiguous slice [rank*S, (rank+1)*S)
 * of every stage's codebook, S >= ceil(K/G), so the stack is read once per
 * cluster and spread over G SMs, and a small M still puts G SMs per row
 * tile to work. The wrapper's `rvq_plan` picks G, TM, S, the chunk width
 * (64 or 128 codewords), the chunks per slice and the ring depth R: G = 16
 * while all the clusters fit one wave, else 8 on tiles of 16 rows once
 * tiles of 8 overflow it. The launch takes that plan as given and refuses
 * one that does not cover K and M or whose shared memory differs from
 * this file's layout.
 *  - Ring. A slice is cut into chunks of up to CODES codewords; the chunks
 *    of all stages form one sequence, and a ring of R chunk slots in
 *    dynamic shared memory keeps up to R of them in flight. The codebooks
 *    do not depend on the residual, so the chunks of stages s+1.. load
 *    while stage s is scored and merged. Each chunk lands by Hopper bulk
 *    copies (cp.async.bulk ... mbarrier::complete_tx) completing on the
 *    slot's mbarrier, one copy per 8 codewords (4 KB at C = 128) into a
 *    group row padded by 4 floats, issued from all warps: issuing a bulk
 *    copy holds its warp up, and one copy per codeword from one warp (128
 *    a chunk) held each stage up for longer than its scoring. A slot is
 *    refilled once every thread has scored it, while the stage's cluster
 *    barrier completes.
 *  - Scoring, on the f32 CUDA cores (FFMA) in the reference's order. Warp w
 *    scores member w of each group; lane l takes 1-2 groups (l % 8 + 8 i)
 *    and TM / 4 rows (l / 8 + 4 j), so a 16-byte load of a codeword feeds 4
 *    lanes and one of a residual row 8, and the 8 groups or 4 rows a load
 *    reads sit in distinct bank groups, by the padding. Each distance sums
 *    c = 0..C-1 in one thread, loads one step ahead of the FMAs. A thread
 *    visits its codewords in increasing order, so a strict < keeps the
 *    first index; its rows' (min, argmin) reduce over the 8 lanes of a row
 *    and then the warps with the rule "smaller distance, then smaller
 *    index". Shared-memory bandwidth bounds this phase (each lane is
 *    handed 16 bytes per 4 FMAs).
 *  - Merge, in distributed shared memory. Each warp writes its candidates
 *    to an array double-buffered by stage parity (one cluster barrier per
 *    stage is then enough); after the barrier the warp that owns a row
 *    reads its G * 8 candidates from the cluster's CTAs and reduces them
 *    with the same rule, so every CTA knows the global first argmin
 *    whatever the order in which they finished: deterministic, no atomics.
 *    That warp subtracts the winning codeword (from L2) from its CTA's copy
 *    of the row and sums the squares for the next stage; the copies stay
 *    bitwise equal across the cluster, since each CTA does the same f32
 *    operations on the same bits. Rank 0 writes idx; rows past M carry a
 *    zero residual at first and write nothing. A last cluster barrier
 *    keeps every CTA resident while another may still read its candidates.
 * Why FFMA and not the tensor cores: at the serving shape a stage costs a
 * few microseconds of latency and shared-memory traffic (scoring, the
 * cluster barrier, the merge, the codeword read), not arithmetic; FFMA in
 * the reference's order keeps the tokens bitwise those of the plain
 * cascade except at real f32 ties. 3xTF32 distances would cut at most
 * 2.4 us of arithmetic bound at M = 128 (4.0 us on the CUDA cores, 1.6 us
 * on the tensor cores) and pay only at large offline M.
 */
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQ = 8;                   // codewords per bulk copy
constexpr int kPad = 4;                 // floats of padding per group row
constexpr int kMaxRing = 4;             // chunk slots
constexpr int kMaxCluster = 16;         // 8 is portable; 16 needs opting in
constexpr int kBarBytes = 8 * kMaxRing; // mbarriers at the front of smem
constexpr int kNoIndex = INT_MAX;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

// One arrival that also announces `bytes` more to come by bulk copies.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The two halves of a cluster barrier: arrive (releasing this thread's
// writes to the cluster) and wait (acquiring the others').
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ float4 lds4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(addr));
  return v;
}

// (d, i) beats (bd, bi): smaller distance, then smaller index.
__device__ __forceinline__ bool better(float d, int i, float bd, int bi) {
  return d < bd || (d == bd && i < bi);
}

// Block-wide: start loading chunk q (stage q / nch, the j-th run of CODES
// codewords of the slice [k0, k1)) into `slot`, completing on `bar`. The
// chunk's codewords go in groups of kQ, one bulk copy per group (contiguous
// in global memory) into a group row of the slot, the group rows padded by
// kPad floats; group g's copy leaves from warp g % kWarps, so the copies
// leave from several warps at once. Thread 0 announces their bytes (the
// barrier's phase cannot complete before that arrival, whenever the copies
// land). A chunk past the slice's end (a ragged or empty slice) has no
// bytes, and its phase completes on the arrival alone.
template <int CODES>
__device__ __forceinline__ void issue_chunk(float* slot, uint64_t* bar,
                                            const float* __restrict__ books,
                                            int q, int nch, int K, int C,
                                            int k0, int k1, int tid) {
  const int s = q / nch;
  const int a = min(k1, k0 + (q - s * nch) * CODES);
  const int ncodes = min(k1, a + CODES) - a;
  if (tid == 0) mbar_expect_tx(bar, (unsigned)(ncodes * C) * 4u);
  const int g = (tid >> 5) + kWarps * (tid & 31);
  if (g * kQ < ncodes) {
    const int rows = min(kQ, ncodes - g * kQ);
    bulk_load(slot + g * (kQ * C + kPad),
              books + ((size_t)s * K + a + g * kQ) * C,
              (unsigned)(rows * C) * 4u, bar);
  }
}

// The sum over a warp's lanes, by a butterfly (every lane gets it).
__device__ __forceinline__ float warp_sum(float acc) {
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(kFull, acc, off);
  }
  return acc;
}

// (d, i) <- the best (d, i) of the 2 * last lanes of this lane's aligned
// segment, by a butterfly (offsets 1, 2, .., last); every lane gets it.
__device__ __forceinline__ void shfl_best(float& d, int& i, int last) {
  for (int off = 1; off <= last; off <<= 1) {
    const float od = __shfl_xor_sync(kFull, d, off);
    const int oi = __shfl_xor_sync(kFull, i, off);
    if (better(od, oi, d, i)) {
      d = od;
      i = oi;
    }
  }
}

// Warp-wide, for each of warp w's RW rows (row w + kWarps * j of the tile):
// r -= E_s[win], then ||r||^2 into rnorm, lanes over c in the reference's
// order (c = lane, lane + 32, ..., then a butterfly over the lanes).
// `win` holds each row's winner, the same on every lane.
template <int RW>
__device__ __forceinline__ void update_rows(float* res, int ldr, float* rnorm,
                                            const float* __restrict__ book,
                                            const int (&win)[RW], int w,
                                            int C, int lane) {
  float acc[RW];
#pragma unroll
  for (int j = 0; j < RW; ++j) acc[j] = 0.f;
  for (int c = lane; c < C; c += 32) {
#pragma unroll
    for (int j = 0; j < RW; ++j) {
      float* r = res + (w + kWarps * j) * ldr + c;
      const float v = *r - __ldg(book + (size_t)win[j] * C + c);
      *r = v;
      acc[j] = fmaf(v, v, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < RW; ++j) {
    acc[j] = warp_sum(acc[j]);
    if (lane == 0) rnorm[w + kWarps * j] = acc[j];
  }
}

// Scoring layout. A chunk of CODES codewords is CODES / kQ groups of kQ
// (= kWarps) members. Warp w scores member w of every group; lane l takes
// groups l % 8 + 8 i (i < kA) and rows l / 8 + 4 j (j < kB). So each
// 16-byte load of a codeword is shared by 4 lanes and each load of a
// residual row by 8, and the 8 groups (4 rows) a load reads lie in
// different bank groups, by the padding.
template <int CODES, int TM>
__global__ void __launch_bounds__(kThreads, 1)
rvq_cluster_kernel(const float* __restrict__ x,
                   const float* __restrict__ books,
                   const float* __restrict__ norms,
                   int32_t* __restrict__ idx, int M, int K, int C, int n,
                   int ring, int S, int nch) {
  constexpr int kA = CODES / (8 * kQ);   // codewords a thread scores: 1, 2
  constexpr int kB = TM / 4;             // rows a thread scores: 2, 4
  constexpr int kRw = TM / kWarps;       // rows a warp merges: 1, 2
  static_assert(kQ == kWarps && kA > 0 && kB > 0 && kRw > 0, "layout");

  cg::cluster_group cluster = cg::this_cluster();
  const int G = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int row0 = (int)(blockIdx.x / G) * TM;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);
  const int gpitch = kQ * C + kPad;                   // floats per group
  const int slot_floats = CODES / kQ * gpitch;
  const int ldr = C + kPad;                           // residual row pitch
  float* ring_buf = reinterpret_cast<float*>(smem_raw + kBarBytes);
  float* res = ring_buf + ring * slot_floats;         // [TM][ldr]
  float* rnorm = res + TM * ldr;                      // [TM]
  // candidates, one per (row, warp), double-buffered by stage parity:
  // [2][TM][kWarps]
  float* cd = rnorm + TM;
  int* ci = reinterpret_cast<int*>(cd + 2 * TM * kWarps);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int sub = lane & 7;
  const int rset = lane >> 3;
  const int k0 = min(K, rank * S);
  const int k1 = min(K, k0 + S);
  const int total = n * nch;

  if (tid == 0) {
    for (int i = 0; i < ring; ++i) mbar_init(&bars[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  for (int q = 0; q < min(ring, total); ++q) {
    issue_chunk<CODES>(ring_buf + q * slot_floats, &bars[q], books, q, nch,
                       K, C, k0, k1, tid);
  }
  // ragged M: rows past the end carry a zero residual and write nothing.
  // Warp w owns rows w + kWarps * j: it loads them and sums their squares
  // here, and merges their candidates and updates them at every stage.
#pragma unroll
  for (int j = 0; j < kRw; ++j) {
    const int row = warp + kWarps * j;
    float acc = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float v = row0 + row < M ? x[(size_t)(row0 + row) * C + c] : 0.f;
      res[row * ldr + c] = v;
      acc = fmaf(v, v, acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) rnorm[row] = acc;
  }
  // this lane's rows rset + 4 j of the residual, as shared addresses
  const uint32_t ra = smem_u32(res + rset * ldr);
  const uint32_t rstep = 16u * (uint32_t)ldr;

  for (int s = 0; s < n; ++s) {
    __syncthreads();  // this stage's residual and ||r||^2 are in place
    float rn[kB], bd[kB];
    int bi[kB];
#pragma unroll
    for (int j = 0; j < kB; ++j) {
      rn[j] = rnorm[rset + 4 * j];
      bd[j] = INFINITY;
      bi[j] = kNoIndex;
    }

    int q = s * nch;
    for (int ch = 0; ch < nch; ++ch, ++q) {
      const int slot = q % ring;
      float* buf = ring_buf + slot * slot_floats;
      uint32_t ea[kA];
      int code[kA];
      float en[kA];
#pragma unroll
      for (int i = 0; i < kA; ++i) {
        const int grp = sub + 8 * i;
        ea[i] = smem_u32(buf + grp * gpitch + warp * C);
        code[i] = k0 + ch * CODES + grp * kQ + warp;
        // clamped, not predicated: nothing waits for the load until the
        // distances
        en[i] = __ldg(norms + (size_t)s * K + min(code[i], K - 1));
      }
      mbar_wait(&bars[slot], (unsigned)(q / ring) & 1u);
      float acc[kA][kB];
      float4 ev[kA], rv[kB];
#pragma unroll
      for (int i = 0; i < kA; ++i) {
        ev[i] = lds4(ea[i]);
#pragma unroll
        for (int j = 0; j < kB; ++j) acc[i][j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < kB; ++j) rv[j] = lds4(ra + j * rstep);
      // software-pipelined: step c + 4's loads are in flight while step c
      // is summed (the last step reloads itself)
#pragma unroll 2
      for (int c = 0; c < C; c += 4) {
        const uint32_t next = 4u * (c + 4 < C ? c + 4 : c);
        float4 ev2[kA], rv2[kB];
#pragma unroll
        for (int i = 0; i < kA; ++i) ev2[i] = lds4(ea[i] + next);
#pragma unroll
        for (int j = 0; j < kB; ++j) rv2[j] = lds4(ra + j * rstep + next);
#pragma unroll
        for (int j = 0; j < kB; ++j) {
#pragma unroll
          for (int i = 0; i < kA; ++i) {
            acc[i][j] = fmaf(rv[j].x, ev[i].x, acc[i][j]);
            acc[i][j] = fmaf(rv[j].y, ev[i].y, acc[i][j]);
            acc[i][j] = fmaf(rv[j].z, ev[i].z, acc[i][j]);
            acc[i][j] = fmaf(rv[j].w, ev[i].w, acc[i][j]);
          }
        }
#pragma unroll
        for (int i = 0; i < kA; ++i) ev[i] = ev2[i];
#pragma unroll
        for (int j = 0; j < kB; ++j) rv[j] = rv2[j];
      }
      // a thread's codewords in increasing order, so a strict < keeps the
      // first index
#pragma unroll
      for (int i = 0; i < kA; ++i) {
        if (code[i] < k1) {
#pragma unroll
          for (int j = 0; j < kB; ++j) {
            // the reference's order: (||r||^2 - 2 r.e) + ||e||^2, no
            // contraction
            const float d =
                __fadd_rn(__fsub_rn(rn[j], __fmul_rn(2.f, acc[i][j])), en[i]);
            if (d < bd[j]) {
              bd[j] = d;
              bi[j] = code[i];
            }
          }
        }
      }
      if (ch + 1 < nch) {
        __syncthreads();  // every thread has scored the slot: refill it
        if (q + ring < total) {
          issue_chunk<CODES>(buf, &bars[slot], books, q + ring, nch, K, C,
                             k0, k1, tid);
        }
      }
    }

    // this warp's candidate per row, over the 8 lanes that share the row
    const int par = (s & 1) * TM * kWarps;
#pragma unroll
    for (int j = 0; j < kB; ++j) {
      float d = bd[j];
      int i = bi[j];
      shfl_best(d, i, 4);
      if (sub == 0) {
        const int at = par + (rset + 4 * j) * kWarps + warp;
        cd[at] = d;
        ci[at] = i;
      }
    }
    // every thread has scored the stage's last chunk: refill its slot
    // while the cluster barrier completes. After the barrier every CTA's
    // candidates of stage s are written (and, by the previous stage's
    // barrier, nobody still reads this parity's older candidates).
    __syncthreads();
    cluster_arrive();
    --q;
    if (q + ring < total) {
      issue_chunk<CODES>(ring_buf + (q % ring) * slot_floats,
                         &bars[q % ring], books, q + ring, nch, K, C, k0, k1,
                         tid);
    }
    cluster_wait();
    // merge: warp w reduces the G * kWarps candidates of each of its rows,
    // read from the cluster's CTAs, by the same total order
    float md[kRw];
    int win[kRw];
#pragma unroll
    for (int j = 0; j < kRw; ++j) {
      md[j] = INFINITY;
      win[j] = kNoIndex;
    }
    for (int e = lane; e < G * kWarps; e += 32) {
#pragma unroll
      for (int j = 0; j < kRw; ++j) {
        const int at = par + (warp + kWarps * j) * kWarps + e % kWarps;
        const float od = *cluster.map_shared_rank(cd + at, e / kWarps);
        const int oi = *cluster.map_shared_rank(ci + at, e / kWarps);
        if (better(od, oi, md[j], win[j])) {
          md[j] = od;
          win[j] = oi;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kRw; ++j) {
      shfl_best(md[j], win[j], 16);
      if (win[j] == kNoIndex) win[j] = 0;  // no finite distance: index 0
      const int row = warp + kWarps * j;
      if (rank == 0 && lane == 0 && row0 + row < M) {
        idx[(size_t)s * M + row0 + row] = win[j];
      }
    }
    update_rows<kRw>(res, ldr, rnorm, books + (size_t)s * K * C, win, warp,
                     C, lane);
  }
  cluster.sync();  // no CTA leaves while another may read its candidates
}

using KernelFn = void (*)(const float*, const float*, const float*,
                          int32_t*, int, int, int, int, int, int, int);

KernelFn kernel_for(int codes, int rows) {
  if (codes == 128 && rows == 8) return &rvq_cluster_kernel<128, 8>;
  if (codes == 128 && rows == 16) return &rvq_cluster_kernel<128, 16>;
  if (codes == 64 && rows == 8) return &rvq_cluster_kernel<64, 8>;
  if (codes == 64 && rows == 16) return &rvq_cluster_kernel<64, 16>;
  return nullptr;
}

// Dynamic shared memory of one CTA, or -1 for a shape no instance takes.
long smem_bytes(int C, int rows, int codes, int ring) {
  if (C <= 0 || C % 4 || !kernel_for(codes, rows) || ring < 1 ||
      ring > kMaxRing) {
    return -1;
  }
  const long floats = (long)ring * (codes / kQ) * (kQ * C + kPad) +
                      (long)rows * (C + kPad) + rows + 4L * rows * kWarps;
  return kBarBytes + 4 * floats;
}

cudaLaunchConfig_t cluster_config(int cluster, int blocks, long smem,
                                  cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

extern "C" {

// Allow launches of up to `max_smem` bytes of dynamic shared memory and
// clusters of up to 16 CTAs on the current device. Call once per device
// before the first launch there; returns the cudaError_t (0 on success).
int rvq_cascade_init(int max_smem) {
  // every instance: chunks of 64 or 128 codewords, 8 or 16 rows
  for (int k = 0; k < 4; ++k) {
    const void* fn = reinterpret_cast<const void*>(
        kernel_for(k < 2 ? 64 : 128, k % 2 ? 16 : 8));
    cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(
          fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    }
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// *out = how many clusters of `cluster` CTAs of the instance (rows, codes)
// with `smem` bytes of shared memory (the plan's, which must be this
// file's layout for C and `ring`) the current device can hold at once (0:
// none fits). Returns the cudaError_t of the query.
int rvq_cascade_max_clusters(int cluster, int rows, int codes, int ring,
                             int C, int smem, int* out) {
  if (smem < 0 || smem != smem_bytes(C, rows, codes, ring) || cluster < 1 ||
      cluster > kMaxCluster) {
    return (int)cudaErrorInvalidValue;
  }
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(cluster, cluster, smem, 0, &attr);
  return (int)cudaOccupancyMaxActiveClusters(
      out, reinterpret_cast<const void*>(kernel_for(codes, rows)), &cfg);
}

// x [M, C], books [>=n, K, C], norms [>=n, K] (all f32, contiguous,
// 16-byte aligned), idx [n, M] int32; the plan from rvq_plan: clusters of
// `cluster` CTAs on `rows` rows, slices of `slice` codewords in `chunks`
// chunks of up to `codes`, a ring of `ring` chunk slots, `smem` bytes of
// shared memory. Launches ceil(M / rows) clusters on `stream`, which
// belongs to the current device, and returns the cudaError_t of the
// launch (0 on success; cudaErrorInvalidValue for a plan that does not
// cover K or disagrees with this file's layout).
int rvq_cascade(const float* x, const float* books, const float* norms,
                int32_t* idx, int M, int K, int C, int n, int cluster,
                int rows, int codes, int ring, int slice, int chunks,
                int smem, void* stream) {
  if (M <= 0 || n <= 0) return 0;
  if (K <= 0 || smem < 0 || smem != smem_bytes(C, rows, codes, ring) ||
      cluster < 1 || cluster > kMaxCluster || slice < 1 ||
      (long)slice * cluster < K || chunks < 1 ||
      (long)chunks * codes < slice) {
    return (int)cudaErrorInvalidValue;
  }
  const long blocks = (long)cluster * ((M + rows - 1) / rows);
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg =
      cluster_config(cluster, (int)blocks, smem,
                     static_cast<cudaStream_t>(stream), &attr);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel_for(codes, rows), x,
                                           books, norms, idx, M, K, C, n,
                                           ring, slice, chunks);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // extern "C"
