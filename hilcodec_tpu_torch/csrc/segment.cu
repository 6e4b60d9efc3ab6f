/*
 * Fused streaming frame step of the HILCodec decoder and encoder for Hopper
 * (sm_90a), with a plain C interface.
 *
 * Replaces hilcodec_tpu/ops/pallas_decoder.py::_segment_kernel, the kernel
 * that DecoderMegakernel.step (decoder) and EncoderMegakernel.step
 * (hilcodec_tpu/ops/pallas_encoder.py, encoder) launch once per segment.
 * One launch here runs a whole frame step: every op of the op list that
 * ops/decoder_kernel.py and ops/encoder_kernel.py build, reading each
 * layer's cache and writing its successor.
 *
 * What it computes: the op chain of _segment_kernel, time-major [B, T, C]:
 *   pw        1x1 conv, [B*T, Cin] x [Cin, Cout] (+ bias)
 *   dw        depthwise causal conv over [cache; x] (k taps, dilation d)
 *   convt     depthwise transposed conv, k = 2r, s = r, one-frame cache:
 *             y[t*r+i] = xc[t] wA[i] + xc[t+1] wB[i]
 *   post      k-tap conv down to one channel
 *   dense1ch  conv_pre from the raw one-channel wav window
 *   dws       strided depthwise downsample, k = 2s, s-frame cache
 *   mix       x += log|STFT| x W + b (the SpecBlock, folded)
 *   l2norm    x / max(||x||, eps) * sqrt(C)
 *   act, scale, res_begin, res_end
 * The Python side turns the op list into "phases": act, scale and a
 * residual pre-scale become transforms applied where the next conv loads its
 * input (and where it writes the new cache), res_end becomes the epilogue of
 * the conv before it, and the rest are one phase each (60 phases for the
 * flagship decoder, 49 for the encoder). A table of phases in device memory,
 * built once per (model, batch), drives the kernel; for each GEMM phase it
 * also holds the tile shape and the K-split that the lowering chose.
 *
 * Bound on an H100 SXM: the 1x1 convs are ~98% of the operations, ~318
 * MFLOP per stream for the flagship decoder, ~117 MFLOP for the encoder,
 * against 26 MB and 12 MB of folded weights read once per step and
 * ~0.35 / 0.25 MB of caches per stream, so operations bound both steps at
 * 16 streams and more. With the 1x1 convs on the tensor cores at three
 * TF32 products per f32 product (495 / 3 = 165 TFLOP/s of f32-accurate
 * work) and the rest on the CUDA cores (67 TFLOP/s f32), the decoder needs
 * 0.032 ms at 16 streams and 0.26 ms at 128; with everything on the CUDA
 * cores, 0.076 and 0.61 ms. What holds the kernel above that (PERF.md):
 * the GEMM phases' instruction issue (operand splits beside mma.sync) and
 * the fill latency of their tiles, the ~60 grid barriers (~5 us each with
 * a phase of little work) and, at 128 streams, the depthwise phases' bytes.
 *
 * Design: one cooperative launch of a persistent grid (two 256-thread
 * blocks per SM) that walks the phase table and synchronizes the whole grid
 * (cooperative_groups grid.sync) between phases, so that every phase spreads
 * over all SMs whatever the number of streams.
 * Activations do not fit in shared memory (a flagship decoder stream holds
 * up to 61,440 floats, 240 KB, in its last stages), so they live in three
 * global scratch buffers the wrapper allocates once per plan; the Python
 * side picks, for each phase, a buffer that is neither its input nor a live
 * residual. Caches are read from one buffer and written to another, so no
 * read of an old cache can see a new one.
 *
 * GEMM phases (pw, mix):
 *  - tensor cores with f32 accuracy (3xTF32): each A and W element is split
 *    on the fly into a TF32 high and low part, and mma.sync m16n8k8
 *    accumulates lo*hi + hi*lo + hi*hi in f32; the lo*lo term (~2^-22
 *    relative) is dropped. Plain TF32 would keep ~3 digits. W stays f32 in
 *    memory: split copies would not fit beside the activations in L2.
 *  - a tile per phase from SEGMENT_TILES and a K-split S, both chosen by
 *    the lowering (ops/decoder_kernel.py gemm_tiling) so that tiles x S
 *    fills the grid; k-blocks of 32. The eight warps of a block split a
 *    tile in M, N and, for small tiles, in k8 steps; those partial tiles
 *    are summed in shared memory in a fixed order.
 *  - a 3-stage shared-memory ring fed by 16-byte cp.async.cg (L2 only:
 *    other SMs wrote the activations before the last grid barrier, and L1
 *    is not coherent across it); rows whose length is not a multiple of 4
 *    (the mix's STFT bins) take 4-byte copies (cp.async.ca: the aux inputs
 *    and the weights are never written in a launch) or, for activations,
 *    plain loads. Pending transforms run once per element of a landed
 *    stage. Padded row pitches make the fragment loads conflict-free.
 *  - the epilogue goes through shared memory: bias, residual and the store
 *    in float4s along rows.
 *  - deterministic split-K: each slice stores its partial tile to a
 *    workspace; the block that finishes a tile last (a per-tile counter
 *    after __threadfence) sums the S partials in slice order 0..S-1, adds
 *    bias and residual, stores, and resets the counter to 0. No float
 *    atomics: a launch gives the same bits every time.
 * Storage types: the step's input x, its output y, the aux inputs and the
 * packed caches are each f32 or bf16 (a flag per group, from the wrapper),
 * as the Pallas kernel reads whatever dtype its refs hold and widens it to
 * f32. Everything in between is f32: bf16 is widened where it is loaded
 * and rounded to nearest even only where a cache or the output is stored.
 * A bf16 GEMM operand (the decoder's latents, the encoder's log-magnitudes)
 * takes plain loads widened into the f32 shared tile; the depthwise family
 * on bf16 caches is a separate out-of-line instance (run_depthwise_bf16),
 * so the f32 path keeps its register allocation. The weights are always
 * f32: a bf16 tree (--dtype bf16w / bf16) is widened once, exactly, when
 * the wrapper packs it (ops/decoder_kernel.py prepare_weights), since the
 * GEMM's 16-byte cp.async ring and its TF32 splits take f32, and the
 * weights (26 MB at most) sit in the 50 MB L2 between frames.
 * Depthwise family (dw, dws, convt, post): a thread (a warp for post) takes
 * 4 consecutive channels as float4 and a run of kRun output steps, and
 * loads every input row of the run (transformed once) before its first
 * product, so the loads overlap; 32-bit index arithmetic. A phase whose
 * channels or pointers do not allow float4 takes the same code with one
 * channel.
 */
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 2;
constexpr int kMaxPre = 4;
constexpr int kMaxAux = 8;
constexpr int kBK = 32;            // GEMM k-block
constexpr int kStages = 3;         // cp.async ring depth
constexpr int kAPitch = kBK + 4;   // A tile row pitch, floats
constexpr int kRun = 4;            // output steps per thread, depthwise family
constexpr int kTaps = 5;           // taps whose rows a thread holds at once
constexpr unsigned kFull = 0xffffffffu;

// phase kinds and transforms: the same numbers as ops/decoder_kernel.py
enum Kind {
  kEwise = 0, kPw = 1, kDw = 2, kConvT = 3, kPost = 4, kDense1ch = 5,
  kDws = 6, kMix = 7, kL2norm = 8
};
enum Unary { kElu = 1, kRelu = 2, kTanh = 3, kScale = 4 };
// how a GEMM operand reaches shared memory
enum Load { kVec16 = 0, kAsync4 = 1, kPlain = 2, kBf16 = 3 };
// storage-type flags of segment_run's `dtypes`: which tensors are bf16
enum DtypeBit { kXBf16 = 1, kYBf16 = 2, kAuxBf16 = 4, kCacheBf16 = 8 };

// One phase; the layout of PHASE_DTYPE in ops/decoder_kernel.py. Buffers:
// -1 is the step's input x (src) or output y (dst), 0..2 a scratch buffer.
// Offsets count floats: w, w2, bias into the packed weights (-1: none),
// cache into the packed cache buffers (-1: none). GEMM phases: a bm x bn
// tile, `splits` K-slices of `kslice` (the last one shorter).
struct Phase {
  int kind, src, dst, res, aux;
  int t_in, t_out, c_in, c_out, k, d;
  int w, w2, bias, cache, cache_len;
  int n_pre;
  int pre_kind[kMaxPre];
  float pre_scale[kMaxPre];
  float eps, gain;
  int bm, bn, splits, kslice;
};
static_assert(sizeof(Phase) == 124, "Phase must match PHASE_DTYPE");

// x, y, the caches and the aux inputs hold f32 or bf16 (the flags).
struct Args {
  const void* x;
  void* y;
  float* buf[3];
  const void* cache_in;
  void* cache_out;
  const float* weights;
  const void* aux[kMaxAux];
  float* ws;       // split-K partial tiles
  int* counters;   // split-K arrivals per tile, 0 between phases
  bool x_bf16, y_bf16, aux_bf16, cache_bf16;
};

// The transforms of a phase, read once from its table entry.
struct Pre {
  int n;
  int kind[kMaxPre];
  float scale[kMaxPre];
};

__device__ __forceinline__ Pre pre_of(const Phase& p) {
  Pre t;
  t.n = p.n_pre;
#pragma unroll
  for (int i = 0; i < kMaxPre; ++i) {
    t.kind[i] = p.pre_kind[i];
    t.scale[i] = p.pre_scale[i];
  }
  return t;
}

// ELU (alpha 1) to within a few f32 ulps of expm1f, in about half its
// instructions: a degree-8 Taylor polynomial of expm1 on [-0.5, 0]
// (truncation < 1.5e-8 relative), exp(x) - 1 below (|result| > 0.39, so
// __expf's ~2^-22 relative error stays below 4e-7 of it).
__device__ __forceinline__ float elu(float x) {
  float q = 1.f / 40320.f;
  q = fmaf(q, x, 1.f / 5040.f);
  q = fmaf(q, x, 1.f / 720.f);
  q = fmaf(q, x, 1.f / 120.f);
  q = fmaf(q, x, 1.f / 24.f);
  q = fmaf(q, x, 1.f / 6.f);
  q = fmaf(q, x, 0.5f);
  q = fmaf(q, x, 1.f);
  const float small = q * x;
  const float large = __expf(x) - 1.f;
  return x > 0.f ? x : (x > -0.5f ? small : large);
}

// The transforms, in order, on V values (one decode for all V).
template <int V>
__device__ __forceinline__ void apply(const Pre& t, float (&v)[V]) {
#pragma unroll
  for (int i = 0; i < kMaxPre; ++i) {
    if (i >= t.n) break;
    const int kind = t.kind[i];
    if (kind == kElu) {
#pragma unroll
      for (int e = 0; e < V; ++e) v[e] = elu(v[e]);
    } else if (kind == kRelu) {
#pragma unroll
      for (int e = 0; e < V; ++e) v[e] = fmaxf(v[e], 0.f);
    } else if (kind == kTanh) {
#pragma unroll
      for (int e = 0; e < V; ++e) v[e] = tanhf(v[e]);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) v[e] *= t.scale[i];
    }
  }
}

__device__ __forceinline__ float apply1(const Pre& t, float x) {
  float v[1] = {x};
  apply<1>(t, v);
  return v[0];
}

// A phase's source and destination as f32; the wrapper's lowering lets a
// bf16 x or y be read or written only through ld_src / st_dst and the GEMM.
__device__ __forceinline__ const float* src_of(const Args& a, int s) {
  return s < 0 ? static_cast<const float*>(a.x) : a.buf[s];
}

__device__ __forceinline__ float* dst_of(const Args& a, int s) {
  return s < 0 ? static_cast<float*>(a.y) : a.buf[s];
}

__device__ __forceinline__ float ld_src(const Args& a, int s, int i) {
  if (s < 0 && a.x_bf16)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(a.x)[i]);
  return src_of(a, s)[i];
}

__device__ __forceinline__ void st_dst(const Args& a, int s, int i,
                                       float v) {
  if (s < 0 && a.y_bf16) {
    static_cast<__nv_bfloat16*>(a.y)[i] = __float2bfloat16_rn(v);
  } else {
    dst_of(a, s)[i] = v;
  }
}

__device__ __forceinline__ int gthread() {
  return blockIdx.x * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ int gstride() { return gridDim.x * blockDim.x; }

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// ---------------------------------------------------------------- GEMM

// A GEMM tile: BM x BN over the eight warps, kWarpsM x kWarpsN x kWarpsK.
// A warp computes a WM x WN part (m16n8 fragments, at most 32 accumulators
// a thread, which keeps the kernel within __launch_bounds__'s 128
// registers) over every kWarpsK-th k8 step of a k-block; the kWarpsK
// partial tiles are summed in shared memory in a fixed order. A stage is
// A [BM][kAPitch] then W [kBK][BN + 8]: the pitches (4 and 8 mod 32 banks)
// make the fragment loads conflict-free and keep rows 16-byte aligned for
// cp.async. Each thread copies fixed 16-byte chunks of every stage.
template <int BM_, int BN_, int WM, int WN>
struct Tile {
  static constexpr int BM = BM_, BN = BN_;
  static constexpr int kWarpsM = BM / WM, kWarpsN = BN / WN;
  static constexpr int kWarpsK = kWarps / (kWarpsM * kWarpsN);
  static constexpr int kMT = WM / 16, kNT = WN / 8;
  static constexpr int kBPitch = BN + 8;
  static constexpr int kCPitch = BN + 8;   // the summed tile [BM][kCPitch]
  static constexpr int kAFloats = BM * kAPitch;
  static constexpr int kStageFloats = kAFloats + kBK * kBPitch;
  static constexpr int kAChunks = (BM * kBK / 4 + kThreads - 1) / kThreads;
  static constexpr int kWChunks = kBK * BN / 4 / kThreads;
  static_assert(WM % 16 == 0 && WN % 8 == 0, "warp part of m16n8 fragments");
  static_assert(kWarpsM * kWarpsN * kWarpsK == kWarps &&
                    (kBK / 8) % kWarpsK == 0, "warps of a tile");
  static_assert(kMT * kNT <= 8, "at most 32 accumulators a thread");
  static_assert(kBK * BN / 4 % kThreads == 0, "whole W chunks a thread");
  static_assert(BM * kCPitch <= kStages * kStageFloats,
                "the summed tile fits the ring");
};

// The instances of gemm<Tile<BM, BN, WM, WN>> (ops/decoder_kernel.py
// TILES); the ring is sized for the largest stage.
#define SEGMENT_TILES(X) \
  X(16, 64, 16, 32)      \
  X(32, 32, 32, 16)      \
  X(32, 64, 32, 32)      \
  X(32, 96, 16, 48)      \
  X(64, 64, 32, 32)      \
  X(64, 96, 32, 24)      \
  X(64, 128, 32, 32)     \
  X(128, 64, 32, 32)

constexpr int cmax(int a) { return a; }
template <class... R>
constexpr int cmax(int a, int b, R... r) {
  return cmax(a > b ? a : b, r...);
}
#define SEGMENT_STAGE(TM, TN, WM, WN) , Tile<TM, TN, WM, WN>::kStageFloats
constexpr int kSmemFloats = kStages * cmax(0 SEGMENT_TILES(SEGMENT_STAGE));
#undef SEGMENT_STAGE
constexpr int kSmemBytes = kSmemFloats * (int)sizeof(float);

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared through L2 only; zeros when !ok
__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared; only for data no block writes in a launch
__device__ __forceinline__ void cp4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x = hi + lo as TF32 operands, each rounded to nearest (ties away) on its
// 10 mantissa bits, as cvt.rna.tf32.f32 rounds but in four instructions
// instead of seven: the operands are finite, so cvt's Inf/NaN guard goes,
// and lo keeps its low 13 bits, which the tensor core ignores.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// What a GEMM phase reads and writes, from its table entry: out = pre(A) W
// (+ bias) (+ R), A [M, K], W [K, N] row-major. The GEMM rebuilds it where
// it needs it (from shared memory and the kernel's parameters) instead of
// holding it in registers through its k-loop.
struct GemmOps {
  const float* A;
  const __nv_bfloat16* Ah;   // A when it is bf16 (a_mode kBf16)
  const float* W;
  const float* bias;
  const float* R;   // may alias out: each element is read and written by
  float* out;       // the same thread
  int M, N, K;
  int a_mode;       // how A reaches shared memory
  bool w_vec;       // W in 16-byte chunks
  bool o_vec;       // the epilogue in float4s
};

__device__ __forceinline__ GemmOps gemm_ops(const Phase& p, const Args& a,
                                            int B) {
  GemmOps g;
  const bool mix = p.kind == kMix;
  const void* A = mix ? a.aux[p.aux] : (p.src < 0 ? a.x : a.buf[p.src]);
  const bool a_bf16 = mix ? a.aux_bf16 : (p.src < 0 && a.x_bf16);
  g.A = static_cast<const float*>(A);
  g.Ah = static_cast<const __nv_bfloat16*>(A);
  g.W = a.weights + p.w;
  g.bias = p.bias >= 0 ? a.weights + p.bias : nullptr;
  g.R = p.res >= 0 ? a.buf[p.res] : nullptr;
  g.out = dst_of(a, p.dst);
  g.M = B * p.t_in;
  g.N = p.c_out;
  g.K = p.c_in;
  g.a_mode = a_bf16 ? kBf16
             : (g.K % 4 == 0 && aligned16(g.A)) ? kVec16
                                                 : (mix ? kAsync4 : kPlain);
  g.w_vec = g.N % 4 == 0 && aligned16(g.W);
  g.o_vec = g.N % 4 == 0 && aligned16(g.out) &&
            (!g.R || aligned16(g.R)) && (!g.bias || aligned16(g.bias));
  return g;
}

// out = v (+ bias) (+ R) for the four columns gn..gn+3 of row gm, as one
// float4 where the phase allows it.
__device__ __forceinline__ void store4(const GemmOps& e, float4 v, int gm,
                                       int gn) {
  if (gm >= e.M) return;
  if (e.o_vec) {
    if (gn >= e.N) return;
    const size_t o = (size_t)gm * e.N + gn;
    if (e.bias) {
      const float4 b = __ldg(reinterpret_cast<const float4*>(e.bias + gn));
      v.x += b.x; v.y += b.y; v.z += b.z; v.w += b.w;
    }
    if (e.R) {
      const float4 r = __ldcg(reinterpret_cast<const float4*>(e.R + o));
      v.x += r.x; v.y += r.y; v.z += r.z; v.w += r.w;
    }
    *reinterpret_cast<float4*>(e.out + o) = v;
    return;
  }
  const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (gn + j >= e.N) break;
    const size_t o = (size_t)gm * e.N + gn + j;
    float x = vs[j];
    if (e.bias) x += __ldg(e.bias + gn + j);
    if (e.R) x += __ldcg(e.R + o);
    e.out[o] = x;
  }
}

// A GEMM phase (gemm_ops) as (tile, K-slice) work items spread over the
// grid.
template <class T>
__device__ void gemm(const Phase& p, const Args& a, int B, float* smem,
                     int* last) {
  constexpr int BM = T::BM, BN = T::BN;
  constexpr int WM = T::kMT * 16, WN = T::kNT * 8;
  const int M = B * p.t_in, N = p.c_out;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int wk = warp % T::kWarpsK, wmn = warp / T::kWarpsK;
  const int wm = wmn / T::kWarpsN, wn = wmn % T::kWarpsN;
  const int tiles_n = (N + BN - 1) / BN;
  const int tiles = ((M + BM - 1) / BM) * tiles_n;
  const int S = p.splits;
  // this thread's A chunks: rows (tid >> 3) + 32 i, columns ak..ak+3
  const int ak = (tid & 7) * 4;
  for (int item = blockIdx.x; item < tiles * S; item += gridDim.x) {
    const int tile = item / S, s = item - tile * S;
    const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * BN;
    const int kbeg = s * p.kslice, kend = min(p.c_in, kbeg + p.kslice);
    const int nkb = (kend - kbeg + kBK - 1) / kBK;
    auto issue = [&](int kb) {
      const GemmOps op = gemm_ops(p, a, B);
      const float* A = op.A;
      const float* W = op.W;
      const int K = op.K;
      float* As = smem + (kb % kStages) * T::kStageFloats;
      float* Ws = As + T::kAFloats;
      const int k0 = kbeg + kb * kBK;
      if (op.a_mode == kVec16) {
        const bool kin = k0 + ak < kend;
#pragma unroll
        for (int i = 0; i < T::kAChunks; ++i) {
          const int r = (tid >> 3) + i * (kThreads / 8);
          const bool ok = kin && m0 + r < M;
          if (r < BM) {
            cp16(As + r * kAPitch + ak,
                 ok ? A + (size_t)(m0 + r) * K + k0 + ak : A, ok);
          }
        }
      } else {
#pragma unroll 1
        for (int e = tid; e < BM * kBK; e += kThreads) {
          const int r = e / kBK, kk = e % kBK;
          const int gm = m0 + r, gk = k0 + kk;
          const bool ok = gm < M && gk < kend;
          const size_t at = ok ? (size_t)gm * K + gk : 0;
          if (op.a_mode == kAsync4) {
            cp4(As + r * kAPitch + kk, A + at, ok);
          } else if (op.a_mode == kBf16) {   // never written in a launch
            As[r * kAPitch + kk] = ok ? __bfloat162float(op.Ah[at]) : 0.f;
          } else {
            As[r * kAPitch + kk] = ok ? __ldcg(A + at) : 0.f;
          }
        }
      }
      if (op.w_vec) {
#pragma unroll
        for (int i = 0; i < T::kWChunks; ++i) {
          const int c = tid + i * kThreads;
          const int kr = c / (BN / 4), nn = (c % (BN / 4)) * 4;
          const bool ok = k0 + kr < kend && n0 + nn < N;
          cp16(Ws + kr * T::kBPitch + nn,
               ok ? W + (size_t)(k0 + kr) * N + n0 + nn : W, ok);
        }
      } else {
#pragma unroll 1
        for (int e = tid; e < kBK * BN; e += kThreads) {
          const int kr = e / BN, nn = e % BN;
          const int gk = k0 + kr, gn = n0 + nn;
          const bool ok = gk < kend && gn < N;
          cp4(Ws + kr * T::kBPitch + nn,
              ok ? W + (size_t)gk * N + gn : W, ok);
        }
      }
    };

    float acc[T::kMT][T::kNT][4];
#pragma unroll
    for (int mi = 0; mi < T::kMT; ++mi) {
#pragma unroll
      for (int ni = 0; ni < T::kNT; ++ni) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
      }
    }
    __syncthreads();   // the previous item is done with the ring
#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) {
      if (st < nkb) issue(st);
      cp_commit();
    }
    for (int kb = 0; kb < nkb; ++kb) {
      cp_wait<kStages - 2>();
      __syncthreads();   // stage kb landed; stage kb-1 read by every warp
      if (kb + kStages - 1 < nkb) issue(kb + kStages - 1);
      cp_commit();
      float* As = smem + (kb % kStages) * T::kStageFloats;
      const float* Ws = As + T::kAFloats;
      if (p.kind != kMix && p.n_pre > 0) {   // each landed element once
        const Pre tf = pre_of(p);
        for (int c = tid; c < BM * kBK / 4; c += kThreads) {
          float4* v = reinterpret_cast<float4*>(
              As + (c / (kBK / 4)) * kAPitch + (c % (kBK / 4)) * 4);
          float x[4] = {v->x, v->y, v->z, v->w};
          apply<4>(tf, x);
          *v = make_float4(x[0], x[1], x[2], x[3]);
        }
        __syncthreads();
      }
#pragma unroll 1   // fragments of one k8 step at a time
      for (int ks = wk; ks < kBK / 8; ks += T::kWarpsK) {
        uint32_t ah[T::kMT][4], al[T::kMT][4];
#pragma unroll
        for (int mi = 0; mi < T::kMT; ++mi) {
          const float* ap = As + (wm * WM + mi * 16 + g) * kAPitch + ks * 8 + q;
          split_tf32(ap[0], ah[mi][0], al[mi][0]);
          split_tf32(ap[8 * kAPitch], ah[mi][1], al[mi][1]);
          split_tf32(ap[4], ah[mi][2], al[mi][2]);
          split_tf32(ap[8 * kAPitch + 4], ah[mi][3], al[mi][3]);
        }
#pragma unroll
        for (int ni = 0; ni < T::kNT; ++ni) {
          const float* bp =
              Ws + (ks * 8 + q) * T::kBPitch + wn * WN + ni * 8 + g;
          uint32_t bh[2], bl[2];
          split_tf32(bp[0], bh[0], bl[0]);
          split_tf32(bp[4 * T::kBPitch], bh[1], bl[1]);
#pragma unroll
          for (int mi = 0; mi < T::kMT; ++mi) {
            mma_tf32(acc[mi][ni], al[mi], bh);
            mma_tf32(acc[mi][ni], ah[mi], bl);
            mma_tf32(acc[mi][ni], ah[mi], bh);
          }
        }
      }
    }
    cp_wait<0>();
    __syncthreads();   // every warp is done with the ring

    // the k-groups' partial tiles summed into Cs, group 0 first
    float* Cs = smem;
#pragma unroll
    for (int grp = 0; grp < T::kWarpsK; ++grp) {
      if (wk == grp) {
#pragma unroll
        for (int mi = 0; mi < T::kMT; ++mi) {
#pragma unroll
          for (int ni = 0; ni < T::kNT; ++ni) {
            const int row = wm * WM + mi * 16 + g;
            const int col = wn * WN + ni * 8 + 2 * q;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float2* c = reinterpret_cast<float2*>(
                  Cs + (row + 8 * h) * T::kCPitch + col);
              float2 v =
                  make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
              if (grp > 0) {
                const float2 u = *c;
                v = make_float2(u.x + v.x, u.y + v.y);
              }
              *c = v;
            }
          }
        }
      }
      __syncthreads();
    }

    constexpr int kChunks = BM * BN / 4;
    const GemmOps ep = gemm_ops(p, a, B);
    if (S > 1) {
      // this slice's partial tile, then the block that finishes the tile
      // last sums the S partials in slice order
      float* part = a.ws + (size_t)item * (BM * BN);
      for (int c = tid; c < kChunks; c += kThreads) {
        const int r = c / (BN / 4), cc = (c % (BN / 4)) * 4;
        __stcg(reinterpret_cast<float4*>(part + r * BN + cc),
               *reinterpret_cast<const float4*>(Cs + r * T::kCPitch + cc));
      }
      __threadfence();
      __syncthreads();
      if (tid == 0) *last = atomicAdd(a.counters + tile, 1) == S - 1;
      __syncthreads();
      if (!*last) continue;
      __threadfence();
      const float* base = a.ws + (size_t)tile * S * (BM * BN);
      for (int c = tid; c < kChunks; c += kThreads) {
        const int r = c / (BN / 4), cc = (c % (BN / 4)) * 4;
        const float4* pt = reinterpret_cast<const float4*>(base + r * BN + cc);
        float4 v = __ldcg(pt);
        for (int sl = 1; sl < S; ++sl) {
          const float4 u = __ldcg(pt + sl * (BM * BN / 4));
          v.x += u.x; v.y += u.y; v.z += u.z; v.w += u.w;
        }
        store4(ep, v, m0 + r, n0 + cc);
      }
      if (tid == 0) a.counters[tile] = 0;
    } else {
      for (int c = tid; c < kChunks; c += kThreads) {
        const int r = c / (BN / 4), cc = (c % (BN / 4)) * 4;
        store4(ep, *reinterpret_cast<const float4*>(Cs + r * T::kCPitch + cc),
               m0 + r, n0 + cc);
      }
    }
  }
}

// Out of line: the GEMM gets a register allocation of its own (up to the
// 128 of __launch_bounds__), apart from the depthwise family's; inlined
// into the phase loop together, they spilled.
__device__ __noinline__ void run_gemm(const Phase& p, const Args& a, int B,
                                      float* smem, int* last) {
#define SEGMENT_GEMM(TM, TN, WM, WN)                            \
  if (p.bm == TM && p.bn == TN) {                               \
    gemm<Tile<TM, TN, WM, WN>>(p, a, B, smem, last);            \
    return;                                                     \
  }
  SEGMENT_TILES(SEGMENT_GEMM)
#undef SEGMENT_GEMM
  __trap();   // a tile the lowering does not emit
}

// ------------------------------------------------------ depthwise family

// V channels at p: float4 (V = 4) or one float. __ldcg for what other
// blocks wrote in this launch, __ldg for the weights.
template <int V>
__device__ __forceinline__ void ld(float (&v)[V], const float* p) {
  if constexpr (V == 4) {
    const float4 f = __ldcg(reinterpret_cast<const float4*>(p));
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  } else {
    v[0] = __ldcg(p);
  }
}

template <int V>
__device__ __forceinline__ void ldw(float (&v)[V], const float* p) {
  if constexpr (V == 4) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void st(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *p = v[0];
  }
}

// V bf16 channels at p widened to f32 (8 bytes for V = 4); a bf16 cache
// is never written in the launch that reads it.
template <int V>
__device__ __forceinline__ void ld(float (&v)[V], const __nv_bfloat16* p) {
  if constexpr (V == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 hi = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.y));
    v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
  } else {
    v[0] = __bfloat162float(*p);
  }
}

// V values rounded to nearest even into bf16 at p.
template <int V>
__device__ __forceinline__ void st(__nv_bfloat16* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 u;
    u.x = *reinterpret_cast<const uint32_t*>(&lo);
    u.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = u;
  } else {
    *p = __float2bfloat16_rn(v[0]);
  }
}

// The cache element type: f32, or bf16 under the kCacheBf16 flag.
template <bool CB>
using CacheT = typename std::conditional<CB, __nv_bfloat16, float>::type;

template <bool CB>
__device__ __forceinline__ const CacheT<CB>* cache_in_of(const Args& a,
                                                          const Phase& p) {
  return static_cast<const CacheT<CB>*>(a.cache_in) + p.cache;
}

template <bool CB>
__device__ __forceinline__ CacheT<CB>* cache_out_of(const Args& a,
                                                    const Phase& p) {
  return static_cast<CacheT<CB>*>(a.cache_out) + p.cache;
}

// Row pos of xc = [cache (clen rows); pre(x) (t_in rows)] for stream b,
// channels c..c+V-1.
template <int V, class CT>
__device__ __forceinline__ void xc_row(float (&v)[V], const Phase& p,
                                       const Pre& t, const CT* cache,
                                       const float* x, int b, int pos, int c) {
  const int clen = p.cache_len, C = p.c_in;
  if (pos < clen) {
    ld<V>(v, cache + (b * clen + pos) * C + c);
  } else {
    ld<V>(v, x + (b * p.t_in + pos - clen) * C + c);
    apply<V>(t, v);
  }
}

// Whether a phase of the depthwise family may move 4 channels at once.
__device__ __forceinline__ bool vec4_ok(const Phase& p, const Args& a) {
  const size_t el = a.cache_bf16 ? 2 : 4;   // bytes of a cache element
  const size_t co = (size_t)(p.cache < 0 ? 0 : p.cache) * el;
  const uintptr_t ci = reinterpret_cast<uintptr_t>(a.cache_in) + co;
  const uintptr_t cw = reinterpret_cast<uintptr_t>(a.cache_out) + co;
  return p.c_in % 4 == 0 && aligned16(src_of(a, p.src)) &&
         aligned16(dst_of(a, p.dst)) && ((ci | cw) & (4 * el - 1)) == 0 &&
         (p.res < 0 || aligned16(a.buf[p.res])) &&
         aligned16(a.weights + p.w) &&
         (p.w2 < 0 || aligned16(a.weights + p.w2)) &&
         (p.bias < 0 || aligned16(a.weights + p.bias));
}

// New cache: the last cache_len rows of xc.
template <int V, bool CB>
__device__ void write_cache(const Phase& p, const Args& a, int B) {
  const Pre tf = pre_of(p);
  const int clen = p.cache_len, C = p.c_in, CV = C / V;
  const CacheT<CB>* cin = cache_in_of<CB>(a, p);
  CacheT<CB>* cout = cache_out_of<CB>(a, p);
  const float* x = src_of(a, p.src);
  const int n = B * clen * CV;
  for (int u = gthread(); u < n; u += gstride()) {
    const int cv = u % CV, bl = u / CV;
    const int l = bl % clen, b = bl / clen;
    float v[V];
    xc_row<V>(v, p, tf, cin, x, b, p.t_in + l, cv * V);
    st<V>(cout + bl * C + cv * V, v);
  }
}

// Output steps t0 + i*d (i < kRun) of stream b. With k <= kTaps every xc
// row t0 + m*d of the run is loaded (and transformed) once, all before the
// first product, and feeds taps j = m - i; longer kernels walk the rows.
template <int V, bool CB>
__device__ void depthwise(const Phase& p, const Args& a, int B) {
  const Pre tf = pre_of(p);
  const int T = p.t_out, C = p.c_in, k = p.k, d = p.d, CV = C / V;
  const int rows = p.cache_len + p.t_in;
  const int span = d * kRun;
  const int groups = (T + span - 1) / span;
  const float* x = src_of(a, p.src);
  const CacheT<CB>* cin = cache_in_of<CB>(a, p);
  const float* w = a.weights + p.w;
  const float* bias = p.bias >= 0 ? a.weights + p.bias : nullptr;
  const float* r = p.res >= 0 ? a.buf[p.res] : nullptr;
  float* y = dst_of(a, p.dst);
  const int units = B * groups * d * CV;
  for (int u = gthread(); u < units; u += gstride()) {
    const int cv = u % CV;
    int rest = u / CV;
    const int rho = rest % d;
    rest /= d;
    const int grp = rest % groups, b = rest / groups;
    const int c = cv * V, t0 = grp * span + rho;
    float acc[kRun][V];
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
#pragma unroll
      for (int e = 0; e < V; ++e) acc[i][e] = 0.f;
    }
    if (k <= kTaps) {
      float win[kRun + kTaps - 1][V];
#pragma unroll
      for (int m = 0; m < kRun + kTaps - 1; ++m) {
        const int pos = t0 + m * d;
        if (m < kRun + k - 1 && pos < rows) {
          xc_row<V>(win[m], p, tf, cin, x, b, pos, c);
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e) win[m][e] = 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < kTaps; ++j) {
        if (j < k) {
          float wv[V];
          ldw<V>(wv, w + j * C + c);
#pragma unroll
          for (int i = 0; i < kRun; ++i) {
#pragma unroll
            for (int e = 0; e < V; ++e) acc[i][e] += win[i + j][e] * wv[e];
          }
        }
      }
    } else {
      for (int m = 0; m < kRun + k - 1; ++m) {
        const int pos = t0 + m * d;
        if (pos >= rows) break;
        float v[V];
        xc_row<V>(v, p, tf, cin, x, b, pos, c);
#pragma unroll
        for (int i = 0; i < kRun; ++i) {
          const int j = m - i;
          if (j >= 0 && j < k) {
            float wv[V];
            ldw<V>(wv, w + j * C + c);
#pragma unroll
            for (int e = 0; e < V; ++e) acc[i][e] += v[e] * wv[e];
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      const int to = t0 + i * d;
      if (to >= T) break;
      const int o = (b * T + to) * C + c;
      float v[V], bv[V], rv[V];
      if (bias) ldw<V>(bv, bias + c);
      if (r) ld<V>(rv, r + o);  // r may alias y: same element, same thread
#pragma unroll
      for (int e = 0; e < V; ++e) {
        v[e] = acc[i][e];
        if (bias) v[e] += bv[e];
        if (r) v[e] += rv[e];
      }
      st<V>(y + o, v);
    }
  }
}

// Input steps t0..t0+kRun-1 of stream b, all r phases of each.
template <int V, bool CB>
__device__ void conv_transpose(const Phase& p, const Args& a, int B) {
  const Pre tf = pre_of(p);
  const int C = p.c_in, r = p.d, T = p.t_in, To = p.t_out, CV = C / V;
  const int groups = (T + kRun - 1) / kRun;
  const float* x = src_of(a, p.src);
  const CacheT<CB>* cin = cache_in_of<CB>(a, p);
  const float* wa = a.weights + p.w;
  const float* wb = a.weights + p.w2;
  const float* bias = p.bias >= 0 ? a.weights + p.bias : nullptr;
  float* y = dst_of(a, p.dst);
  const int units = B * groups * CV;
  for (int u = gthread(); u < units; u += gstride()) {
    const int cv = u % CV, rest = u / CV;
    const int grp = rest % groups, b = rest / groups;
    const int c = cv * V, t0 = grp * kRun;
    float win[kRun + 1][V];   // xc rows t0..t0+kRun (xc has T + 1 rows)
#pragma unroll
    for (int m = 0; m <= kRun; ++m) {
      if (t0 + m <= T) {
        xc_row<V>(win[m], p, tf, cin, x, b, t0 + m, c);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) win[m][e] = 0.f;
      }
    }
    float bv[V];
#pragma unroll
    for (int e = 0; e < V; ++e) bv[e] = 0.f;
    if (bias) ldw<V>(bv, bias + c);
    for (int i = 0; i < r; ++i) {
      float va[V], vb[V];
      ldw<V>(va, wa + i * C + c);
      ldw<V>(vb, wb + i * C + c);
#pragma unroll
      for (int m = 0; m < kRun; ++m) {
        if (t0 + m >= T) break;
        float v[V];
#pragma unroll
        for (int e = 0; e < V; ++e) {
          v[e] = win[m][e] * va[e] + win[m + 1][e] * vb[e];
          if (bias) v[e] += bv[e];
        }
        st<V>(y + (b * To + (t0 + m) * r + i) * C + c, v);
      }
    }
  }
}

// Output steps t0..t0+kRun-1 of stream b: xc frames t0..t0+kRun (s rows
// each); row j of frame m feeds output m through w[j] and output m-1
// through w[s+j]. Row j of all kRun + 1 frames is loaded at once.
template <int V, bool CB>
__device__ void strided_depthwise(const Phase& p, const Args& a, int B) {
  const Pre tf = pre_of(p);
  const int To = p.t_out, C = p.c_in, s = p.d, CV = C / V;
  const int groups = (To + kRun - 1) / kRun;
  const float* x = src_of(a, p.src);
  const CacheT<CB>* cin = cache_in_of<CB>(a, p);
  const float* w = a.weights + p.w;
  const float* bias = p.bias >= 0 ? a.weights + p.bias : nullptr;
  float* y = dst_of(a, p.dst);
  const int units = B * groups * CV;
  for (int u = gthread(); u < units; u += gstride()) {
    const int cv = u % CV, rest = u / CV;
    const int grp = rest % groups, b = rest / groups;
    const int c = cv * V, t0 = grp * kRun;
    float acc[kRun][V];
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
#pragma unroll
      for (int e = 0; e < V; ++e) acc[i][e] = 0.f;
    }
    for (int j = 0; j < s; ++j) {
      float v[kRun + 1][V];
#pragma unroll
      for (int m = 0; m <= kRun; ++m) {
        if (t0 + m <= To) {   // xc holds frames 0..To
          xc_row<V>(v[m], p, tf, cin, x, b, (t0 + m) * s + j, c);
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e) v[m][e] = 0.f;
        }
      }
      float w0[V], w1[V];
      ldw<V>(w0, w + j * C + c);
      ldw<V>(w1, w + (s + j) * C + c);
#pragma unroll
      for (int i = 0; i < kRun; ++i) {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          acc[i][e] += v[i][e] * w0[e];
          acc[i][e] += v[i + 1][e] * w1[e];
        }
      }
    }
    float bv[V];
#pragma unroll
    for (int e = 0; e < V; ++e) bv[e] = 0.f;
    if (bias) ldw<V>(bv, bias + c);
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      if (t0 + i >= To) break;
      float v[V];
#pragma unroll
      for (int e = 0; e < V; ++e) v[e] = bias ? acc[i][e] + bv[e] : acc[i][e];
      st<V>(y + (b * To + t0 + i) * C + c, v);
    }
  }
}

__device__ void dense_one_channel(const Phase& p, const Args& a, int B) {
  const int T = p.t_out, Lw = p.t_in, C = p.c_out, k = p.k;
  const float* w = a.weights + p.w;
  const float* bias = p.bias >= 0 ? a.weights + p.bias : nullptr;
  float* y = dst_of(a, p.dst);
  const int n = B * T * C;
  for (int i = gthread(); i < n; i += gstride()) {
    const int c = i % C, bt = i / C;
    const int t = bt % T, b = bt / T;
    const int row = b * Lw + t;
    float acc = 0.f;
#pragma unroll 4   // the taps' loads issued together, not one at a time
    for (int j = 0; j < k; ++j) {
      acc += ld_src(a, p.src, row + j) * w[j * C + c];
    }
    if (bias) acc += bias[c];
    y[i] = acc;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// One output channel: y[b, t] = sum_j sum_c xc[t + j, c] w[j, c] (+ bias).
// A warp takes steps t0..t0+kRun-1 of stream b, its lanes the channels;
// with k <= kTaps a lane loads its rows of the run all at once.
template <int V, bool CB>
__device__ void post_conv(const Phase& p, const Args& a, int B) {
  const Pre tf = pre_of(p);
  const int T = p.t_out, C = p.c_in, k = p.k, CV = C / V;
  const int rows = p.cache_len + p.t_in;
  const int groups = (T + kRun - 1) / kRun;
  const float* x = src_of(a, p.src);
  const CacheT<CB>* cin = cache_in_of<CB>(a, p);
  const float* w = a.weights + p.w;
  float* y = dst_of(a, p.dst);
  const int lane = threadIdx.x & 31;
  const int units = B * groups;
  for (int u = gthread() >> 5; u < units; u += gstride() >> 5) {
    const int grp = u % groups, b = u / groups, t0 = grp * kRun;
    float acc[kRun];
#pragma unroll
    for (int i = 0; i < kRun; ++i) acc[i] = 0.f;
    for (int cv = lane; cv < CV; cv += 32) {
      const int c = cv * V;
      if (k <= kTaps) {
        float win[kRun + kTaps - 1][V];
#pragma unroll
        for (int m = 0; m < kRun + kTaps - 1; ++m) {
          if (m < kRun + k - 1 && t0 + m < rows) {
            xc_row<V>(win[m], p, tf, cin, x, b, t0 + m, c);
          } else {
#pragma unroll
            for (int e = 0; e < V; ++e) win[m][e] = 0.f;
          }
        }
#pragma unroll
        for (int j = 0; j < kTaps; ++j) {
          if (j < k) {
            float wv[V];
            ldw<V>(wv, w + j * C + c);
#pragma unroll
            for (int i = 0; i < kRun; ++i) {
#pragma unroll
              for (int e = 0; e < V; ++e) acc[i] += win[i + j][e] * wv[e];
            }
          }
        }
        continue;
      }
      for (int m = 0; m < kRun + k - 1; ++m) {
        if (t0 + m >= rows) break;
        float v[V];
        xc_row<V>(v, p, tf, cin, x, b, t0 + m, c);
#pragma unroll
        for (int i = 0; i < kRun; ++i) {
          const int j = m - i;
          if (j >= 0 && j < k) {
            float wv[V];
            ldw<V>(wv, w + j * C + c);
#pragma unroll
            for (int e = 0; e < V; ++e) acc[i] += v[e] * wv[e];
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRun; ++i) acc[i] = warp_sum(acc[i]);
    if (lane == 0) {
      const float bv = p.bias >= 0 ? a.weights[p.bias] : 0.f;
#pragma unroll
      for (int i = 0; i < kRun; ++i) {
        if (t0 + i < T) y[b * T + t0 + i] = p.bias >= 0 ? acc[i] + bv : acc[i];
      }
    }
  }
}

__device__ void l2norm(const Phase& p, const Args& a, int B) {
  const Pre tf = pre_of(p);
  const int C = p.c_in;
  const int lane = threadIdx.x & 31;
  const int rows = B * p.t_in;
  for (int row = gthread() >> 5; row < rows; row += gstride() >> 5) {
    float ss = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float v = apply1(tf, ld_src(a, p.src, row * C + c));
      ss += v * v;
    }
    const float den = fmaxf(sqrtf(warp_sum(ss)), p.eps);
    for (int c = lane; c < C; c += 32) {
      st_dst(a, p.dst, row * C + c,
             apply1(tf, ld_src(a, p.src, row * C + c)) / den * p.gain);
    }
  }
}

__device__ void ewise(const Phase& p, const Args& a, int B) {
  const Pre tf = pre_of(p);
  const float* r = p.res >= 0 ? a.buf[p.res] : nullptr;
  const int n = B * p.t_in * p.c_in;
  for (int i = gthread(); i < n; i += gstride()) {
    float v = apply1(tf, ld_src(a, p.src, i));
    if (r) v += r[i];
    st_dst(a, p.dst, i, v);
  }
}

// A depthwise-family phase and its cache write, with float4s where allowed.
template <int V, bool CB>
__device__ void depthwise_family(const Phase& p, const Args& a, int B) {
  switch (p.kind) {
    case kDw: depthwise<V, CB>(p, a, B); break;
    case kConvT: conv_transpose<V, CB>(p, a, B); break;
    case kPost: post_conv<V, CB>(p, a, B); break;
    default: strided_depthwise<V, CB>(p, a, B); break;
  }
  write_cache<V, CB>(p, a, B);
}

// Out of line, as run_gemm: the phase loop holds nothing in registers
// across either call, and each gets a register allocation of its own.
__device__ __noinline__ void run_depthwise(const Phase& p, const Args& a,
                                           int B) {
  if (vec4_ok(p, a)) {
    depthwise_family<4, false>(p, a, B);
  } else {
    depthwise_family<1, false>(p, a, B);
  }
}

// The same on bf16 caches, with an allocation of its own.
__device__ __noinline__ void run_depthwise_bf16(const Phase& p,
                                                const Args& a, int B) {
  if (vec4_ok(p, a)) {
    depthwise_family<4, true>(p, a, B);
  } else {
    depthwise_family<1, true>(p, a, B);
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
segment_kernel(const Phase* __restrict__ phases, int n_phases,
               const __grid_constant__ Args a, int B) {
  extern __shared__ __align__(16) float smem[];
  __shared__ Phase ph;
  __shared__ int last;
  // The phase index lives in shared memory, so that no register stays live
  // across the out-of-line GEMM (which may use all of them).
  __shared__ int at;
  if (threadIdx.x == 0) at = 0;
  for (;;) {
    __syncthreads();
    if (at >= n_phases) break;
    if (threadIdx.x == 0) ph = phases[at];
    __syncthreads();
    const Phase& p = ph;
    switch (p.kind) {
      case kEwise: ewise(p, a, B); break;
      case kPw:
      case kMix: run_gemm(p, a, B, smem, &last); break;
      case kDw:
      case kConvT:
      case kPost:
      case kDws:
        if (a.cache_bf16) {
          run_depthwise_bf16(p, a, B);
        } else {
          run_depthwise(p, a, B);
        }
        break;
      case kDense1ch: dense_one_channel(p, a, B); break;
      case kL2norm: l2norm(p, a, B); break;
      default: break;
    }
    const int next = at + 1;
    if (next < n_phases) cg::this_grid().sync();  // also a block barrier
    __syncthreads();   // every thread has read `at`
    if (threadIdx.x == 0) at = next;
  }
}

}  // namespace

extern "C" {

// Blocks of the persistent grid on the current device: kBlocksPerSm per SM,
// or fewer if the occupancy calculator allows fewer with the kernel's
// dynamic shared memory (which this call enables on the device). Writes
// them to *blocks and returns the cudaError_t (0 on success).
int segment_grid(int* blocks) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess && !coop) e = cudaErrorNotSupported;
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(segment_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, segment_kernel,
                                                      kThreads, kSmemBytes);
  if (e == cudaSuccess && per_sm < 1) e = cudaErrorInvalidConfiguration;
  if (e == cudaSuccess) *blocks = sms * (per_sm < kBlocksPerSm ? per_sm
                                                               : kBlocksPerSm);
  return (int)e;
}

// Run a frame step: the n_phases phases at `phases` (device memory) over B
// streams on a cooperative grid of `blocks` blocks (from segment_grid, which
// must have run on this device first).
// x: the step's input, y: its output; bufs: three scratch buffers, each of
// B times the largest activation of a stream, 16-byte aligned; cache_in /
// cache_out: the packed caches before and after (distinct buffers);
// weights: the packed weights; aux: up to 8 aux inputs (the encoder's
// log-magnitudes); ws: the split-K workspace (the largest splits x tiles x
// BM x BN of a phase); counters: one int per tile of the largest split
// phase, all 0 (the kernel leaves them 0). dtypes: the DtypeBit flags of
// x, y, the aux inputs and the caches that hold bf16 (the rest f32); the
// wrapper's lowering reads a bf16 x only in a pw, dense1ch or ewise phase
// and writes a bf16 y only in an ewise or l2norm phase. Everything else
// f32, counters int; contiguous, on the current device. Launches on
// `stream` and returns the cudaError_t of the launch (0 on success).
int segment_run(const void* phases, int n_phases, const void* x, void* y,
                float* buf0, float* buf1, float* buf2, const void* cache_in,
                void* cache_out, const float* weights,
                const void* const* aux, int n_aux, float* ws, int* counters,
                int B, int blocks, int dtypes, void* stream) {
  if (n_phases <= 0 || B <= 0) return 0;
  if (n_aux < 0 || n_aux > kMaxAux || blocks <= 0)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = x;
  a.y = y;
  a.buf[0] = buf0;
  a.buf[1] = buf1;
  a.buf[2] = buf2;
  a.cache_in = cache_in;
  a.cache_out = cache_out;
  a.weights = weights;
  for (int i = 0; i < kMaxAux; ++i)
    a.aux[i] = i < n_aux ? aux[i] : nullptr;
  a.ws = ws;
  a.counters = counters;
  a.x_bf16 = dtypes & kXBf16;
  a.y_bf16 = dtypes & kYBf16;
  a.aux_bf16 = dtypes & kAuxBf16;
  a.cache_bf16 = dtypes & kCacheBf16;
  const Phase* table = static_cast<const Phase*>(phases);
  void* params[] = {(void*)&table, (void*)&n_phases, (void*)&a, (void*)&B};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)segment_kernel, dim3(blocks), dim3(kThreads), params,
      kSmemBytes, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
