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
 * built once per (model, batch), drives the kernel.
 *
 * Bound on an H100 SXM (67 TFLOP/s f32 on the CUDA cores, 3.35 TB/s HBM):
 * the 1x1 convs are ~98% of the operations, ~318 MFLOP per stream for the
 * flagship decoder, ~117 MFLOP for the encoder, against 26 MB and 12 MB of
 * folded weights read once per step and ~0.35 / 0.25 MB of caches per
 * stream. f32 arithmetic bounds both steps at 16 streams and more
 * (decoder: 0.076 ms of operations against 0.0095 ms of bytes at 16
 * streams).
 *
 * Design: one cooperative launch of a persistent grid (two 256-thread
 * blocks per SM) that walks the phase table and synchronizes the whole grid
 * (cooperative_groups grid.sync) between phases, so that every phase spreads
 * over all SMs whatever the number of streams. One block per stream would
 * need no grid barrier but would leave 116 of 132 SMs idle at 16 streams
 * and make every block read all 26 MB of weights; the ~60 grid barriers per
 * step cost less (on an H100 a phase with little work, its barrier
 * included, takes ~10 us: chip_smoke.py's [breakdown]). A 1x1 conv is a
 * shared-memory
 * tiled f32 GEMM (64x64 tiles, k-slabs of 16, a 4x4 register tile per
 * thread), with the pending transforms applied as the A tile is loaded and
 * bias and residual added in the epilogue; the tiles of one GEMM are spread
 * over the grid. Depthwise, transposed and strided convs are one thread per
 * output element; post and l2norm are one warp per time step.
 * Activations do not fit in shared memory (a flagship decoder stream holds
 * up to 61,440 floats, 240 KB, in its last stages), so they live in three
 * global scratch buffers the wrapper allocates (mostly L2-resident); the
 * Python side picks, for each phase, a buffer that is neither its input
 * nor a live residual. Caches are read from one buffer and written to
 * another, so no read of an old cache can see a new one.
 * What holds it back: the GEMM phases take two thirds to nine tenths of a
 * step (chip_smoke.py's [breakdown]); the GEMM is scalar f32 on the CUDA
 * cores (two FMAs per shared-memory load, no tensor cores, no cp.async
 * pipelining) and, at 16 streams, a GEMM of the first decoder stage has
 * only 24 tiles for 264 blocks. Loads of the scratch
 * buffers must stay coherent across grid barriers, so they use plain (not
 * read-only) loads.
 */
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 2;
constexpr int kMaxPre = 4;
constexpr int kMaxAux = 8;
constexpr int kBM = 64;   // GEMM tile rows
constexpr int kBN = 64;   // GEMM tile columns
constexpr int kBK = 16;   // GEMM k-slab
constexpr unsigned kFull = 0xffffffffu;

// phase kinds and transforms: the same numbers as ops/decoder_kernel.py
enum Kind {
  kEwise = 0, kPw = 1, kDw = 2, kConvT = 3, kPost = 4, kDense1ch = 5,
  kDws = 6, kMix = 7, kL2norm = 8
};
enum Unary { kElu = 1, kRelu = 2, kTanh = 3, kScale = 4 };

// One phase; the layout of PHASE_DTYPE in ops/decoder_kernel.py. Buffers:
// -1 is the step's input x (src) or output y (dst), 0..2 a scratch buffer.
// Offsets count floats: w, w2, bias into the packed weights (-1: none),
// cache into the packed cache buffers (-1: none).
struct Phase {
  int kind, src, dst, res, aux;
  int t_in, t_out, c_in, c_out, k, d;
  int w, w2, bias, cache, cache_len;
  int n_pre;
  int pre_kind[kMaxPre];
  float pre_scale[kMaxPre];
  float eps, gain;
};
static_assert(sizeof(Phase) == 108, "Phase must match PHASE_DTYPE");

struct Args {
  const float* x;
  float* y;
  float* buf[3];
  const float* cache_in;
  float* cache_out;
  const float* weights;
  const float* aux[kMaxAux];
};

__device__ __forceinline__ float apply_pre(const Phase& p, float v) {
  for (int i = 0; i < p.n_pre; ++i) {
    switch (p.pre_kind[i]) {
      case kElu: v = v > 0.f ? v : expm1f(v); break;
      case kRelu: v = fmaxf(v, 0.f); break;
      case kTanh: v = tanhf(v); break;
      default: v = v * p.pre_scale[i]; break;
    }
  }
  return v;
}

__device__ __forceinline__ const float* src_of(const Args& a, int s) {
  return s < 0 ? a.x : a.buf[s];
}

__device__ __forceinline__ float* dst_of(const Args& a, int s) {
  return s < 0 ? a.y : a.buf[s];
}

__device__ __forceinline__ int64_t gthread() {
  return (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ int64_t gstride() {
  return (int64_t)gridDim.x * blockDim.x;
}

// Row p of xc = [cache (clen rows); pre(x) (t rows)] for stream b, channel c.
__device__ __forceinline__ float xc_at(const Phase& p, const float* cache,
                                       const float* x, int b, int pos,
                                       int c) {
  const int clen = p.cache_len, C = p.c_in;
  if (pos < clen) return cache[((int64_t)b * clen + pos) * C + c];
  return apply_pre(p, x[((int64_t)b * p.t_in + pos - clen) * C + c]);
}

// New cache: the last cache_len rows of xc.
__device__ void write_cache(const Phase& p, const Args& a, int B) {
  const int clen = p.cache_len, C = p.c_in;
  const float* cin = a.cache_in + p.cache;
  float* cout = a.cache_out + p.cache;
  const float* x = src_of(a, p.src);
  const int64_t n = (int64_t)B * clen * C;
  for (int64_t i = gthread(); i < n; i += gstride()) {
    const int c = (int)(i % C);
    const int64_t bl = i / C;
    const int l = (int)(bl % clen), b = (int)(bl / clen);
    cout[i] = xc_at(p, cin, x, b, p.t_in + l, c);
  }
}

__device__ void ewise(const Phase& p, const Args& a, int B) {
  const float* x = src_of(a, p.src);
  const float* r = p.res >= 0 ? a.buf[p.res] : nullptr;
  float* y = dst_of(a, p.dst);
  const int64_t n = (int64_t)B * p.t_in * p.c_in;
  for (int64_t i = gthread(); i < n; i += gstride()) {
    float v = apply_pre(p, x[i]);
    if (r) v += r[i];
    y[i] = v;
  }
}

// y = pre(A) W (+ bias) (+ R), A [M, K], W [K, N] row-major.
__device__ void gemm(const Phase& p, const float* A, bool pre,
                     const float* W, const float* bias, const float* R,
                     float* out, int M, int N, int K,
                     float (*As)[kBM + 4], float (*Bs)[kBN]) {
  const int tiles_n = (N + kBN - 1) / kBN;
  const int tiles = ((M + kBM - 1) / kBM) * tiles_n;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = (tile / tiles_n) * kBM, n0 = (tile % tiles_n) * kBN;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    }
    for (int k0 = 0; k0 < K; k0 += kBK) {
      for (int i = threadIdx.x; i < kBM * kBK; i += kThreads) {
        const int r = i / kBK, kk = i % kBK;
        const int gm = m0 + r, gk = k0 + kk;
        float v = 0.f;
        if (gm < M && gk < K) {
          v = A[(int64_t)gm * K + gk];
          if (pre) v = apply_pre(p, v);
        }
        As[kk][r] = v;
      }
      for (int i = threadIdx.x; i < kBK * kBN; i += kThreads) {
        const int kk = i / kBN, c = i % kBN;
        const int gk = k0 + kk, gn = n0 + c;
        Bs[kk][c] = (gk < K && gn < N) ? W[(int64_t)gk * N + gn] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        float av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = As[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gm = m0 + ty + 16 * i;
      if (gm >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gn = n0 + tx + 16 * j;
        if (gn >= N) continue;
        float v = acc[i][j];
        if (bias) v += bias[gn];
        const int64_t o = (int64_t)gm * N + gn;
        if (R) v += R[o];  // R may alias out: same element, same thread
        out[o] = v;
      }
    }
  }
}

__device__ void depthwise(const Phase& p, const Args& a, int B) {
  const int T = p.t_out, C = p.c_in, k = p.k, d = p.d;
  const float* x = src_of(a, p.src);
  const float* cin = a.cache_in + p.cache;
  const float* w = a.weights + p.w;
  const float* bias = p.bias >= 0 ? a.weights + p.bias : nullptr;
  const float* r = p.res >= 0 ? a.buf[p.res] : nullptr;
  float* y = dst_of(a, p.dst);
  const int64_t n = (int64_t)B * T * C;
  for (int64_t i = gthread(); i < n; i += gstride()) {
    const int c = (int)(i % C);
    const int64_t bt = i / C;
    const int t = (int)(bt % T), b = (int)(bt / T);
    float acc = 0.f;
    for (int j = 0; j < k; ++j) {
      acc += xc_at(p, cin, x, b, t + j * d, c) * w[j * C + c];
    }
    if (bias) acc += bias[c];
    if (r) acc += r[i];  // r may alias y: same element, same thread
    y[i] = acc;
  }
}

__device__ void conv_transpose(const Phase& p, const Args& a, int B) {
  const int C = p.c_in, r = p.d, To = p.t_out;
  const float* x = src_of(a, p.src);
  const float* cin = a.cache_in + p.cache;
  const float* wa = a.weights + p.w;
  const float* wb = a.weights + p.w2;
  const float* bias = p.bias >= 0 ? a.weights + p.bias : nullptr;
  float* y = dst_of(a, p.dst);
  const int64_t n = (int64_t)B * To * C;
  for (int64_t i = gthread(); i < n; i += gstride()) {
    const int c = (int)(i % C);
    const int64_t bt = i / C;
    const int to = (int)(bt % To), b = (int)(bt / To);
    const int t = to / r, ph = to - t * r;
    float v = xc_at(p, cin, x, b, t, c) * wa[ph * C + c] +
              xc_at(p, cin, x, b, t + 1, c) * wb[ph * C + c];
    if (bias) v += bias[c];
    y[i] = v;
  }
}

__device__ void strided_depthwise(const Phase& p, const Args& a, int B) {
  const int To = p.t_out, C = p.c_in, s = p.d;
  const float* x = src_of(a, p.src);
  const float* cin = a.cache_in + p.cache;
  const float* w = a.weights + p.w;
  const float* bias = p.bias >= 0 ? a.weights + p.bias : nullptr;
  float* y = dst_of(a, p.dst);
  const int64_t n = (int64_t)B * To * C;
  for (int64_t i = gthread(); i < n; i += gstride()) {
    const int c = (int)(i % C);
    const int64_t bt = i / C;
    const int t = (int)(bt % To), b = (int)(bt / To);
    float acc = 0.f;
    for (int j = 0; j < s; ++j) {
      acc += xc_at(p, cin, x, b, t * s + j, c) * w[j * C + c] +
             xc_at(p, cin, x, b, (t + 1) * s + j, c) * w[(s + j) * C + c];
    }
    if (bias) acc += bias[c];
    y[i] = acc;
  }
}

__device__ void dense_one_channel(const Phase& p, const Args& a, int B) {
  const int T = p.t_out, Lw = p.t_in, C = p.c_out, k = p.k;
  const float* x = src_of(a, p.src);
  const float* w = a.weights + p.w;
  const float* bias = p.bias >= 0 ? a.weights + p.bias : nullptr;
  float* y = dst_of(a, p.dst);
  const int64_t n = (int64_t)B * T * C;
  for (int64_t i = gthread(); i < n; i += gstride()) {
    const int c = (int)(i % C);
    const int64_t bt = i / C;
    const int t = (int)(bt % T), b = (int)(bt / T);
    const float* row = x + (int64_t)b * Lw + t;
    float acc = 0.f;
    for (int j = 0; j < k; ++j) acc += row[j] * w[j * C + c];
    if (bias) acc += bias[c];
    y[i] = acc;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// One output channel: y[b, t] = sum_j sum_c xc[t + j, c] w[j, c] (+ bias).
__device__ void post_conv(const Phase& p, const Args& a, int B) {
  const int T = p.t_out, C = p.c_in, k = p.k;
  const float* x = src_of(a, p.src);
  const float* cin = a.cache_in + p.cache;
  const float* w = a.weights + p.w;
  float* y = dst_of(a, p.dst);
  const int lane = threadIdx.x & 31;
  const int64_t rows = (int64_t)B * T;
  for (int64_t row = gthread() >> 5; row < rows; row += gstride() >> 5) {
    const int t = (int)(row % T), b = (int)(row / T);
    float acc = 0.f;
    for (int j = 0; j < k; ++j) {
      for (int c = lane; c < C; c += 32) {
        acc += xc_at(p, cin, x, b, t + j, c) * w[j * C + c];
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) y[row] = p.bias >= 0 ? acc + a.weights[p.bias] : acc;
  }
}

__device__ void l2norm(const Phase& p, const Args& a, int B) {
  const int C = p.c_in;
  const float* x = src_of(a, p.src);
  float* y = dst_of(a, p.dst);
  const int lane = threadIdx.x & 31;
  const int64_t rows = (int64_t)B * p.t_in;
  for (int64_t row = gthread() >> 5; row < rows; row += gstride() >> 5) {
    const float* xr = x + row * C;
    float ss = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float v = apply_pre(p, xr[c]);
      ss += v * v;
    }
    const float den = fmaxf(sqrtf(warp_sum(ss)), p.eps);
    for (int c = lane; c < C; c += 32) {
      y[row * C + c] = apply_pre(p, xr[c]) / den * p.gain;
    }
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
segment_kernel(const Phase* __restrict__ phases, int n_phases, Args a,
               int B) {
  __shared__ Phase ph;
  __shared__ float As[kBK][kBM + 4];
  __shared__ float Bs[kBK][kBN];
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < n_phases; ++i) {
    if (threadIdx.x == 0) ph = phases[i];
    __syncthreads();
    const Phase& p = ph;
    switch (p.kind) {
      case kEwise: ewise(p, a, B); break;
      case kPw:
        gemm(p, src_of(a, p.src), p.n_pre > 0, a.weights + p.w,
             p.bias >= 0 ? a.weights + p.bias : nullptr,
             p.res >= 0 ? a.buf[p.res] : nullptr, dst_of(a, p.dst),
             B * p.t_in, p.c_out, p.c_in, As, Bs);
        break;
      case kMix:
        gemm(p, a.aux[p.aux], false, a.weights + p.w,
             p.bias >= 0 ? a.weights + p.bias : nullptr, a.buf[p.res],
             dst_of(a, p.dst), B * p.t_in, p.c_out, p.c_in, As, Bs);
        break;
      case kDw: depthwise(p, a, B); write_cache(p, a, B); break;
      case kConvT: conv_transpose(p, a, B); write_cache(p, a, B); break;
      case kPost: post_conv(p, a, B); write_cache(p, a, B); break;
      case kDense1ch: dense_one_channel(p, a, B); break;
      case kDws: strided_depthwise(p, a, B); write_cache(p, a, B); break;
      case kL2norm: l2norm(p, a, B); break;
      default: break;
    }
    if (i + 1 < n_phases) grid.sync();  // also a block barrier
  }
}

}  // namespace

extern "C" {

// Blocks of the persistent grid on the current device: kBlocksPerSm per SM,
// or fewer if the occupancy calculator allows fewer. Writes them to
// *blocks and returns the cudaError_t (0 on success).
int segment_grid(int* blocks) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess && !coop) e = cudaErrorNotSupported;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, segment_kernel,
                                                      kThreads, 0);
  if (e == cudaSuccess && per_sm < 1) e = cudaErrorInvalidConfiguration;
  if (e == cudaSuccess) *blocks = sms * (per_sm < kBlocksPerSm ? per_sm
                                                               : kBlocksPerSm);
  return (int)e;
}

// Run a frame step: the n_phases phases at `phases` (device memory) over B
// streams on a cooperative grid of `blocks` blocks (from segment_grid).
// x: the step's input, y: its output; bufs: three scratch buffers, each of
// B times the largest activation of a stream; cache_in / cache_out: the
// packed caches before and after (distinct buffers); weights: the packed
// weights; aux: up to 8 aux inputs (the encoder's log-magnitudes). All f32,
// contiguous, on the current device. Launches on `stream` and returns the
// cudaError_t of the launch (0 on success).
int segment_run(const void* phases, int n_phases, const float* x, float* y,
                float* buf0, float* buf1, float* buf2, const float* cache_in,
                float* cache_out, const float* weights,
                const void* const* aux, int n_aux, int B, int blocks,
                void* stream) {
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
    a.aux[i] = i < n_aux ? static_cast<const float*>(aux[i]) : nullptr;
  const Phase* table = static_cast<const Phase*>(phases);
  void* params[] = {(void*)&table, (void*)&n_phases, (void*)&a, (void*)&B};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)segment_kernel, dim3(blocks), dim3(kThreads), params, 0,
      static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
