/*
 * Multi-leaf AdamP step for Hopper (sm_90a), with a plain C interface.
 *
 * Replaces no TPU kernel: the JAX package leaves AdamP to XLA, which fuses
 * the per-leaf chain of `hilcodec_tpu/train/optim.py` into a few loops.
 * The port's plain version (`train/optim.py`, `AdamP.update` followed by
 * the masked commit of `Trainer.apply_grads`) is a Python loop over the
 * leaves that launches about 53 small kernels a leaf; over the flagship's
 * 471 leaves the host spends a third of the train step launching them.
 * This file updates every leaf of one parameter tree in at most three
 * launches, whose tables are built once per tree structure.
 *
 * What it computes, per leaf (p, g, m, v f32; the step t = step + 1, the
 * rate lr and the commit flag read from device scalars):
 *   m' = b1 m + (1 - b1) g          v' = b2 v + (1 - b2) g g
 *   q  = (nesterov ? b1 m' + (1 - b1) g : m') / (sqrt(v') / sqrt(bc2) + eps)
 *   q  = the projection of q by the leaf's mode (below), wd its factor
 *   u  = -(lr lr_scale) / bc1 q - (lr lr_scale) weight_decay wd p
 *   (p, m, v) <- commit ? (p + u, m', v') : (p, m, v)
 * Modes (the wrapper's table): 0 no projection (ndim <= 1, or AdamP with
 * delta <= 0, whose gate never opens), wd = 1; 1 `project_channel`: q
 * minus its component along each dim-0 row of p, wd = wd_ratio; 2 the
 * gate: the channel projection when the largest row |cos(g, p)| is under
 * delta / sqrt(row length), else the layer projection (q minus its
 * component along the whole of p) when the layer |cos(g, p)| is under
 * delta / sqrt(numel), else none; wd = wd_ratio when a projection is taken.
 *
 * Bound on an H100 SXM (3.35 TB/s): the bytes. Pass A reads p, g, m, v and
 * writes m', v' and, for modes 1-2, q; pass B reads p and q and writes p'.
 * 28 bytes an element in mode 0, 40 in modes 1-2: the flagship's 9.6 M
 * generator and 49.9 M discriminator elements (almost all in mode 2) take
 * 0.11 ms and 0.60 ms.
 *
 * Design. Pass A walks (leaf, chunk) work items, one block each: a range of
 * up to 4096 elements inside one row (rows of 1024 elements and longer are
 * cut into such slices; mode-0 leaves are cut flat), or a run of whole
 * short rows, each row taken by a group of G lanes (G a power of two up
 * to 32, from the row length). It computes m', v' and q in registers and,
 * for modes 1-2, the row's (or the slice's) sums of g g, g p, p p and p q,
 * reduced in a fixed order (warp shuffles, then the warps in turn) into
 * one partial per (row, slice): no atomics, so a run repeats bit for bit.
 * A mode-0 leaf is finished in pass A. Pass R, one block per leaf of mode
 * 1-2, adds each row's partials in slice order, takes the channel gate
 * (the largest row cosine, NaN kept as torch.max keeps it) and the layer
 * gate, and writes the leaf's projection and each row's coefficients
 * (||p_r|| + eps, (p_r . q_r) / (||p_r|| + eps)). Pass B walks flat chunks
 * of those leaves and writes p'. Loads and stores are 16 bytes wide where
 * a range and every pointer are 16-byte aligned, else one float each. A
 * leaf given in another layout (cuDNN returns some convolutions' weight
 * gradients channels-last) is read through its strides, element by
 * element in row-major order, so that no copy is launched for it.
 * Nothing is read back to the host, and no launch depends on the data.
 */

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// int64 fields of a leaf's row of the static table (kLeafI per leaf)
enum { kNumel, kOff, kRows, kLen, kPBase, kNsl, kRBase, kMode, kLeafI };
// f32 fields (kLeafF per leaf)
enum { kLrScale, kWeightDecay, kThrCh, kThrLy, kLeafF };

struct Hyper {
  float b1, c1, b2, c2, eps, wd_ratio;
  int nesterov;
};

// The step's scalars, read from the device by every block.
struct Step {
  float sbc2;      // sqrt(1 - b2^t)
  float a;         // -(lr lr_scale) / (1 - b1^t)
  float lr_leaf;   // lr lr_scale
  bool commit;
};

__device__ __forceinline__ Step read_step(const int* step_in,
                                          const float* lr_in,
                                          const unsigned char* commit_in,
                                          const Hyper& h, float lr_scale) {
  Step s;
  const float t = static_cast<float>(*step_in + 1);
  const float bc1 = 1.0f - powf(h.b1, t);
  s.sbc2 = sqrtf(1.0f - powf(h.b2, t));
  s.lr_leaf = *lr_in * lr_scale;
  s.a = -s.lr_leaf / bc1;
  s.commit = commit_in == nullptr || *commit_in != 0;
  return s;
}

struct Moments {
  float m, v, q;
};

__device__ __forceinline__ Moments adam(float g, float m, float v,
                                        const Hyper& h, const Step& s) {
  Moments r;
  r.m = h.b1 * m + h.c1 * g;
  r.v = h.b2 * v + h.c2 * g * g;
  const float den = sqrtf(r.v) / s.sbc2 + h.eps;
  r.q = (h.nesterov ? h.b1 * r.m + h.c1 * g : r.m) / den;
  return r;
}

__device__ __forceinline__ float finish(float p, float q, float wd_coef,
                                        bool decay, const Step& s) {
  float u = s.a * q;
  if (decay) u = u - wd_coef * p;
  return s.commit ? p + u : p;
}

// Sums of one row or slice: g g, g p, p p, p q.
struct Sums {
  float gg, gp, pp, pq;
  __device__ __forceinline__ void add(float g, float p, float q) {
    gg += g * g;
    gp += g * p;
    pp += p * p;
    pq += p * q;
  }
};

__device__ __forceinline__ float shfl_sum(float x, int width) {
  for (int o = width / 2; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ Sums shfl_sums(Sums a, int width) {
  a.gg = shfl_sum(a.gg, width);
  a.gp = shfl_sum(a.gp, width);
  a.pp = shfl_sum(a.pp, width);
  a.pq = shfl_sum(a.pq, width);
  return a;
}

// The block's total, in a fixed order; valid in thread 0.
__device__ Sums block_sums(Sums a, float4* sh) {
  a = shfl_sums(a, 32);
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) sh[warp] = make_float4(a.gg, a.gp, a.pp, a.pq);
  __syncthreads();
  Sums t = {0.f, 0.f, 0.f, 0.f};
  if (threadIdx.x == 0) {
    for (int w = 0; w < kWarps; ++w) {
      t.gg += sh[w].x;
      t.gp += sh[w].y;
      t.pp += sh[w].z;
      t.pq += sh[w].w;
    }
  }
  return t;
}

// The largest of a and b, NaN if either is (as torch.max).
__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fffffff) : fmaxf(a, b);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// A leaf's p, g, m, v (t[0..3]) and, when any of them is not contiguous,
// its layout: the shape padded to 4 dims, then each tensor's 4 strides.
struct LeafPtrs {
  const float* t[4];
  const long long* lay;
};

// dyn: the per-call table, [4 n] pointers (p, g, m, v a leaf), [n] layout
// indices (-1: all four contiguous), then 20 int64 a layout.
__device__ __forceinline__ LeafPtrs leaf_ptrs(const long long* dyn,
                                              int n_leaves, int leaf) {
  const long long* q = dyn + 4 * leaf;
  const long long k = dyn[4 * n_leaves + leaf];
  return {{reinterpret_cast<const float*>(q[0]),
           reinterpret_cast<const float*>(q[1]),
           reinterpret_cast<const float*>(q[2]),
           reinterpret_cast<const float*>(q[3])},
          k < 0 ? nullptr : dyn + 5 * n_leaves + 20 * k};
}

// Element e (row-major over the leaf's shape) of tensor k of the leaf.
__device__ __forceinline__ float ld(const LeafPtrs& lp, int k, long long e) {
  if (lp.lay == nullptr) return lp.t[k][e];
  long long off = 0, r = e;
#pragma unroll
  for (int d = 3; d >= 0; --d) {
    const long long n = lp.lay[d];
    off += (r % n) * lp.lay[4 + 4 * k + d];
    r /= n;
  }
  return lp.t[k][off];
}

// One element of pass A: the moments, committed or not; q kept for pass B
// (mode 1-2) or p' written (mode 0); the sums for mode 1-2.
__device__ __forceinline__ void elem_a(float p, float g, float m, float v,
                                       long long o, int mode, float wd_coef,
                                       bool decay, const Hyper& h,
                                       const Step& s, float* p_out,
                                       float* m_out, float* v_out,
                                       float* perturb, Sums& acc) {
  const Moments r = adam(g, m, v, h, s);
  m_out[o] = s.commit ? r.m : m;
  v_out[o] = s.commit ? r.v : v;
  if (mode == 0) {
    p_out[o] = finish(p, r.q, wd_coef, decay, s);
  } else {
    perturb[o] = r.q;
    acc.add(g, p, r.q);
  }
}

// Pass A. items: [n, 5] int64 (leaf, kind, x, y, part): kind 0 the range
// [x, x + y) of the leaf's elements, inside one row unless the leaf is
// mode 0, whose sums go to partials[part]; kind G >= 1 the rows
// [x, x + y), G lanes a row, row r's sums to partials[part + r - x].
__global__ void __launch_bounds__(kThreads)
adamp_pass_a(const long long* __restrict__ leaves_i,
             const float* __restrict__ leaves_f,
             const long long* __restrict__ items,
             const long long* __restrict__ dyn, int n_leaves,
             float* __restrict__ p_out, float* __restrict__ m_out,
             float* __restrict__ v_out,
             float* __restrict__ perturb, float4* __restrict__ partials,
             const int* __restrict__ step_in, int* __restrict__ step_out,
             const float* __restrict__ lr_in,
             const unsigned char* __restrict__ commit_in, Hyper h) {
  __shared__ float4 sh[kWarps];
  const long long* it = items + 5 * static_cast<long long>(blockIdx.x);
  const int leaf = static_cast<int>(it[0]);
  const long long kind = it[1], x = it[2], y = it[3], part = it[4];
  const long long* L = leaves_i + kLeafI * leaf;
  const float* F = leaves_f + kLeafF * leaf;
  const Step s = read_step(step_in, lr_in, commit_in, h, F[kLrScale]);
  if (blockIdx.x == 0 && threadIdx.x == 0)
    *step_out = s.commit ? *step_in + 1 : *step_in;
  const int mode = static_cast<int>(L[kMode]);
  const bool decay = F[kWeightDecay] > 0.f;
  // mode 0 finishes here with wd = 1
  const float wd_coef = s.lr_leaf * F[kWeightDecay] * 1.0f;
  const LeafPtrs lp = leaf_ptrs(dyn, n_leaves, leaf);
  const long long off = L[kOff];
  Sums acc = {0.f, 0.f, 0.f, 0.f};

  if (kind == 0) {
    const float *P = lp.t[0] + x, *G = lp.t[1] + x, *M = lp.t[2] + x,
                *V = lp.t[3] + x;
    float *Po = p_out + off + x, *Mo = m_out + off + x, *Vo = v_out + off + x,
          *Q = perturb + off + x;
    const bool vec = lp.lay == nullptr && aligned16(P) && aligned16(G) &&
                     aligned16(M) && aligned16(V) && aligned16(Po) &&
                     aligned16(Mo) && aligned16(Vo) && aligned16(Q);
    const long long n4 = vec ? y / 4 : 0;
    for (long long i = threadIdx.x; i < n4; i += kThreads) {
      const float4 p4 = reinterpret_cast<const float4*>(P)[i];
      const float4 g4 = reinterpret_cast<const float4*>(G)[i];
      const float4 m4 = reinterpret_cast<const float4*>(M)[i];
      const float4 v4 = reinterpret_cast<const float4*>(V)[i];
      const float pa[4] = {p4.x, p4.y, p4.z, p4.w};
      const float ga[4] = {g4.x, g4.y, g4.z, g4.w};
      const float ma[4] = {m4.x, m4.y, m4.z, m4.w};
      const float va[4] = {v4.x, v4.y, v4.z, v4.w};
      float mo[4], vo[4], po[4], qo[4];
      for (int k = 0; k < 4; ++k) {
        const Moments r = adam(ga[k], ma[k], va[k], h, s);
        mo[k] = s.commit ? r.m : ma[k];
        vo[k] = s.commit ? r.v : va[k];
        qo[k] = r.q;
        if (mode == 0)
          po[k] = finish(pa[k], r.q, wd_coef, decay, s);
        else
          acc.add(ga[k], pa[k], r.q);
      }
      reinterpret_cast<float4*>(Mo)[i] = make_float4(mo[0], mo[1], mo[2],
                                                     mo[3]);
      reinterpret_cast<float4*>(Vo)[i] = make_float4(vo[0], vo[1], vo[2],
                                                     vo[3]);
      if (mode == 0)
        reinterpret_cast<float4*>(Po)[i] = make_float4(po[0], po[1], po[2],
                                                       po[3]);
      else
        reinterpret_cast<float4*>(Q)[i] = make_float4(qo[0], qo[1], qo[2],
                                                      qo[3]);
    }
    for (long long i = 4 * n4 + threadIdx.x; i < y; i += kThreads)
      elem_a(ld(lp, 0, x + i), ld(lp, 1, x + i), ld(lp, 2, x + i),
             ld(lp, 3, x + i), i, mode, wd_coef, decay, h, s, Po, Mo, Vo, Q,
             acc);
    if (mode != 0) {
      const Sums t = block_sums(acc, sh);
      if (threadIdx.x == 0)
        partials[part] = make_float4(t.gg, t.gp, t.pp, t.pq);
    }
    return;
  }

  // whole rows, G lanes a row; every lane of a warp takes each turn, so
  // the shuffles see the whole warp
  const int lanes = static_cast<int>(kind);
  const int lane = threadIdx.x % lanes, grp = threadIdx.x / lanes;
  const int groups = kThreads / lanes;
  const long long len = L[kLen];
  for (long long r0 = x; r0 < x + y; r0 += groups) {
    const long long r = r0 + grp;
    Sums a = {0.f, 0.f, 0.f, 0.f};
    if (r < x + y) {
      const long long base = r * len;
      for (long long j = lane; j < len; j += lanes) {
        const long long e = base + j;
        elem_a(ld(lp, 0, e), ld(lp, 1, e), ld(lp, 2, e), ld(lp, 3, e),
               off + e, mode, wd_coef, decay, h, s, p_out, m_out, v_out,
               perturb, a);
      }
    }
    a = shfl_sums(a, lanes);
    if (lane == 0 && r < x + y)
      partials[part + r - x] = make_float4(a.gg, a.gp, a.pp, a.pq);
  }
}

// A row's sums: its partials added in slice order.
__device__ __forceinline__ float4 row_sums(const float4* partials,
                                           long long base, long long nsl) {
  float4 t = partials[base];
  for (long long k = 1; k < nsl; ++k) {
    const float4 u = partials[base + k];
    t.x += u.x;
    t.y += u.y;
    t.z += u.z;
    t.w += u.w;
  }
  return t;
}

// Pass R: one block per leaf of mode 1-2 (rlist). leafcoef[leaf]: (the
// projection taken: 0 none, 1 channel, 2 layer; wd; ||p|| + eps;
// (p . q) / (||p|| + eps)); rowcoef[rbase + r]: (||p_r|| + eps,
// (p_r . q_r) / (||p_r|| + eps)) when the channel projection is taken.
__global__ void __launch_bounds__(kThreads)
adamp_pass_r(const long long* __restrict__ leaves_i,
             const float* __restrict__ leaves_f,
             const int* __restrict__ rlist,
             const float4* __restrict__ partials,
             float2* __restrict__ rowcoef, float4* __restrict__ leafcoef,
             Hyper h) {
  __shared__ float4 sh[kWarps];
  __shared__ float shmax[kWarps];
  __shared__ int decision;
  const int leaf = rlist[blockIdx.x];
  const long long* L = leaves_i + kLeafI * leaf;
  const float* F = leaves_f + kLeafF * leaf;
  const long long rows = L[kRows], nsl = L[kNsl], pbase = L[kPBase];
  const int mode = static_cast<int>(L[kMode]);

  Sums acc = {0.f, 0.f, 0.f, 0.f};
  float cmax = 0.f;
  for (long long r = threadIdx.x; r < rows; r += kThreads) {
    const float4 t = row_sums(partials, pbase + r * nsl, nsl);
    acc.gg += t.x;
    acc.gp += t.y;
    acc.pp += t.z;
    acc.pq += t.w;
    const float c = fabsf(t.y) / fmaxf(sqrtf(t.x) * sqrtf(t.z), h.eps);
    cmax = nan_max(cmax, c);
  }
  // the largest row cosine, in a fixed order
  for (int o = 16; o > 0; o >>= 1)
    cmax = nan_max(cmax, __shfl_xor_sync(0xffffffffu, cmax, o));
  if (threadIdx.x % 32 == 0) shmax[threadIdx.x / 32] = cmax;
  const Sums tot = block_sums(acc, sh);   // syncs, so shmax is complete
  if (threadIdx.x == 0) {
    int kind = 1;
    if (mode == 2) {
      float ch = shmax[0];
      for (int w = 1; w < kWarps; ++w) ch = nan_max(ch, shmax[w]);
      const float ly = fabsf(tot.gp) /
                       fmaxf(sqrtf(tot.gg) * sqrtf(tot.pp), h.eps);
      kind = ch < F[kThrCh] ? 1 : (ly < F[kThrLy] ? 2 : 0);
    }
    const float n = sqrtf(tot.pp) + h.eps;
    leafcoef[leaf] = make_float4(static_cast<float>(kind),
                                 kind ? h.wd_ratio : 1.0f, n, tot.pq / n);
    decision = kind;
  }
  __syncthreads();
  if (decision != 1) return;
  const long long rbase = L[kRBase];
  for (long long r = threadIdx.x; r < rows; r += kThreads) {
    const float4 t = row_sums(partials, pbase + r * nsl, nsl);
    const float n = sqrtf(t.z) + h.eps;
    rowcoef[rbase + r] = make_float2(n, t.w / n);
  }
}

__device__ __forceinline__ float project(float p, float q, int kind,
                                         float2 c) {
  return kind == 0 ? q : q - (p / c.x) * c.y;
}

// Pass B: items [n, 3] int64 (leaf, x, y), the range [x, x + y) of a leaf
// of mode 1-2: p' from p, q and the leaf's projection.
__global__ void __launch_bounds__(kThreads)
adamp_pass_b(const long long* __restrict__ leaves_i,
             const float* __restrict__ leaves_f,
             const long long* __restrict__ items,
             const long long* __restrict__ dyn, int n_leaves,
             const float* __restrict__ perturb,
             const float2* __restrict__ rowcoef,
             const float4* __restrict__ leafcoef, float* __restrict__ p_out,
             const int* __restrict__ step_in, const float* __restrict__ lr_in,
             const unsigned char* __restrict__ commit_in, Hyper h) {
  const long long* it = items + 3 * static_cast<long long>(blockIdx.x);
  const int leaf = static_cast<int>(it[0]);
  const long long x = it[1], y = it[2];
  const long long* L = leaves_i + kLeafI * leaf;
  const float* F = leaves_f + kLeafF * leaf;
  const Step s = read_step(step_in, lr_in, commit_in, h, F[kLrScale]);
  const float4 lc = leafcoef[leaf];
  const int kind = static_cast<int>(lc.x);
  const bool decay = F[kWeightDecay] > 0.f;
  const float wd_coef = s.lr_leaf * F[kWeightDecay] * lc.y;
  const float2 layer = make_float2(lc.z, lc.w);
  const unsigned len = static_cast<unsigned>(L[kLen]);
  const float2* rc = rowcoef + L[kRBase];
  const long long off = L[kOff];
  const LeafPtrs lp = leaf_ptrs(dyn, n_leaves, leaf);
  const float* P = lp.t[0] + x;
  const float* Q = perturb + off + x;
  float* Po = p_out + off + x;
  // element i of the range lies in row (x + i) / len
  auto coef = [&](long long i) {
    return kind == 1 ? rc[static_cast<unsigned>(x + i) / len] : layer;
  };
  const bool vec =
      lp.lay == nullptr && aligned16(P) && aligned16(Q) && aligned16(Po);
  const long long n4 = vec ? y / 4 : 0;
  for (long long i = threadIdx.x; i < n4; i += kThreads) {
    const float4 p4 = reinterpret_cast<const float4*>(P)[i];
    const float4 q4 = reinterpret_cast<const float4*>(Q)[i];
    const float pa[4] = {p4.x, p4.y, p4.z, p4.w};
    const float qa[4] = {q4.x, q4.y, q4.z, q4.w};
    float po[4];
    for (int k = 0; k < 4; ++k)
      po[k] = finish(pa[k], project(pa[k], qa[k], kind, coef(4 * i + k)),
                     wd_coef, decay, s);
    reinterpret_cast<float4*>(Po)[i] = make_float4(po[0], po[1], po[2],
                                                   po[3]);
  }
  for (long long i = 4 * n4 + threadIdx.x; i < y; i += kThreads) {
    const float p = ld(lp, 0, x + i);
    Po[i] = finish(p, project(p, Q[i], kind, coef(i)), wd_coef, decay, s);
  }
}

}  // namespace

extern "C" {

// One step over every leaf of a tree, on `stream`: pass A over n_a items,
// then, when n_r > 0, pass R over n_r leaves and pass B over n_b items.
// Every pointer is device memory laid out as the wrapper's tables say
// (`ops/adamp_kernel.py`; dyn the per-call table of n_leaves leaves);
// commit may be null (always commit). Returns the cudaError_t of the
// launches (0 on success).
int adamp_step(const long long* leaves_i, const float* leaves_f,
               const long long* items_a, int n_a, const int* rlist, int n_r,
               const long long* items_b, int n_b, const long long* dyn,
               int n_leaves,
               float* p_out, float* m_out, float* v_out, float* perturb,
               float* partials, float* rowcoef, float* leafcoef,
               const int* step_in, int* step_out, const float* lr,
               const unsigned char* commit, float b1, float c1, float b2,
               float c2, float eps, float wd_ratio, int nesterov,
               void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Hyper h = {b1, c1, b2, c2, eps, wd_ratio, nesterov};
  if (n_a > 0)
    adamp_pass_a<<<n_a, kThreads, 0, st>>>(
        leaves_i, leaves_f, items_a, dyn, n_leaves, p_out, m_out, v_out,
        perturb,
        reinterpret_cast<float4*>(partials), step_in, step_out, lr, commit,
        h);
  if (n_r > 0) {
    adamp_pass_r<<<n_r, kThreads, 0, st>>>(
        leaves_i, leaves_f, rlist, reinterpret_cast<const float4*>(partials),
        reinterpret_cast<float2*>(rowcoef),
        reinterpret_cast<float4*>(leafcoef), h);
    adamp_pass_b<<<n_b, kThreads, 0, st>>>(
        leaves_i, leaves_f, items_b, dyn, n_leaves, perturb,
        reinterpret_cast<const float2*>(rowcoef),
        reinterpret_cast<const float4*>(leafcoef), p_out, step_in, lr,
        commit, h);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
