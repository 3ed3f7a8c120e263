// Paged single-token decode attention with GQA, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ray_tpu/ops/paged_attention.py
// (_paged_kernel, reached through paged_attention).  It computes, for each
// lane b and query head, softmax(q . K[ctx]^T / sqrt(D)) . V[ctx] over the
// lane's first context_lens[b] positions, whose K/V rows live in flat
// per-layer slot pools [T, Hkv, D] at the physical pages block_tables[b, :].
//
// Bound.  Decode reads every used K/V byte once and does ~4 FLOPs per
// byte, so it is bound by device-memory bytes (3.35 TB/s on an H100 SXM).
// Reaching that needs many blocks in flight and little waiting per byte.
//
// Design: split-K over the page loop, then a merge.
//  * paged_decode_split_kernel, grid (B, Hkv, n_splits), 128 threads.
//    Block (b, kvh, s) walks positions [s * split_rows, (s + 1) *
//    split_rows) of lane b and writes, for each of the G query heads of
//    kv head kvh, an fp32 partial: the unnormalised accumulator [D], the
//    running max m (natural-log units) and the denominator l.  n_splits
//    is ceil(width * page_size / split_rows), from the table width alone,
//    so the host never reads context lengths back; a block whose span
//    starts at or past the lane's context writes an empty partial (m =
//    -inf, l = 0) and returns.  split_rows is 128 (the wrapper's
//    SPLIT_ROWS), two 64-row tiles a block: the 8B decode shape (B 8,
//    Hkv 8, contexts ~1000) then keeps ~220 blocks busy, close to two
//    waves over 132 SMs, instead of one block per (lane, kv head) with
//    the longest lane setting the time.  Spans of 256 rows (four tiles a
//    block) were slower at that shape: with one block an SM, four warps
//    cannot hide the latency of each tile's chain.
//  * Tiles span pages: a step takes 64 positions, 16 per warp, whatever
//    the page size; each row's two 16-byte-chunked copies (K and V) are
//    addressed through the table with cp.async (rows past the context are
//    zero-filled, never read).  Each warp runs its own online softmax over
//    its 16 rows and owns its slice of a 2-deep shared-memory ring, so a
//    step needs no block barrier at all, only __syncwarp.  Scores: a lane
//    takes one row and half of D for every query head of the group (the
//    heads are independent chains), one shuffle joins the halves, and the
//    max and the sum over the warp's 16 rows are four shuffles per head,
//    all heads reduced side by side.  P V: a lane owns D / 32 output
//    columns of every head and reads p from a per-warp scratch.  The four
//    warps' states merge once, at the end of the span.  (mma.sync with the
//    G heads padded to 16 rows would waste 3/4 of each product at G = 4
//    and cannot serve fp32 at full precision; the SIMT form serves both.)
//  * paged_decode_merge_kernel, grid (H, B), D threads: the log-sum-exp
//    rule over the lane's used spans, m = max m_i, l = sum l_i e^(m_i - m),
//    out = sum acc_i e^(m_i - m) / max(l, 1e-20); a lane with context 0
//    has no used span and gets exact zeros.  The spans' (m, l) and
//    weights are staged in shared memory once, so each thread's loop
//    over spans is a chain of independent loads of its column.
// Shared and copy-on-write pages need nothing special: pages are only
// addressed through the table.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpRows = 16;                    // positions a warp takes
constexpr int kTileRows = kWarps * kWarpRows;    // ... and the block
constexpr int kStages = 2;                       // ring depth per warp
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  // src-size 0 fills the 16 bytes with zeros and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// N consecutive elements (4, 8 or 16 bytes, aligned) as floats.
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  constexpr int kBytes = N * sizeof(T);
  using V = typename std::conditional<
      kBytes == 16, uint4,
      typename std::conditional<kBytes == 8, uint2, unsigned>::type>::type;
  const V raw = *reinterpret_cast<const V*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = rt::to_float(e[i]);
}

template <typename T, int D>
struct Layout {
  static constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte copy
  static constexpr int kRowVecs = D / kVec;
  static constexpr int kPad = D + kVec;        // row stride: rows 16 B apart
  static constexpr int kHalf = D / 2;          // score columns per lane
  static constexpr int kCols = D / 32;         // output columns per lane
  static constexpr int kQStride = kHalf + 4;   // padded half row of q
  static constexpr size_t kRing =
      sizeof(T) * kWarps * kStages * 2 * kWarpRows * kPad;
};

// The ring, reused at the end as the warps' merge scratch.
template <typename T, int D, int MaxG>
__host__ __device__ constexpr size_t ring_bytes() {
  return Layout<T, D>::kRing > sizeof(float) * kWarps * MaxG * (2 + D)
             ? Layout<T, D>::kRing
             : sizeof(float) * kWarps * MaxG * (2 + D);
}

template <typename T, int D, int MaxG>
size_t smem_bytes(int group) {
  return ring_bytes<T, D, MaxG>() +
         sizeof(float) *
             (group * 2 * Layout<T, D>::kQStride + kWarps * MaxG * 16);
}

template <typename T, int D, int MaxG>
__global__ void __launch_bounds__(kThreads)
paged_decode_split_kernel(const T* __restrict__ q,       // [B, H, D]
                          const T* __restrict__ pool_k,  // [slots, Hkv, D]
                          const T* __restrict__ pool_v,  // [slots, Hkv, D]
                          const int* __restrict__ block_tables,  // [B, W]
                          const int* __restrict__ context_lens,  // [B]
                          float* __restrict__ part_acc,  // [B, H, n, D]
                          float* __restrict__ part_ml,   // [B, H, n, 2]
                          int hkv, int group, int width, int page_size,
                          int split_rows, float scale_log2) {
  using L = Layout<T, D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);  // [warp][stage][K|V][16][kPad]
  float* qs = reinterpret_cast<float*>(  // [G][2][kQStride]
      smem_raw + ring_bytes<T, D, MaxG>());
  float* ps = qs + group * 2 * L::kQStride;  // [kWarps][MaxG][16]

  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int split = blockIdx.z;
  const int n_splits = gridDim.z;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int ctx = max(0, min(context_lens[b], width * page_size));
  const int start = split * split_rows;
  const int stop = min(ctx, start + split_rows);
  const size_t head0 = (static_cast<size_t>(b) * hkv + kvh) * group;
  auto part = [&](int g) {
    return (head0 + g) * n_splits + split;  // partial index of head g
  };

  if (start >= stop) {  // the span is empty: an empty partial
    for (int g = tid; g < group; g += kThreads) {
      part_ml[2 * part(g)] = -INFINITY;
      part_ml[2 * part(g) + 1] = 0.f;
    }
    return;
  }

  for (int i = tid; i < group * D; i += kThreads) {
    const int g = i / D;
    const int c = i - g * D;
    qs[(2 * g + c / L::kHalf) * L::kQStride + c % L::kHalf] =
        rt::to_float(q[head0 * D + i]);
  }
  __syncthreads();

  const int n_tiles = (stop - start + kTileRows - 1) / kTileRows;
  T* wring = ring + warp * kStages * 2 * kWarpRows * L::kPad;
  const int* table = block_tables + static_cast<size_t>(b) * width;
  const size_t row_stride = static_cast<size_t>(hkv) * D;  // per slot

  // copy this warp's 16 rows of tile t (K and V) into ring slot t % kStages
  auto issue = [&](int t) {
    T* dst = wring + (t % kStages) * 2 * kWarpRows * L::kPad;
    const int row0 = start + t * kTileRows + warp * kWarpRows;
    int slot = 0;  // lanes 0..15 look up one row each
    if (lane < kWarpRows && row0 + lane < stop) {
      const int pos = row0 + lane;
      slot = table[pos / page_size] * page_size + pos % page_size;
    }
#pragma unroll
    for (int i = lane; i < 2 * kWarpRows * L::kRowVecs; i += 32) {
      const int side = i / (kWarpRows * L::kRowVecs);  // 0 = K, 1 = V
      const int rem = i - side * kWarpRows * L::kRowVecs;
      const int r = rem / L::kRowVecs;
      const int c = (rem - r * L::kRowVecs) * L::kVec;
      const int sl = __shfl_sync(0xffffffffu, slot, r);
      const T* src = (side ? pool_v : pool_k) +
                     static_cast<size_t>(sl) * row_stride +
                     static_cast<size_t>(kvh) * D + c;
      cp_async16(dst + (side * kWarpRows + r) * L::kPad + c, src,
                 row0 + r < stop);
    }
  };

  const int r = lane % kWarpRows;  // the row this lane scores
  const int hf = lane / kWarpRows;  // ... over this half of D
  float m[MaxG], l[MaxG], acc[MaxG][L::kCols];
#pragma unroll
  for (int g = 0; g < MaxG; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int c = 0; c < L::kCols; ++c) acc[g][c] = 0.f;
  }
  float* wp = ps + warp * MaxG * kWarpRows;

#pragma unroll
  for (int t = 0; t < kStages; ++t) {
    if (t < n_tiles) issue(t);
    cp_async_commit();
  }
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 1>();  // tile t has landed (this lane's part)
    __syncwarp();                  // ... and the warp's
    const T* ks = wring + (t % kStages) * 2 * kWarpRows * L::kPad;
    const T* vs = ks + kWarpRows * L::kPad;
    const int pos = start + t * kTileRows + warp * kWarpRows + r;

    // scores: row r, half hf of D, every head of the group
    float s[MaxG];
#pragma unroll
    for (int g = 0; g < MaxG; ++g) s[g] = 0.f;
    const T* krow = ks + r * L::kPad + hf * L::kHalf;
#pragma unroll 4
    for (int c = 0; c < L::kHalf; c += L::kVec) {
      float kf[L::kVec];
      load_vec<T, L::kVec>(krow + c, kf);
#pragma unroll
      for (int g = 0; g < MaxG; ++g) {
        if (g < group) {
          const float* qr = qs + (2 * g + hf) * L::kQStride + c;
#pragma unroll
          for (int i = 0; i < L::kVec; i += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(qr + i);
            s[g] = fmaf(qv.x, kf[i], s[g]);
            s[g] = fmaf(qv.y, kf[i + 1], s[g]);
            s[g] = fmaf(qv.z, kf[i + 2], s[g]);
            s[g] = fmaf(qv.w, kf[i + 3], s[g]);
          }
        }
      }
    }
    float mx[MaxG];
#pragma unroll
    for (int g = 0; g < MaxG; ++g) {
      s[g] += __shfl_xor_sync(0xffffffffu, s[g], 16);
      s[g] = pos < stop ? s[g] * scale_log2 : -INFINITY;
      mx[g] = s[g];
    }
#pragma unroll
    for (int off = kWarpRows / 2; off > 0; off >>= 1)
#pragma unroll
      for (int g = 0; g < MaxG; ++g)
        mx[g] = fmaxf(mx[g], __shfl_xor_sync(0xffffffffu, mx[g], off));
    float corr[MaxG], sum[MaxG];
#pragma unroll
    for (int g = 0; g < MaxG; ++g) {
      const float m_new = fmaxf(m[g], mx[g]);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // all masked
      s[g] = exp2f(s[g] - m_use);  // p; 0 for masked rows
      corr[g] = exp2f(m[g] - m_use);
      m[g] = m_new;
      sum[g] = s[g];
    }
#pragma unroll
    for (int off = kWarpRows / 2; off > 0; off >>= 1)
#pragma unroll
      for (int g = 0; g < MaxG; ++g)
        sum[g] += __shfl_xor_sync(0xffffffffu, sum[g], off);
#pragma unroll
    for (int g = 0; g < MaxG; ++g) {
      l[g] = l[g] * corr[g] + sum[g];
      if (hf == 0 && g < group) wp[g * kWarpRows + r] = s[g];
#pragma unroll
      for (int c = 0; c < L::kCols; ++c) acc[g][c] *= corr[g];
    }
    __syncwarp();

    // acc += P V: columns lane * kCols .. + kCols of every head
#pragma unroll
    for (int j0 = 0; j0 < kWarpRows; j0 += 4) {
      float4 pj[MaxG];
#pragma unroll
      for (int g = 0; g < MaxG; ++g)
        if (g < group)
          pj[g] = *reinterpret_cast<const float4*>(wp + g * kWarpRows + j0);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vf[L::kCols];
        load_vec<T, L::kCols>(vs + (j0 + jj) * L::kPad + lane * L::kCols, vf);
#pragma unroll
        for (int g = 0; g < MaxG; ++g) {
          if (g < group) {
            const float p = jj == 0 ? pj[g].x
                            : jj == 1 ? pj[g].y
                            : jj == 2 ? pj[g].z
                                      : pj[g].w;
#pragma unroll
            for (int c = 0; c < L::kCols; ++c)
              acc[g][c] = fmaf(p, vf[c], acc[g][c]);
          }
        }
      }
    }
    __syncwarp();  // ring slot and p scratch are free again
    if (t + kStages < n_tiles) issue(t + kStages);
    cp_async_commit();
  }

  // merge the four warps' states into the span's partial
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: reuse it as scratch
  float* wm = reinterpret_cast<float*>(smem_raw);  // [kWarps][MaxG]
  float* wl = wm + kWarps * MaxG;                  // [kWarps][MaxG]
  float* wacc = wl + kWarps * MaxG;                // [kWarps][MaxG][D]
#pragma unroll
  for (int g = 0; g < MaxG; ++g) {
    if (g < group) {
      if (lane == 0) {
        wm[warp * MaxG + g] = m[g];
        wl[warp * MaxG + g] = l[g];
      }
#pragma unroll
      for (int c = 0; c < L::kCols; ++c)
        wacc[(warp * MaxG + g) * D + lane * L::kCols + c] = acc[g][c];
    }
  }
  __syncthreads();
  for (int i = tid; i < group * D; i += kThreads) {
    const int g = i / D;
    const int c = i - g * D;
    float mm = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, wm[w * MaxG + g]);
    float a = 0.f, ll = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = wm[w * MaxG + g];
      if (mw == -INFINITY) continue;  // a warp with no row in the span
      const float e = exp2f(mw - mm);
      a += wacc[(w * MaxG + g) * D + c] * e;
      ll += wl[w * MaxG + g] * e;
    }
    part_acc[part(g) * D + c] = a;
    if (c == 0) {
      part_ml[2 * part(g)] = mm * kLn2;  // natural-log units
      part_ml[2 * part(g) + 1] = ll;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(128)
paged_decode_merge_kernel(const float* __restrict__ part_acc,
                          const float* __restrict__ part_ml,
                          const int* __restrict__ context_lens,
                          T* __restrict__ out,  // [B, H, D]
                          int heads, int d, int n_splits, int width,
                          int page_size, int split_rows) {
  extern __shared__ float wts[];  // [n_splits] weights, then [n_splits] l
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int c = threadIdx.x;
  const int ctx = max(0, min(context_lens[b], width * page_size));
  const int used = (ctx + split_rows - 1) / split_rows;  // 0 when ctx == 0
  const size_t row = static_cast<size_t>(b) * heads + h;
  const float* ml = part_ml + row * n_splits * 2;
  float* ls = wts + n_splits;
  // the spans' (m, l) once, side by side; then the weights e^(m_i - m)
  for (int i = c; i < used; i += blockDim.x) {
    wts[i] = ml[2 * i];
    ls[i] = ml[2 * i + 1];
  }
  __syncthreads();
  float mm = -INFINITY;
  for (int i = 0; i < used; ++i) mm = fmaxf(mm, wts[i]);
  __syncthreads();
  for (int i = c; i < used; i += blockDim.x)
    wts[i] = wts[i] == -INFINITY ? 0.f : expf(wts[i] - mm);
  __syncthreads();
  float a = 0.f, ll = 0.f;
  const float* acc = part_acc + row * n_splits * d + c;
#pragma unroll 4
  for (int i = 0; i < used; ++i) {
    const float e = wts[i];
    ll = fmaf(ls[i], e, ll);
    // an empty span's accumulator is never written: weight 0, not read
    if (e != 0.f) a = fmaf(acc[static_cast<size_t>(i) * d], e, a);
  }
  out[row * d + c] = rt::from_float<T>(a / fmaxf(ll, 1e-20f));
}

template <typename T, int D, int MaxG>
cudaError_t launch(const void* q, const void* pool_k, const void* pool_v,
                   const void* block_tables, const void* context_lens,
                   void* part_acc, void* part_ml, void* out, int batch,
                   int hkv, int group, int width, int page_size,
                   int split_rows, int n_splits, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<T, D, MaxG>(group);
  auto kernel = paged_decode_split_kernel<T, D, MaxG>;
  cudaError_t err = rt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(batch, hkv, n_splits), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pool_k),
      static_cast<const T*>(pool_v), static_cast<const int*>(block_tables),
      static_cast<const int*>(context_lens), static_cast<float*>(part_acc),
      static_cast<float*>(part_ml), hkv, group, width, page_size, split_rows,
      scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t merge_smem = sizeof(float) * 2 * n_splits;
  err = rt::allow_smem(paged_decode_merge_kernel<T>, merge_smem);
  if (err != cudaSuccess) return err;
  paged_decode_merge_kernel<T>
      <<<dim3(hkv * group, batch), D, merge_smem, stream>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_ml),
      static_cast<const int*>(context_lens), static_cast<T*>(out),
      hkv * group, D, n_splits, width, page_size, split_rows);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_g(int group, const void* q, const void* pool_k,
                     const void* pool_v, const void* block_tables,
                     const void* context_lens, void* part_acc, void* part_ml,
                     void* out, int batch, int hkv, int width, int page_size,
                     int split_rows, int n_splits, float scale,
                     cudaStream_t stream) {
  // heads of a group are unrolled: up to 4 or up to 8; larger groups raise
  if (group <= 4)
    return launch<T, D, 4>(q, pool_k, pool_v, block_tables, context_lens,
                           part_acc, part_ml, out, batch, hkv, group, width,
                           page_size, split_rows, n_splits, scale, stream);
  if (group <= 8)
    return launch<T, D, 8>(q, pool_k, pool_v, block_tables, context_lens,
                           part_acc, part_ml, out, batch, hkv, group, width,
                           page_size, split_rows, n_splits, scale, stream);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_d(int d, int group, const void* q, const void* pool_k,
                     const void* pool_v, const void* block_tables,
                     const void* context_lens, void* part_acc, void* part_ml,
                     void* out, int batch, int hkv, int width, int page_size,
                     int split_rows, int n_splits, float scale,
                     cudaStream_t stream) {
  switch (d) {
    case 64:
      return launch_g<T, 64>(group, q, pool_k, pool_v, block_tables,
                             context_lens, part_acc, part_ml, out, batch, hkv,
                             width, page_size, split_rows, n_splits, scale,
                             stream);
    case 128:
      return launch_g<T, 128>(group, q, pool_k, pool_v, block_tables,
                              context_lens, part_acc, part_ml, out, batch,
                              hkv, width, page_size, split_rows, n_splits,
                              scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int rt_paged_attention(const void* q, const void* pool_k,
                                  const void* pool_v, const void* block_tables,
                                  const void* context_lens, void* part_acc,
                                  void* part_ml, void* out, int batch,
                                  int hkv, int group, int d, int width,
                                  int page_size, int split_rows, int n_splits,
                                  float scale, int is_bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_d<__nv_bfloat16>(d, group, q, pool_k, pool_v,
                                        block_tables, context_lens, part_acc,
                                        part_ml, out, batch, hkv, width,
                                        page_size, split_rows, n_splits,
                                        scale, s)
              : launch_d<float>(d, group, q, pool_k, pool_v, block_tables,
                                context_lens, part_acc, part_ml, out, batch,
                                hkv, width, page_size, split_rows, n_splits,
                                scale, s);
  return static_cast<int>(err);
}
