// A residual add into a transformer's token stream and the LayerNorm that
// reads the stream next, in one pass, on Hopper (sm_90a).  SwinIR (arXiv
// 2108.10257, models/swinir.py) adds a branch to its bf16 stream 118 times
// a forward, and 108 of those sums go straight into a LayerNorm.
//
// No TPU kernel of the JAX package computes this: the JAX package has no
// SwinIR and no LayerNorm.  The kernel takes the place of PyTorch's bf16
// add followed by its LayerNorm on the port's SwinIR path.
//
// Math, per row of C channels (x, branch, weight, bias bf16):
//   s = bf16(x + branch)                 (a float32 add, rounded to nearest
//                                         even: PyTorch's bf16 add, bit for
//                                         bit)
//   mean = sum(s) / C, var = sum((s - mean)^2) / C, both float32 over the
//   rounded s; rstd = rsqrt(var + eps)
//   h = bf16(weight * (rstd * (s - mean)) + bias)
// Without a branch, s is x and only h is written.
//
// Design.  The work is bound by bytes: about 10 FLOP an element against 8
// bytes moved (x and branch read, s and h written; 4 bytes without a
// branch).  One warp owns a row: at C = 240 thirty lanes each load one
// 16-byte piece of x and of the branch (C a multiple of 8; else 8-byte
// pieces of 4 channels), so a row is read and written in whole 16-byte
// transactions, and the mean and then the sum of squares come from
// registers by warp shuffles, with no shared memory.  The grid has a warp
// for every row, four to a block (the ragged last block's spare warps
// leave at once), and the hardware keeps as many warps an SM in flight as
// its registers hold, each with its row's loads issued together.  On an H100 at (1, 1024^2,
// 240) that ran the add at 89 % of its bound; a grid of resident blocks
// whose warps walked the rows, each issuing its next row's loads before
// reducing this one, ran at 76 %, and at 8 or 16 warps a block no faster.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 4;         // warps (rows) a block
constexpr int kMaxC = 1024;       // widest row a lane's registers hold

template <int V>
struct Piece;                     // V bf16 channels in one load
template <>
struct Piece<8> {
  using T = uint4;
};
template <>
struct Piece<4> {
  using T = uint2;
};

struct Params {
  const __nv_bfloat16* x;
  const __nv_bfloat16* branch;   // null: normalise x alone
  const __nv_bfloat16* weight;
  const __nv_bfloat16* bias;
  __nv_bfloat16* s;              // x + branch; unused without a branch
  __nv_bfloat16* h;
  long long rows;
  int c;
  float eps;
};

template <int V>
__device__ __forceinline__ void unpack(const typename Piece<V>::T& v,
                                       float (&f)[V]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < V / 2; ++i) {
    const float2 t = __bfloat1622float2(p[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

template <int V>
__device__ __forceinline__ typename Piece<V>::T pack(const float (&f)[V]) {
  typename Piece<V>::T v;
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < V / 2; ++i)
    p[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// V channels a piece, P pieces a lane (piece i * 32 + lane of the row)
template <int V, int P, bool kAdd>
__global__ void __launch_bounds__(32 * kWarps)
    add_layernorm_kernel(Params p) {
  using T = typename Piece<V>::T;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= p.rows) return;      // a whole warp: the ragged last block
  const int lane = threadIdx.x & 31;
  const int pieces = p.c / V;
  const size_t base = (size_t)row * pieces + lane;

  bool mine[P];
  T x[P], br[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    mine[i] = i * 32 + lane < pieces;
    if (!mine[i]) continue;
    x[i] = reinterpret_cast<const T*>(p.x)[base + i * 32];
    if (kAdd) br[i] = reinterpret_cast<const T*>(p.branch)[base + i * 32];
  }

  float v[P][V];
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < P; ++i) {
#pragma unroll
    for (int e = 0; e < V; ++e) v[i][e] = 0.0f;
    if (!mine[i]) continue;
    unpack<V>(x[i], v[i]);
    if (kAdd) {
      float t[V];
      unpack<V>(br[i], t);
#pragma unroll
      for (int e = 0; e < V; ++e) v[i][e] += t[e];
      const T sv = pack<V>(v[i]);
      reinterpret_cast<T*>(p.s)[base + i * 32] = sv;
      unpack<V>(sv, v[i]);       // the statistics read the rounded sum
    }
#pragma unroll
    for (int e = 0; e < V; ++e) sum += v[i][e];
  }
  const float inv_c = 1.0f / p.c;
  const float mean = warp_sum(sum) * inv_c;
  float sq = 0.0f;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    if (!mine[i]) continue;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float d = v[i][e] - mean;
      sq += d * d;
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) * inv_c + p.eps);
#pragma unroll
  for (int i = 0; i < P; ++i) {
    if (!mine[i]) continue;
    float w[V], b[V];
    unpack<V>(reinterpret_cast<const T*>(p.weight)[i * 32 + lane], w);
    unpack<V>(reinterpret_cast<const T*>(p.bias)[i * 32 + lane], b);
#pragma unroll
    for (int e = 0; e < V; ++e)
      v[i][e] = w[e] * (rstd * (v[i][e] - mean)) + b[e];
    reinterpret_cast<T*>(p.h)[base + i * 32] = pack<V>(v[i]);
  }
}

template <int V, int P, bool kAdd>
int launch(const Params& p, cudaStream_t stream) {
  const long long blocks = (p.rows + kWarps - 1) / kWarps;
  add_layernorm_kernel<V, P, kAdd><<<(unsigned)blocks, 32 * kWarps, 0,
                                     stream>>>(p);
  return (int)cudaGetLastError();
}

template <int V, bool kAdd>
int dispatch(const Params& p, cudaStream_t stream) {
  switch ((p.c / V + 31) / 32) {
    case 1: return launch<V, 1, kAdd>(p, stream);
    case 2: return launch<V, 2, kAdd>(p, stream);
    case 3: return launch<V, 3, kAdd>(p, stream);
    case 4: return launch<V, 4, kAdd>(p, stream);
  }
  if constexpr (V == 4) {
    switch ((p.c / V + 31) / 32) {
      case 5: return launch<V, 5, kAdd>(p, stream);
      case 6: return launch<V, 6, kAdd>(p, stream);
      case 7: return launch<V, 7, kAdd>(p, stream);
      case 8: return launch<V, 8, kAdd>(p, stream);
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// s = x + branch and h = LayerNorm(s) over the last dim of (rows, c)
// bf16 tensors, all contiguous; branch and s null to normalise x alone.
// c a multiple of 4 in [4, 1024]; every pointer aligned to 16 bytes when
// c is a multiple of 8, else to 8.  Returns cudaGetLastError() after the
// launch (0 on success, nothing launched for 0 rows); the Python wrapper
// checks the tensors.
extern "C" int add_layernorm_launch(const void* x, const void* branch,
                                    const void* weight, const void* bias,
                                    void* s, void* h, long long rows, int c,
                                    float eps, void* stream) {
  const bool add = branch != nullptr;
  const uintptr_t align = c % 8 == 0 ? 16 : 8;
  if (rows < 0 || rows > 0x7fffffffLL * kWarps || c < 4 || c > kMaxC ||
      c % 4 || (add && s == nullptr) ||
      (uintptr_t)x % align || (uintptr_t)branch % align ||
      (uintptr_t)weight % align || (uintptr_t)bias % align ||
      (uintptr_t)s % align || (uintptr_t)h % align)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const Params p{static_cast<const __nv_bfloat16*>(x),
                 static_cast<const __nv_bfloat16*>(branch),
                 static_cast<const __nv_bfloat16*>(weight),
                 static_cast<const __nv_bfloat16*>(bias),
                 static_cast<__nv_bfloat16*>(s),
                 static_cast<__nv_bfloat16*>(h),
                 rows, c, eps};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c % 8 == 0)
    return add ? dispatch<8, true>(p, st) : dispatch<8, false>(p, st);
  return add ? dispatch<4, true>(p, st) : dispatch<4, false>(p, st);
}

extern "C" const char* add_layernorm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
