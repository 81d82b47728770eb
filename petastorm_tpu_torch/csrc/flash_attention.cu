// Flash attention for Hopper (sm_90a): forward, backward dK/dV, backward dQ.
//
// Replaces the three Pallas TPU kernels behind
// petastorm_tpu/ops/flash_attention.py::flash_attention_fused (jax's
// jax/experimental/pallas/ops/tpu/flash_attention.py): the forward
// _flash_attention_kernel (pallas_call at :758), the dK/dV kernel
// _flash_attention_dkv_kernel (:1121) and the dQ kernel
// _flash_attention_dq_kernel (:1456). Blockwise online-softmax attention
// in which the (S, S) scores live only in registers and shared memory:
//
//   forward:  O = softmax(scale * Q K^T) V, lse = m + log(l) per row (f32)
//   dK/dV:    P = exp(scale * Q K^T - lse), dS = P * (dO V^T - Di),
//             dV = P^T dO, dK = scale * dS^T Q      (Di = rowsum(dO * O))
//   dQ:       dQ = scale * dS K
//
// The TPU kernel saves the row max m and row sum l; this one saves
// lse = m + log(l), which recomputes the same P.
//
// Layout: q, k, v, o, dO, dq, dk, dv are (B, S, H, D) with element strides
// for b, s and h and a unit stride for d, so the heads sliced out of a
// fused qkv projection are read in place. lse and Di are contiguous
// (B, H, S) f32. Inputs are bf16 or f32; every product and sum is f32.
//
// Design. One block of 256 threads per (b, h, 64-row tile): Q tiles for
// the forward and dQ, K/V tiles for dK/dV, which loops over the Q tiles
// (on the TPU a sequential grid axis carries the sums; here a loop inside
// the block does). Tiles are converted to f32 in shared memory, rows
// padded to D+1 floats so the column-wise reads hit 32 banks. A 16 x 16
// thread grid owns a 4 x 4 block of each 64 x 64 score tile (rows
// ty + 16 i, columns tx + 16 j); the 16 threads of a score row sit in one
// half-warp, so row max and row sum are four xor-shuffles. Products are
// scalar f32 FMAs from shared memory. Causal blocks skip the tiles above
// the diagonal; the tail tile of any S >= 1 is masked, padded d columns
// are zeros. D is padded to DP in {32, 64, 96, 128}.
//
// Bound. At the flagship shape (8, 1024, 16, 96) bf16 causal, the
// forward does 4*B*H*S(S+1)/2*D = 25.8 GFLOP and moves 101 MB: 26 us at
// the H100's 989 TFLOP/s bf16 tensor-core rate, 30 us at 3.35 TB/s. The
// backward kernels do 2x and 1.5x the forward's operations on about the
// same bytes, so operations bound them. This simple design runs every
// product on the f32 FMA pipes (67 TFLOP/s at most) and never reaches
// the tensor cores, so operations are what limit it: mma/wgmma tiles,
// TMA staging and bf16 shared-memory tiles are later work.
//
// C interface (bound with ctypes): each entry point returns
// cudaGetLastError() after its launch; the wrapper raises if it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;       // rows of a Q tile and of a K/V tile
constexpr int kThreads = 256;   // a 16 x 16 grid of threads
constexpr int kLdP = kTile + 1; // row stride of a score tile in shared memory

struct Strides {
    long long b, s, h;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Sum or max over the 16 lanes of a half-warp (the threads of one score row).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
    return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
    return x;
}

// Rows [row0, row0 + 64) of one (b, h) slice into tile[64][DP + 1] as f32;
// rows at or past S and columns at or past D are zeros.
template <typename T, int DP>
__device__ __forceinline__ void load_tile(float* tile, const T* base, long long stride_s,
                                          int row0, int S, int D) {
    for (int idx = threadIdx.x; idx < kTile * DP; idx += kThreads) {
        const int r = idx / DP;
        const int d = idx - r * DP;
        const int s = row0 + r;
        float v = 0.f;
        if (s < S && d < D) v = to_f32(base[(long long)s * stride_s + d]);
        tile[r * (DP + 1) + d] = v;
    }
}

// Per-row f32 values (lse or Di) of rows [row0, row0 + 64); 0 past S.
__device__ __forceinline__ void load_rows(float* dst, const float* src, int row0, int S) {
    for (int t = threadIdx.x; t < kTile; t += kThreads) {
        const int r = row0 + t;
        dst[t] = r < S ? src[r] : 0.f;
    }
}

// acc[i][j] = sum_d A[ty + 16 i][d] * B[tx + 16 j][d] over two tiles in
// shared memory (row stride DP + 1).
template <int DP>
__device__ __forceinline__ void tile_dot(float (&acc)[4][4], const float* A, const float* B,
                                         int ty, int tx) {
    constexpr int LD = DP + 1;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DP; ++d) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * LD + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = B[(tx + 16 * j) * LD + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
}

__device__ __forceinline__ bool visible(int r, int c, int S, int causal) {
    return r < S && c < S && (!causal || c <= r);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, Strides sq, Strides sk,
                 Strides sv, Strides so, int S, int H, int D, int causal, float scale) {
    constexpr int LD = DP + 1;
    constexpr int NJ = DP / 16;
    extern __shared__ float smem[];
    float* sQ = smem;
    float* sK = sQ + kTile * LD;
    float* sV = sK + kTile * LD;
    float* sP = sV + kTile * LD;

    const int qt = gridDim.x - 1 - blockIdx.x;  // the longest causal rows first
    const int h = blockIdx.y, b = blockIdx.z;
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    const int q0 = qt * kTile;
    const T* kb = k + b * sk.b + h * sk.h;
    const T* vb = v + b * sv.b + h * sv.h;

    load_tile<T, DP>(sQ, q + b * sq.b + h * sq.h, sq.s, q0, S, D);

    float m[4], l[4], acc[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = -INFINITY;
        l[i] = 0.f;
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
    }

    const int n_kt = causal ? qt + 1 : (S + kTile - 1) / kTile;
    for (int kt = 0; kt < n_kt; ++kt) {
        const int k0 = kt * kTile;
        __syncthreads();  // the previous tile's sK, sV and sP reads are done
        load_tile<T, DP>(sK, kb, sk.s, k0, S, D);
        load_tile<T, DP>(sV, vb, sv.s, k0, S, D);
        __syncthreads();

        float s[4][4];
        tile_dot<DP>(s, sQ, sK, ty, tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int r = q0 + ty + 16 * i;
            float mx = -INFINITY;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int c = k0 + tx + 16 * j;
                // rows past S keep their unmasked columns: never written
                s[i][j] = (c < S && (!causal || c <= r)) ? s[i][j] * scale : -INFINITY;
                mx = fmaxf(mx, s[i][j]);
            }
            mx = row_max(mx);
            const float m_new = fmaxf(m[i], mx);
            const float m_use = m_new == -INFINITY ? 0.f : m_new;
            const float alpha = expf(m[i] - m_use);
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float p = expf(s[i][j] - m_use);
                sum += p;
                sP[(ty + 16 * i) * kLdP + tx + 16 * j] = p;
            }
            l[i] = l[i] * alpha + row_sum(sum);
            m[i] = m_new;
#pragma unroll
            for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
        }
        __syncthreads();

#pragma unroll 4
        for (int c = 0; c < kTile; ++c) {
            float p[4], vv[NJ];
#pragma unroll
            for (int i = 0; i < 4; ++i) p[i] = sP[(ty + 16 * i) * kLdP + c];
#pragma unroll
            for (int j = 0; j < NJ; ++j) vv[j] = sV[c * LD + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
        }
    }

    float* lse_bh = lse + ((long long)b * H + h) * S;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int r = q0 + ty + 16 * i;
        if (r >= S) continue;
        const float inv = 1.f / l[i];
        T* orow = o + b * so.b + (long long)r * so.s + h * so.h;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
            const int d = tx + 16 * j;
            if (d < D) store(orow + d, acc[i][j] * inv);
        }
        if (tx == 0) lse_bh[r] = m[i] + logf(l[i]);
    }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ di, T* __restrict__ dk, T* __restrict__ dv,
                     Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdk, Strides sdv,
                     int S, int H, int D, int causal, float scale) {
    constexpr int LD = DP + 1;
    constexpr int NJ = DP / 16;
    extern __shared__ float smem[];
    float* sK = smem;
    float* sV = sK + kTile * LD;
    float* sQ = sV + kTile * LD;
    float* sdO = sQ + kTile * LD;
    float* sP = sdO + kTile * LD;
    float* sdS = sP + kTile * kLdP;
    float* sL = sdS + kTile * kLdP;
    float* sDi = sL + kTile;

    const int kt = blockIdx.x;
    const int h = blockIdx.y, b = blockIdx.z;
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    const int k0 = kt * kTile;
    const T* qb = q + b * sq.b + h * sq.h;
    const T* dob = dout + b * sdo.b + h * sdo.h;
    const float* lse_bh = lse + ((long long)b * H + h) * S;
    const float* di_bh = di + ((long long)b * H + h) * S;

    load_tile<T, DP>(sK, k + b * sk.b + h * sk.h, sk.s, k0, S, D);
    load_tile<T, DP>(sV, v + b * sv.b + h * sv.h, sv.s, k0, S, D);

    // rows c = k0 + ty + 16 i of dK and dV, columns d = tx + 16 j
    float dk_acc[4][NJ], dv_acc[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

    const int n_qt = (S + kTile - 1) / kTile;
    for (int qt = causal ? kt : 0; qt < n_qt; ++qt) {
        const int q0 = qt * kTile;
        __syncthreads();  // the previous tile's reads are done
        load_tile<T, DP>(sQ, qb, sq.s, q0, S, D);
        load_tile<T, DP>(sdO, dob, sdo.s, q0, S, D);
        load_rows(sL, lse_bh, q0, S);
        load_rows(sDi, di_bh, q0, S);
        __syncthreads();

        float s[4][4], dp[4][4];
        tile_dot<DP>(s, sQ, sK, ty, tx);
        tile_dot<DP>(dp, sdO, sV, ty, tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int ri = ty + 16 * i;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int cj = tx + 16 * j;
                const float p = visible(q0 + ri, k0 + cj, S, causal)
                                    ? expf(s[i][j] * scale - sL[ri]) : 0.f;
                sP[ri * kLdP + cj] = p;
                sdS[ri * kLdP + cj] = p * (dp[i][j] - sDi[ri]);
            }
        }
        __syncthreads();

#pragma unroll 4
        for (int r = 0; r < kTile; ++r) {
            float p[4], ds[4], dov[NJ], qv[NJ];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                p[i] = sP[r * kLdP + ty + 16 * i];
                ds[i] = sdS[r * kLdP + ty + 16 * i];
            }
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
                dov[j] = sdO[r * LD + tx + 16 * j];
                qv[j] = sQ[r * LD + tx + 16 * j];
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < NJ; ++j) {
                    dv_acc[i][j] = fmaf(p[i], dov[j], dv_acc[i][j]);
                    dk_acc[i][j] = fmaf(ds[i], qv[j], dk_acc[i][j]);
                }
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int c = k0 + ty + 16 * i;
        if (c >= S) continue;
        T* dkrow = dk + b * sdk.b + (long long)c * sdk.s + h * sdk.h;
        T* dvrow = dv + b * sdv.b + (long long)c * sdv.s + h * sdv.h;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
            const int d = tx + 16 * j;
            if (d < D) {
                store(dkrow + d, dk_acc[i][j] * scale);
                store(dvrow + d, dv_acc[i][j]);
            }
        }
    }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ di, T* __restrict__ dq, Strides sq, Strides sk,
                    Strides sv, Strides sdo, Strides sdq, int S, int H, int D, int causal,
                    float scale) {
    constexpr int LD = DP + 1;
    constexpr int NJ = DP / 16;
    extern __shared__ float smem[];
    float* sQ = smem;
    float* sdO = sQ + kTile * LD;
    float* sK = sdO + kTile * LD;
    float* sV = sK + kTile * LD;
    float* sdS = sV + kTile * LD;
    float* sL = sdS + kTile * kLdP;
    float* sDi = sL + kTile;

    const int qt = gridDim.x - 1 - blockIdx.x;  // the longest causal rows first
    const int h = blockIdx.y, b = blockIdx.z;
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    const int q0 = qt * kTile;
    const T* kb = k + b * sk.b + h * sk.h;
    const T* vb = v + b * sv.b + h * sv.h;

    load_tile<T, DP>(sQ, q + b * sq.b + h * sq.h, sq.s, q0, S, D);
    load_tile<T, DP>(sdO, dout + b * sdo.b + h * sdo.h, sdo.s, q0, S, D);
    load_rows(sL, lse + ((long long)b * H + h) * S, q0, S);
    load_rows(sDi, di + ((long long)b * H + h) * S, q0, S);

    // rows r = q0 + ty + 16 i of dQ, columns d = tx + 16 j
    float dq_acc[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) dq_acc[i][j] = 0.f;

    const int n_kt = causal ? qt + 1 : (S + kTile - 1) / kTile;
    for (int kt = 0; kt < n_kt; ++kt) {
        const int k0 = kt * kTile;
        __syncthreads();  // the previous tile's sK and sdS reads are done
        load_tile<T, DP>(sK, kb, sk.s, k0, S, D);
        load_tile<T, DP>(sV, vb, sv.s, k0, S, D);
        __syncthreads();

        float s[4][4], dp[4][4];
        tile_dot<DP>(s, sQ, sK, ty, tx);
        tile_dot<DP>(dp, sdO, sV, ty, tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int ri = ty + 16 * i;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int cj = tx + 16 * j;
                const float p = visible(q0 + ri, k0 + cj, S, causal)
                                    ? expf(s[i][j] * scale - sL[ri]) : 0.f;
                sdS[ri * kLdP + cj] = p * (dp[i][j] - sDi[ri]);
            }
        }
        __syncthreads();

#pragma unroll 4
        for (int c = 0; c < kTile; ++c) {
            float ds[4], kv[NJ];
#pragma unroll
            for (int i = 0; i < 4; ++i) ds[i] = sdS[(ty + 16 * i) * kLdP + c];
#pragma unroll
            for (int j = 0; j < NJ; ++j) kv[j] = sK[c * LD + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < NJ; ++j) dq_acc[i][j] = fmaf(ds[i], kv[j], dq_acc[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int r = q0 + ty + 16 * i;
        if (r >= S) continue;
        T* dqrow = dq + b * sdq.b + (long long)r * sdq.s + h * sdq.h;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
            const int d = tx + 16 * j;
            if (d < D) store(dqrow + d, dq_acc[i][j] * scale);
        }
    }
}

template <int DP> constexpr size_t fwd_smem() {
    return sizeof(float) * (3 * kTile * (DP + 1) + kTile * kLdP);
}
template <int DP> constexpr size_t dkv_smem() {
    return sizeof(float) * (4 * kTile * (DP + 1) + 2 * kTile * kLdP + 2 * kTile);
}
template <int DP> constexpr size_t dq_smem() {
    return sizeof(float) * (4 * kTile * (DP + 1) + kTile * kLdP + 2 * kTile);
}

// A kernel's launch with its dynamic shared memory; above 48 KB the
// kernel has to be allowed that much first.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, size_t smem, dim3 grid, cudaStream_t stream, Args... args) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, kThreads, smem, stream>>>(args...);
    return (int)cudaGetLastError();
}

Strides strides_at(const long long* s, int i) { return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]}; }

dim3 grid_of(int B, int S, int H) { return dim3((unsigned)((S + kTile - 1) / kTile), H, B); }

template <typename T, int DP>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse, const long long* st,
        int B, int S, int H, int D, int causal, float scale, cudaStream_t stream) {
    return launch(flash_fwd_kernel<T, DP>, fwd_smem<DP>(), grid_of(B, S, H), stream,
                  (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse,
                  strides_at(st, 0), strides_at(st, 1), strides_at(st, 2), strides_at(st, 3),
                  S, H, D, causal, scale);
}

template <typename T, int DP>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
            const void* di, void* dk, void* dv, const long long* st, int B, int S, int H,
            int D, int causal, float scale, cudaStream_t stream) {
    return launch(flash_bwd_dkv_kernel<T, DP>, dkv_smem<DP>(), grid_of(B, S, H), stream,
                  (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (const float*)lse,
                  (const float*)di, (T*)dk, (T*)dv, strides_at(st, 0), strides_at(st, 1),
                  strides_at(st, 2), strides_at(st, 3), strides_at(st, 4), strides_at(st, 5),
                  S, H, D, causal, scale);
}

template <typename T, int DP>
int bwd_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
           const void* di, void* dq, const long long* st, int B, int S, int H, int D,
           int causal, float scale, cudaStream_t stream) {
    return launch(flash_bwd_dq_kernel<T, DP>, dq_smem<DP>(), grid_of(B, S, H), stream,
                  (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (const float*)lse,
                  (const float*)di, (T*)dq, strides_at(st, 0), strides_at(st, 1),
                  strides_at(st, 2), strides_at(st, 3), strides_at(st, 4), S, H, D, causal,
                  scale);
}

bool valid(int B, int S, int H, int D, int dtype) {
    return B >= 1 && S >= 1 && H >= 1 && D >= 8 && D <= 128 && D % 8 == 0 &&
           (dtype == 0 || dtype == 1) && B <= 65535 && H <= 65535;
}

}  // namespace

// Returns fn<T, DP>(...) for dtype (0 = float32, 1 = bfloat16) and D
// padded to a multiple of 32.
#define PT_FLASH_DISPATCH(fn, ...)                                                  \
    const int dp = (D + 31) / 32;                                                   \
    if (dtype == 0) {                                                               \
        if (dp == 1) return fn<float, 32>(__VA_ARGS__);                             \
        if (dp == 2) return fn<float, 64>(__VA_ARGS__);                             \
        if (dp == 3) return fn<float, 96>(__VA_ARGS__);                             \
        return fn<float, 128>(__VA_ARGS__);                                         \
    }                                                                               \
    if (dp == 1) return fn<__nv_bfloat16, 32>(__VA_ARGS__);                         \
    if (dp == 2) return fn<__nv_bfloat16, 64>(__VA_ARGS__);                         \
    if (dp == 3) return fn<__nv_bfloat16, 96>(__VA_ARGS__);                         \
    return fn<__nv_bfloat16, 128>(__VA_ARGS__)

// strides: (b, s, h) element strides of q, k, v, o, in that order.
extern "C" int pt_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                            const long long* strides, int B, int S, int H, int D, int causal,
                            float scale, int dtype, void* stream) {
    if (!valid(B, S, H, D, dtype)) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    PT_FLASH_DISPATCH(fwd, q, k, v, o, lse, strides, B, S, H, D, causal, scale, s);
}

// strides: (b, s, h) element strides of q, k, v, dout, dk, dv, in that order.
extern "C" int pt_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* di, void* dk, void* dv,
                                const long long* strides, int B, int S, int H, int D,
                                int causal, float scale, int dtype, void* stream) {
    if (!valid(B, S, H, D, dtype)) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    PT_FLASH_DISPATCH(bwd_dkv, q, k, v, dout, lse, di, dk, dv, strides, B, S, H, D, causal,
                      scale, s);
}

// strides: (b, s, h) element strides of q, k, v, dout, dq, in that order.
extern "C" int pt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse, const void* di, void* dq,
                               const long long* strides, int B, int S, int H, int D,
                               int causal, float scale, int dtype, void* stream) {
    if (!valid(B, S, H, D, dtype)) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    PT_FLASH_DISPATCH(bwd_dq, q, k, v, dout, lse, di, dq, strides, B, S, H, D, causal, scale,
                      s);
}
