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
// (B, H, S) f32. Inputs are bf16 or f32; every sum is f32.
//
// Every kernel works on (b, h, 64-row tile) blocks: Q tiles for the
// forward and dQ, K/V tiles for dK/dV, which loops over the Q tiles (on
// the TPU a sequential grid axis carries the sums; here a loop inside the
// block does). Causal blocks skip the tiles above the diagonal; the tail
// tile of any S >= 1 is masked, padded d columns are zeros. D is padded
// to DP in {32, 64, 96, 128}.
//
// bf16 inputs: Hopper tensor cores, all three kernels. One warpgroup (128
// threads) per block. bf16 tiles sit in shared memory as DP/32 atoms of
// 64 rows x 32 columns, each row 64 bytes with the 64-byte swizzle (16-byte
// chunk c of row r at chunk c ^ ((r >> 1) & 3)), which wgmma descriptors
// read both K-major (d as the reduction axis) and MN-major (rows as the
// reduction axis) from the same buffer. Streamed tiles (K/V in the
// forward and dQ; Q, dO, lse, Di in dK/dV) come through a two-stage ring
// of 16-byte cp.async copies that zero-fill rows past S and padded
// columns, so the next tile's copy overlaps this tile's products. Score
// products are SS wgmma m64n64k16 (both operands in shared memory):
//   forward:  S = Q K^T; online softmax on the f32 accumulator fragments
//             (a row's 16 values sit in a quad of lanes: two shuffles);
//             P rounded to bf16 in registers is the A operand of the RS
//             wgmma O += P V (N = DP, V read MN-major).
//   dK/dV:    S^T = K Q^T and dP^T = V dO^T, so P^T and dS^T come out in
//             the accumulator layout with lse and Di indexed by the
//             fragment's columns (the queries); rounded to bf16 they are
//             the A operands of dV += P^T dO and dK += dS^T Q (RS wgmma,
//             dO and Q read MN-major).
//   dQ:       S = Q K^T and dP = dO V^T with Q and dO resident, lse and Di
//             of a thread's two rows in registers; dS rounded to bf16 is
//             the A operand of dQ += dS K (RS wgmma, K read MN-major from
//             the tile the score product read K-major). Each block owns
//             its dQ rows, so no sum crosses blocks: no atomics, and the
//             same inputs give the same bits.
// P and dS are rounded to bf16 before their products, as in FlashAttention
// 2 and 3; every accumulator is f32.
//
// f32 inputs: scalar. One block of 256 threads; tiles converted to f32 in
// shared memory, rows padded to D+1 floats so the column-wise reads hit 32
// banks. A 16 x 16 thread grid owns a 4 x 4 block of each 64 x 64 score
// tile (rows ty + 16 i, columns tx + 16 j); the 16 threads of a score row
// sit in one half-warp, so row max and row sum are four xor-shuffles.
// Products are f32 FMAs from shared memory, which keeps f32 inputs at the
// JAX kernel tests' tolerances (TF32 or bf16 tensor cores would not).
//
// Bound. At the flagship shape (8, 1024, 16, 96) bf16 causal, the
// forward does 4*B*H*S(S+1)/2*D = 25.8 GFLOP and moves 101 MB: 26 us at
// the H100's 989 TFLOP/s bf16 tensor-core rate, 30 us at 3.35 TB/s. The
// backward kernels do 2x (dK/dV) and 1.5x (dQ) the forward's operations
// on about the same bytes, so operations bound them. The tensor-core
// kernels reach for that rate with one warpgroup per block and no warp
// specialisation: a block waits for each product before its softmax or
// dS (no ping-pong between warpgroups), and the streamed tiles are
// re-read from L2 by every block of the same (b, h). The scalar kernels
// run on the f32 FMA pipes (67 TFLOP/s at most).
//
// C interface (bound with ctypes): each entry point returns
// cudaGetLastError() after its launch; the wrapper raises if it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

namespace {

constexpr int kTile = 64;       // rows of a Q tile and of a K/V tile
constexpr int kThreads = 256;   // a 16 x 16 grid of threads (scalar kernels)
constexpr int kWgThreads = 128; // one warpgroup (tensor-core kernels)
constexpr int kLdP = kTile + 1; // row stride of a score tile in shared memory

struct Strides {
    long long b, s, h;
};

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

// Rows [row0, row0 + 64) of one (b, h) slice into tile[64][DP + 1];
// rows at or past S and columns at or past D are zeros.
template <int DP>
__device__ __forceinline__ void load_tile(float* tile, const float* base, long long stride_s,
                                          int row0, int S, int D) {
    for (int idx = threadIdx.x; idx < kTile * DP; idx += kThreads) {
        const int r = idx / DP;
        const int d = idx - r * DP;
        const int s = row0 + r;
        float v = 0.f;
        if (s < S && d < D) v = base[(long long)s * stride_s + d];
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

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                 Strides sq, Strides sk, Strides sv, Strides so, int S, int H, int D,
                 int causal, float scale) {
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
    const float* kb = k + b * sk.b + h * sk.h;
    const float* vb = v + b * sv.b + h * sv.h;

    load_tile<DP>(sQ, q + b * sq.b + h * sq.h, sq.s, q0, S, D);

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
        load_tile<DP>(sK, kb, sk.s, k0, S, D);
        load_tile<DP>(sV, vb, sv.s, k0, S, D);
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
        float* orow = o + b * so.b + (long long)r * so.s + h * so.h;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
            const int d = tx + 16 * j;
            if (d < D) orow[d] = acc[i][j] * inv;
        }
        if (tx == 0) lse_bh[r] = m[i] + logf(l[i]);
    }
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ di,
                     float* __restrict__ dk, float* __restrict__ dv,
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
    const float* qb = q + b * sq.b + h * sq.h;
    const float* dob = dout + b * sdo.b + h * sdo.h;
    const float* lse_bh = lse + ((long long)b * H + h) * S;
    const float* di_bh = di + ((long long)b * H + h) * S;

    load_tile<DP>(sK, k + b * sk.b + h * sk.h, sk.s, k0, S, D);
    load_tile<DP>(sV, v + b * sv.b + h * sv.h, sv.s, k0, S, D);

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
        load_tile<DP>(sQ, qb, sq.s, q0, S, D);
        load_tile<DP>(sdO, dob, sdo.s, q0, S, D);
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
        float* dkrow = dk + b * sdk.b + (long long)c * sdk.s + h * sdk.h;
        float* dvrow = dv + b * sdv.b + (long long)c * sdv.s + h * sdv.h;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
            const int d = tx + 16 * j;
            if (d < D) {
                dkrow[d] = dk_acc[i][j] * scale;
                dvrow[d] = dv_acc[i][j];
            }
        }
    }
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ di,
                    float* __restrict__ dq, Strides sq, Strides sk,
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
    const float* kb = k + b * sk.b + h * sk.h;
    const float* vb = v + b * sv.b + h * sv.h;

    load_tile<DP>(sQ, q + b * sq.b + h * sq.h, sq.s, q0, S, D);
    load_tile<DP>(sdO, dout + b * sdo.b + h * sdo.h, sdo.s, q0, S, D);
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
        load_tile<DP>(sK, kb, sk.s, k0, S, D);
        load_tile<DP>(sV, vb, sv.s, k0, S, D);
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
        float* dqrow = dq + b * sdq.b + (long long)r * sdq.s + h * sdq.h;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
            const int d = tx + 16 * j;
            if (d < D) dqrow[d] = dq_acc[i][j] * scale;
        }
    }
}

// ---- tensor-core kernels (bf16) ---------------------------------------------

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kAtomBytes = kTile * 64;  // one 64-row x 32-column bf16 atom of a tile

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset in a tile of 16-byte chunk c (bf16 columns 8c..8c+7) of row r:
// 32-column atoms one after another, 64-byte rows, 64-byte swizzle (the
// chunk index XOR address bits 7-8). Tiles start 1024-byte aligned.
__device__ __forceinline__ uint32_t chunk_offset(int r, int c) {
    return (c >> 2) * kAtomBytes + r * 64 + (((c & 3) ^ ((r >> 1) & 3)) << 4);
}

// wgmma shared-memory matrix descriptor for the 64-byte swizzle; the
// address and both offsets in bytes.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
    return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
           ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (2ull << 62);
}

// k-step kk (columns 16kk..16kk+15 as the reduction axis) of a tile read
// K-major: 8-row groups 512 bytes apart (the leading offset is unused).
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
    return make_desc(tile + (kk >> 1) * kAtomBytes + (kk & 1) * 32, 16, 512);
}

// k-step kk (rows 16kk..16kk+15 as the reduction axis) of a tile read
// MN-major: 32-column atoms kAtomBytes apart, 8-row groups 512 bytes apart.
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
    return make_desc(tile + kk * 16 * 64, kAtomBytes, 512);
}

// 16-byte (4-byte) copy to shared memory that writes zeros when !valid.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 ::"r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 ::"r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Makes this thread's finished copies visible to wgmma (the async proxy);
// a __syncthreads() after it covers every thread's.
__device__ __forceinline__ void fence_async_smem() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Pins an accumulator's registers here, so no read of it moves above a
// wgmma wait and no write of it moves below the wgmma that reads it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x 64, f32) (+)= A · B, A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                              int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(accumulate));
}

template <int N>
__device__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db);

// D (64 x 32, f32) += A · B, A (64 x 16 bf16) in registers, B MN-major in shared memory.
template <> __device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4],
                                                     uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64, f32) += A · B, A (64 x 16 bf16) in registers, B MN-major in shared memory.
template <> __device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4],
                                                     uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 96, f32) += A · B, A (64 x 16 bf16) in registers, B MN-major in shared memory.
template <> __device__ __forceinline__ void wgmma_rs<96>(float (&d)[48], const uint32_t (&a)[4],
                                                     uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, f32) += A · B, A (64 x 16 bf16) in registers, B MN-major in shared memory.
template <> __device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4],
                                                     uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Rows [row0, row0 + 64) of one (b, h) slice into a swizzled tile, by
// cp.async; rows at or past S and columns at or past D are zero-filled.
template <int DP>
__device__ __forceinline__ void load_tile_async(uint32_t tile, const __nv_bfloat16* base,
                                                long long stride_s, int row0, int S, int D) {
    constexpr int kChunks = DP / 8;  // 16-byte chunks a row
#pragma unroll
    for (int i = 0; i < kTile * kChunks / kWgThreads; ++i) {
        const int idx = threadIdx.x + i * kWgThreads;
        const int r = idx / kChunks, c = idx - r * kChunks;
        const bool ok = row0 + r < S && c * 8 < D;
        const __nv_bfloat16* src = ok ? base + (long long)(row0 + r) * stride_s + c * 8 : base;
        cp_async16(tile + chunk_offset(r, c), src, ok);
    }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// A 64 x 64 f32 accumulator rounded to bf16 as the register A operands of
// four k-steps (columns 16kk..16kk+15): the accumulator's fragment layout
// is the A operand's, n8 blocks 2kk and 2kk+1.
__device__ __forceinline__ void to_a_operand(uint32_t (&a)[4][4], const float (&x)[32]) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) a[kk][i] = pack_bf16(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1]);
}

// Fragment layout of a 64 x N wgmma accumulator: thread (warp w, lane l)
// holds element i at row 16w + l/4 + 8((i >> 1) & 1), column
// 8(i >> 2) + 2(l % 4) + (i & 1).
__device__ __forceinline__ int frag_half(int i) { return (i >> 1) & 1; }
__device__ __forceinline__ int frag_col(int i, int lane) {
    return 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
}

template <int DP>
__global__ void __launch_bounds__(kWgThreads)
flash_fwd_kernel_wgmma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                       float* __restrict__ lse, Strides sq, Strides sk, Strides sv, Strides so,
                       int S, int H, int D, int causal, float scale) {
    constexpr int kTileBytes = kTile * DP * 2;
    constexpr int NO = DP / 2;  // accumulator floats a thread holds of a 64 x DP tile
    extern __shared__ __align__(1024) unsigned char tc_smem[];
    // the Q tile, then per stage st a K tile (tile 1 + 2 st) and a V tile
    const uint32_t sQ = (smem_addr(tc_smem) + 1023u) & ~1023u;

    const int qt = gridDim.x - 1 - blockIdx.x;  // the longest causal rows first
    const int h = blockIdx.y, b = blockIdx.z;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int q0 = qt * kTile;
    const int r = 16 * warp + (lane >> 2);  // this thread's rows: r and r + 8
    const __nv_bfloat16* kb = k + b * sk.b + h * sk.h;
    const __nv_bfloat16* vb = v + b * sv.b + h * sv.h;
    const int n_kt = causal ? qt + 1 : (S + kTile - 1) / kTile;

    load_tile_async<DP>(sQ, q + b * sq.b + h * sq.h, sq.s, q0, S, D);
    load_tile_async<DP>(sQ + kTileBytes, kb, sk.s, 0, S, D);
    load_tile_async<DP>(sQ + 2 * kTileBytes, vb, sv.s, 0, S, D);
    cp_async_commit();

    const float sl2 = scale * kLog2e;  // scores in log2 units
    float acc[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) acc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // l: this thread's part

    for (int kt = 0; kt < n_kt; ++kt) {
        const uint32_t tK = sQ + (1 + 2 * (kt & 1)) * kTileBytes, tV = tK + kTileBytes;
        if (kt + 1 < n_kt) {  // the next K/V tile into the other stage
            const uint32_t nK = sQ + (1 + 2 * ((kt + 1) & 1)) * kTileBytes;
            load_tile_async<DP>(nK, kb, sk.s, (kt + 1) * kTile, S, D);
            load_tile_async<DP>(nK + kTileBytes, vb, sv.s, (kt + 1) * kTile, S, D);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        fence_async_smem();
        __syncthreads();

        float s[32] = {};
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
            wgmma_ss_n64(s, desc_k(sQ, kk), desc_k(tK, kk), kk > 0);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(s);

        const int k0 = kt * kTile;
        const bool edge = (causal && kt == qt) || k0 + kTile > S;
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int i = 0; i < 32; ++i) {
            const int row = q0 + r + 8 * frag_half(i), col = k0 + frag_col(i, lane);
            float x = s[i] * sl2;
            // rows past S keep their unmasked columns: never written
            if (edge && (col >= S || (causal && col > row))) x = -INFINITY;
            s[i] = x;
            mx[frag_half(i)] = fmaxf(mx[frag_half(i)], x);
        }
        float alpha[2], m_use[2];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {  // a row's 16 values sit in a quad of lanes
            mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
            mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
            const float m_new = fmaxf(m[hf], mx[hf]);
            m_use[hf] = m_new == -INFINITY ? 0.f : m_new;
            alpha[hf] = exp2f(m[hf] - m_use[hf]);
            m[hf] = m_new;
            l[hf] *= alpha[hf];
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) {
            s[i] = exp2f(s[i] - m_use[frag_half(i)]);
            l[frag_half(i)] += s[i];
        }
#pragma unroll
        for (int i = 0; i < NO; ++i) acc[i] *= alpha[frag_half(i)];
        uint32_t pa[4][4];
        to_a_operand(pa, s);

        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs<DP>(acc, pa[kk], desc_mn(tV, kk));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
        __syncthreads();  // every wgmma read of this stage is done before it is refilled
    }

#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
        l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 1);
        l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 2);
    }
    float* lse_bh = lse + ((long long)b * H + h) * S;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
        const int row = q0 + r + 8 * hf;
        if (row >= S) continue;
        const float inv = 1.f / l[hf];
        __nv_bfloat16* orow = o + b * so.b + (long long)row * so.s + h * so.h + 2 * (lane & 3);
#pragma unroll
        for (int j = 0; j < DP / 8; ++j)
            if (8 * j < D)
                *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) = __floats2bfloat162_rn(
                    acc[4 * j + 2 * hf] * inv, acc[4 * j + 2 * hf + 1] * inv);
        if ((lane & 3) == 0) lse_bh[row] = (m[hf] + log2f(l[hf])) * kLn2;
    }
}

template <int DP>
__global__ void __launch_bounds__(kWgThreads)
flash_bwd_dkv_kernel_wgmma(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                           const float* __restrict__ di, __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, Strides sq, Strides sk, Strides sv,
                           Strides sdo, Strides sdk, Strides sdv, int S, int H, int D,
                           int causal, float scale) {
    constexpr int kTileBytes = kTile * DP * 2;
    constexpr int NO = DP / 2;
    extern __shared__ __align__(1024) unsigned char tc_smem[];
    // K, V; per stage st a Q tile (tile 2 + 2 st) and a dO tile; then per
    // stage 128 f32 row values: the Q tile's 64 lse, then its 64 Di
    const uint32_t sK = (smem_addr(tc_smem) + 1023u) & ~1023u;
    const uint32_t sV = sK + kTileBytes;
    const uint32_t sRows = sK + 6 * kTileBytes;
    const float* rows = reinterpret_cast<const float*>(tc_smem + (sRows - smem_addr(tc_smem)));

    const int kt = blockIdx.x;  // causal: the longest loops first
    const int h = blockIdx.y, b = blockIdx.z;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int k0 = kt * kTile;
    const int r = 16 * warp + (lane >> 2);  // this thread's keys: k0 + r and k0 + r + 8
    const __nv_bfloat16* qb = q + b * sq.b + h * sq.h;
    const __nv_bfloat16* dob = dout + b * sdo.b + h * sdo.h;
    // this thread copies one lse (threads 0-63) or Di (64-127) value a Q tile
    const float* row_src = (threadIdx.x < 64 ? lse : di) + ((long long)b * H + h) * S;
    const int row_t = threadIdx.x & 63;
    const int n_qt = (S + kTile - 1) / kTile;
    const int qt0 = causal ? kt : 0;

    auto load_stage = [&](int qt, int st) {
        const uint32_t tQ = sK + (2 + 2 * st) * kTileBytes;
        load_tile_async<DP>(tQ, qb, sq.s, qt * kTile, S, D);
        load_tile_async<DP>(tQ + kTileBytes, dob, sdo.s, qt * kTile, S, D);
        const bool ok = qt * kTile + row_t < S;
        cp_async4(sRows + (st * kWgThreads + threadIdx.x) * 4,
                  ok ? row_src + qt * kTile + row_t : row_src, ok);
    };
    load_tile_async<DP>(sK, k + b * sk.b + h * sk.h, sk.s, k0, S, D);
    load_tile_async<DP>(sV, v + b * sv.b + h * sv.h, sv.s, k0, S, D);
    load_stage(qt0, 0);
    cp_async_commit();

    const float sl2 = scale * kLog2e;
    float dk_acc[NO], dv_acc[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    for (int qt = qt0; qt < n_qt; ++qt) {
        const int st = (qt - qt0) & 1;
        if (qt + 1 < n_qt) {
            load_stage(qt + 1, st ^ 1);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        fence_async_smem();
        __syncthreads();
        const uint32_t tQ = sK + (2 + 2 * st) * kTileBytes, tdO = tQ + kTileBytes;
        const float* L = rows + st * kWgThreads;  // lse of the tile's queries
        const float* Dq = L + 64;                 // Di of the tile's queries

        // S^T = K Q^T and dP^T = V dO^T: rows are keys, columns queries
        float s[32] = {}, dp[32] = {};
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
            wgmma_ss_n64(s, desc_k(sK, kk), desc_k(tQ, kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
            wgmma_ss_n64(dp, desc_k(sV, kk), desc_k(tdO, kk), kk > 0);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(s);
        fence_regs(dp);

        const int q0 = qt * kTile;
        const bool edge = (causal && qt == kt) || q0 + kTile > S;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
            const int n = frag_col(i, lane), key = k0 + r + 8 * frag_half(i);
            float p = exp2f(fmaf(s[i], sl2, -L[n] * kLog2e));
            if (edge && (q0 + n >= S || (causal && key > q0 + n))) p = 0.f;
            s[i] = p;                      // P^T
            dp[i] = p * (dp[i] - Dq[n]);   // dS^T
        }
        uint32_t pa[4][4], dsa[4][4];
        to_a_operand(pa, s);
        to_a_operand(dsa, dp);

        fence_regs(dv_acc);
        fence_regs(dk_acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs<DP>(dv_acc, pa[kk], desc_mn(tdO, kk));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs<DP>(dk_acc, dsa[kk], desc_mn(tQ, kk));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(dv_acc);
        fence_regs(dk_acc);
        __syncthreads();  // every wgmma read of this stage is done before it is refilled
    }

#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
        const int key = k0 + r + 8 * hf;
        if (key >= S) continue;
        __nv_bfloat16* dkrow = dk + b * sdk.b + (long long)key * sdk.s + h * sdk.h + 2 * (lane & 3);
        __nv_bfloat16* dvrow = dv + b * sdv.b + (long long)key * sdv.s + h * sdv.h + 2 * (lane & 3);
#pragma unroll
        for (int j = 0; j < DP / 8; ++j) {
            if (8 * j >= D) continue;
            const int i = 4 * j + 2 * hf;
            *reinterpret_cast<__nv_bfloat162*>(dkrow + 8 * j) =
                __floats2bfloat162_rn(dk_acc[i] * scale, dk_acc[i + 1] * scale);
            *reinterpret_cast<__nv_bfloat162*>(dvrow + 8 * j) =
                __floats2bfloat162_rn(dv_acc[i], dv_acc[i + 1]);
        }
    }
}

template <int DP>
__global__ void __launch_bounds__(kWgThreads)
flash_bwd_dq_kernel_wgmma(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                          const float* __restrict__ di, __nv_bfloat16* __restrict__ dq,
                          Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdq, int S,
                          int H, int D, int causal, float scale) {
    constexpr int kTileBytes = kTile * DP * 2;
    constexpr int NO = DP / 2;
    extern __shared__ __align__(1024) unsigned char tc_smem[];
    // Q, dO, then per stage st a K tile (tile 2 + 2 st) and a V tile
    const uint32_t sQ = (smem_addr(tc_smem) + 1023u) & ~1023u;
    const uint32_t sdO = sQ + kTileBytes;

    const int qt = gridDim.x - 1 - blockIdx.x;  // the longest causal rows first
    const int h = blockIdx.y, b = blockIdx.z;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int q0 = qt * kTile;
    const int r = 16 * warp + (lane >> 2);  // this thread's rows: r and r + 8
    const __nv_bfloat16* kb = k + b * sk.b + h * sk.h;
    const __nv_bfloat16* vb = v + b * sv.b + h * sv.h;
    const int n_kt = causal ? qt + 1 : (S + kTile - 1) / kTile;

    load_tile_async<DP>(sQ, q + b * sq.b + h * sq.h, sq.s, q0, S, D);
    load_tile_async<DP>(sdO, dout + b * sdo.b + h * sdo.h, sdo.s, q0, S, D);
    load_tile_async<DP>(sQ + 2 * kTileBytes, kb, sk.s, 0, S, D);
    load_tile_async<DP>(sQ + 3 * kTileBytes, vb, sv.s, 0, S, D);
    cp_async_commit();

    // -lse in log2 units and Di of this thread's two rows (0 past S)
    const long long bh = ((long long)b * H + h) * S;
    float nl[2], dr[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
        const int row = q0 + r + 8 * hf;
        nl[hf] = row < S ? -lse[bh + row] * kLog2e : 0.f;
        dr[hf] = row < S ? di[bh + row] : 0.f;
    }

    const float sl2 = scale * kLog2e;
    float dq_acc[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) dq_acc[i] = 0.f;

    for (int kt = 0; kt < n_kt; ++kt) {
        const uint32_t tK = sQ + (2 + 2 * (kt & 1)) * kTileBytes, tV = tK + kTileBytes;
        if (kt + 1 < n_kt) {  // the next K/V tile into the other stage
            const uint32_t nK = sQ + (2 + 2 * ((kt + 1) & 1)) * kTileBytes;
            load_tile_async<DP>(nK, kb, sk.s, (kt + 1) * kTile, S, D);
            load_tile_async<DP>(nK + kTileBytes, vb, sv.s, (kt + 1) * kTile, S, D);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        fence_async_smem();
        __syncthreads();

        // S = Q K^T and dP = dO V^T: rows are queries, columns keys
        float s[32] = {}, dp[32] = {};
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
            wgmma_ss_n64(s, desc_k(sQ, kk), desc_k(tK, kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
            wgmma_ss_n64(dp, desc_k(sdO, kk), desc_k(tV, kk), kk > 0);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(s);
        fence_regs(dp);

        const int k0 = kt * kTile;
        const bool edge = (causal && kt == qt) || k0 + kTile > S;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
            const int hf = frag_half(i), row = q0 + r + 8 * hf, col = k0 + frag_col(i, lane);
            float p = exp2f(fmaf(s[i], sl2, nl[hf]));
            if (edge && (col >= S || (causal && col > row))) p = 0.f;
            s[i] = p * (dp[i] - dr[hf]);  // dS
        }
        uint32_t dsa[4][4];
        to_a_operand(dsa, s);

        fence_regs(dq_acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs<DP>(dq_acc, dsa[kk], desc_mn(tK, kk));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(dq_acc);
        __syncthreads();  // every wgmma read of this stage is done before it is refilled
    }

#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
        const int row = q0 + r + 8 * hf;
        if (row >= S) continue;
        __nv_bfloat16* dqrow = dq + b * sdq.b + (long long)row * sdq.s + h * sdq.h + 2 * (lane & 3);
#pragma unroll
        for (int j = 0; j < DP / 8; ++j)
            if (8 * j < D)
                *reinterpret_cast<__nv_bfloat162*>(dqrow + 8 * j) = __floats2bfloat162_rn(
                    dq_acc[4 * j + 2 * hf] * scale, dq_acc[4 * j + 2 * hf + 1] * scale);
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
// tensor-core kernels: bf16 tiles (Q + two K/V stages; K, V + two Q/dO
// stages and their lse/Di rows; Q, dO + two K/V stages), plus slack to
// align the first to 1024 bytes
template <int DP> constexpr size_t fwd_wgmma_smem() { return 5 * kTile * DP * 2 + 1024; }
template <int DP> constexpr size_t dkv_wgmma_smem() {
    return 6 * kTile * DP * 2 + 2 * kWgThreads * sizeof(float) + 1024;
}
template <int DP> constexpr size_t dq_wgmma_smem() { return 6 * kTile * DP * 2 + 1024; }

// A kernel's launch with its dynamic shared memory; above 48 KB the
// kernel has to be allowed that much first.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int threads, size_t smem, dim3 grid, cudaStream_t stream,
           Args... args) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, threads, smem, stream>>>(args...);
    return (int)cudaGetLastError();
}

Strides strides_at(const long long* s, int i) { return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]}; }

dim3 grid_of(int B, int S, int H) { return dim3((unsigned)((S + kTile - 1) / kTile), H, B); }

// The tensor-core kernels copy rows in 16-byte pieces: every tensor's
// pointer 16-byte aligned and its (b, s, h) strides multiples of 8 elements.
bool aligned_rows(std::initializer_list<const void*> ptrs, const long long* st, int n) {
    for (const void* p : ptrs)
        if (reinterpret_cast<uintptr_t>(p) % 16) return false;
    for (int i = 0; i < 3 * n; ++i)
        if (st[i] % 8) return false;
    return true;
}

template <typename T>
constexpr bool kTensorCores = std::is_same<T, __nv_bfloat16>::value;

template <typename T, int DP>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse, const long long* st,
        int B, int S, int H, int D, int causal, float scale, cudaStream_t stream) {
    if constexpr (kTensorCores<T>) {
        if (!aligned_rows({q, k, v, o}, st, 4)) return (int)cudaErrorMisalignedAddress;
        return launch(flash_fwd_kernel_wgmma<DP>, kWgThreads, fwd_wgmma_smem<DP>(),
                      grid_of(B, S, H), stream, (const T*)q, (const T*)k, (const T*)v, (T*)o,
                      (float*)lse, strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
                      strides_at(st, 3), S, H, D, causal, scale);
    } else {
        return launch(flash_fwd_kernel<DP>, kThreads, fwd_smem<DP>(), grid_of(B, S, H),
                      stream, (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse,
                      strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
                      strides_at(st, 3), S, H, D, causal, scale);
    }
}

template <typename T, int DP>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
            const void* di, void* dk, void* dv, const long long* st, int B, int S, int H,
            int D, int causal, float scale, cudaStream_t stream) {
    if constexpr (kTensorCores<T>) {
        if (!aligned_rows({q, k, v, dout, dk, dv}, st, 6)) return (int)cudaErrorMisalignedAddress;
        return launch(flash_bwd_dkv_kernel_wgmma<DP>, kWgThreads, dkv_wgmma_smem<DP>(),
                      grid_of(B, S, H), stream, (const T*)q, (const T*)k, (const T*)v,
                      (const T*)dout, (const float*)lse, (const float*)di, (T*)dk, (T*)dv,
                      strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
                      strides_at(st, 3), strides_at(st, 4), strides_at(st, 5), S, H, D,
                      causal, scale);
    } else {
        return launch(flash_bwd_dkv_kernel<DP>, kThreads, dkv_smem<DP>(), grid_of(B, S, H),
                      stream, (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
                      (const float*)lse, (const float*)di, (T*)dk, (T*)dv, strides_at(st, 0),
                      strides_at(st, 1), strides_at(st, 2), strides_at(st, 3),
                      strides_at(st, 4), strides_at(st, 5), S, H, D, causal, scale);
    }
}

template <typename T, int DP>
int bwd_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
           const void* di, void* dq, const long long* st, int B, int S, int H, int D,
           int causal, float scale, cudaStream_t stream) {
    if constexpr (kTensorCores<T>) {
        if (!aligned_rows({q, k, v, dout, dq}, st, 5)) return (int)cudaErrorMisalignedAddress;
        return launch(flash_bwd_dq_kernel_wgmma<DP>, kWgThreads, dq_wgmma_smem<DP>(),
                      grid_of(B, S, H), stream, (const T*)q, (const T*)k, (const T*)v,
                      (const T*)dout, (const float*)lse, (const float*)di, (T*)dq,
                      strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
                      strides_at(st, 3), strides_at(st, 4), S, H, D, causal, scale);
    } else {
        return launch(flash_bwd_dq_kernel<DP>, kThreads, dq_smem<DP>(), grid_of(B, S, H),
                      stream, (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
                      (const float*)lse, (const float*)di, (T*)dq, strides_at(st, 0),
                      strides_at(st, 1), strides_at(st, 2), strides_at(st, 3),
                      strides_at(st, 4), S, H, D, causal, scale);
    }
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
