// uint8 NHWC image normalization for Hopper (sm_90a).
//
// Replaces petastorm_tpu/ops/normalize.py::_norm_kernel, the Pallas TPU
// kernel behind normalize_images: y = x * scale[c] + bias[c] computed in
// f32, with scale = 1/(255*std) and bias = -mean/std precomputed by the
// caller, then converted to the output type (bf16 or f32). No f32 image is
// written to device memory.
//
// Bound: device-memory bytes. The kernel reads each input byte once and
// writes each output element once, N*H*W*C*(1 + out_bytes) bytes in all:
// at (256,224,224,3) with bf16 output that is 115.6 MB, 34.5 us at the
// H100 SXM's 3.35 TB/s. One FMA per byte is far below the card's
// operations-per-byte balance. So the design only keeps the traffic in
// wide, coalesced transactions: a flat grid-stride loop over N*H*W*C
// elements in which each thread loads 16 input bytes as one uint4 and
// stores them as two 16-byte bf16 vectors (or four float4). The channel
// of element i is i % C; scale and bias sit in shared memory. A ragged
// tail, and a base pointer that is not 16-byte aligned, take a scalar
// loop.
//
// C interface (bound with ctypes): pt_normalize_u8 returns
// cudaGetLastError() after the launch; the wrapper raises if it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define PT_MAX_CHANNELS 4

struct Affine {
    float scale[PT_MAX_CHANNELS];
    float bias[PT_MAX_CHANNELS];
};

__device__ __forceinline__ void store1(float* y, long long i, float v) { y[i] = v; }

__device__ __forceinline__ void store1(__nv_bfloat16* y, long long i, float v) {
    y[i] = __float2bfloat16_rn(v);
}

// 16 outputs from one 16-byte input vector, written as 16-byte stores.
__device__ __forceinline__ void store16(float* y, long long base, const float* v) {
    float4* dst = reinterpret_cast<float4*>(y + base);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        dst[k] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
    }
}

__device__ __forceinline__ void store16(__nv_bfloat16* y, long long base, const float* v) {
    uint4* dst = reinterpret_cast<uint4*>(y + base);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
        __nv_bfloat162 p0 = __floats2bfloat162_rn(v[8 * k + 0], v[8 * k + 1]);
        __nv_bfloat162 p1 = __floats2bfloat162_rn(v[8 * k + 2], v[8 * k + 3]);
        __nv_bfloat162 p2 = __floats2bfloat162_rn(v[8 * k + 4], v[8 * k + 5]);
        __nv_bfloat162 p3 = __floats2bfloat162_rn(v[8 * k + 6], v[8 * k + 7]);
        uint4 packed;
        packed.x = *reinterpret_cast<uint32_t*>(&p0);
        packed.y = *reinterpret_cast<uint32_t*>(&p1);
        packed.z = *reinterpret_cast<uint32_t*>(&p2);
        packed.w = *reinterpret_cast<uint32_t*>(&p3);
        dst[k] = packed;
    }
}

template <typename OutT, bool kVector>
__global__ void normalize_u8_kernel(const uint8_t* __restrict__ x,
                                    OutT* __restrict__ y, long long n, int c,
                                    Affine affine) {
    __shared__ float s_scale[PT_MAX_CHANNELS];
    __shared__ float s_bias[PT_MAX_CHANNELS];
    if (threadIdx.x < PT_MAX_CHANNELS) {
        s_scale[threadIdx.x] = affine.scale[threadIdx.x];
        s_bias[threadIdx.x] = affine.bias[threadIdx.x];
    }
    __syncthreads();

    const long long stride = (long long)gridDim.x * blockDim.x;
    const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    long long scalar_from = 0;
    if (kVector) {
        const long long n_vec = n / 16;
        const uint4* xv = reinterpret_cast<const uint4*>(x);
        for (long long v = tid; v < n_vec; v += stride) {
            uint4 q = xv[v];
            const uint8_t* bytes = reinterpret_cast<const uint8_t*>(&q);
            const long long base = v * 16;
            int ch = (int)(base % c);
            float out[16];
#pragma unroll
            for (int k = 0; k < 16; ++k) {
                out[k] = fmaf((float)bytes[k], s_scale[ch], s_bias[ch]);
                ch = (ch + 1 == c) ? 0 : ch + 1;
            }
            store16(y, base, out);
        }
        scalar_from = n_vec * 16;
    }
    for (long long i = scalar_from + tid; i < n; i += stride) {
        const int ch = (int)(i % c);
        store1(y, i, fmaf((float)x[i], s_scale[ch], s_bias[ch]));
    }
}

template <typename OutT>
static void launch(const uint8_t* x, OutT* y, long long n, int c,
                   const Affine& affine, cudaStream_t stream) {
    const int threads = 256;
    const bool vector = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                        (reinterpret_cast<uintptr_t>(y) % 16 == 0) && n >= 16;
    const long long work = vector ? (n + 15) / 16 : n;
    long long blocks = (work + threads - 1) / threads;
    // a grid-stride loop: more than a few waves of blocks buys nothing
    if (blocks > 132 * 32) blocks = 132 * 32;
    if (vector) {
        normalize_u8_kernel<OutT, true><<<(unsigned)blocks, threads, 0, stream>>>(
            x, y, n, c, affine);
    } else {
        normalize_u8_kernel<OutT, false><<<(unsigned)blocks, threads, 0, stream>>>(
            x, y, n, c, affine);
    }
}

// out_kind: 0 = float32, 1 = bfloat16. scale and bias are host arrays of
// c floats. Returns a cudaError_t: 0 on a successful launch.
extern "C" int pt_normalize_u8(const void* x, void* y, long long n, int c,
                               const float* scale, const float* bias,
                               int out_kind, void* stream) {
    if (c < 1 || c > PT_MAX_CHANNELS || n < 0 || (out_kind != 0 && out_kind != 1)) {
        return (int)cudaErrorInvalidValue;
    }
    if (n == 0) {
        return 0;
    }
    Affine affine;
    for (int k = 0; k < PT_MAX_CHANNELS; ++k) {
        affine.scale[k] = k < c ? scale[k] : 0.0f;
        affine.bias[k] = k < c ? bias[k] : 0.0f;
    }
    const uint8_t* xs = static_cast<const uint8_t*>(x);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (out_kind == 0) {
        launch(xs, static_cast<float*>(y), n, c, affine, s);
    } else {
        launch(xs, static_cast<__nv_bfloat16*>(y), n, c, affine, s);
    }
    return (int)cudaGetLastError();
}
