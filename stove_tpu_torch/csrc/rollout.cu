// Fused whole-horizon STOVE dynamics rollout for Hopper (sm_90a).
//
// Replaces: stove_tpu/ops/pallas_rollout.py::rollout_states (the Pallas
// kernel body _make_kernel, its graph-net core dyn_tile_core, Euler
// integration integrate_mean, and the in-kernel Box-Muller noise of
// _normals/_bits_to_normal_pairs).  Same contract: z0 (B, O, 6+cl) f32 in,
// states (B, H, O, 6+cl) f32 out, mean or sampled, all H steps in one
// launch; state and every activation stay on chip, device memory sees z0
// in and the trajectory out.
//
// Bound on this card.  One frame (one sample, one step, all O objects)
// costs ~613.6k multiply-adds at O=3, h=128, cl=16 (6 ordered pairs), and
// the bytes are only z0 + the trajectory (264 B per frame), so the work
// is compute bound: at B=16384, H=92 it is 1.85 TFLOP against ~0.4 GB of
// traffic.  This kernel computes in f32 on the CUDA cores (67 TFLOP/s
// peak), which keeps the mean path within 1e-4 of the plain PyTorch
// version; the bf16 tensor-core bound (989 TFLOP/s) is what a later
// wgmma version could approach.
//
// Design.  The TPU kernel kept all weights resident in VMEM; here the f32
// weights (172,839 parameters, 691 KB) are far above a block's 227 KB of
// shared memory, so they stay in global memory (L2 holds them all) and
// each layer streams through a 32 KB shared staging buffer one chunk of
// rows at a time, the next chunk in flight in registers while the current
// one is used.  Each block thus reads every weight once per step; letting
// the 8 warps read weights through L1 instead was 1.35x slower, and
// halving the tile (TB, samples per block) is 1.4x slower, since the
// weight traffic and the fixed costs per frame grow as 1/TB.  A block owns TB samples for the whole
// horizon (a loop over H inside the block replaces the TPU's sequential
// fori_loop).  Activations live in shared memory feature-major,
// X[k * ld + m], with m running over (object, sample) rows -- or over
// (ordered pair, sample) rows for the relational MLP -- which is the TPU's
// lane-stacked layout.  Every layer is one block-wide matmul
// Y = act(X @ W + b): each thread owns a TM x 4 register tile (4 adjacent
// output features, TM adjacent rows); a warp covers 32 features x 4 row
// groups, so per k it reads one 128 B wavefront of weights and four row
// slices of X; sums run in f32 in k order.  The receiver/sender split of
// the first relational layer is one N=2h matmul; pair activations
// relu(recv_o + send_j + b) are then formed for the O(O-1) ordered pairs
// (the diagonal skipped, as the mask in dynamics.py does) and the
// attention-gated pair sum is reduced per receiver.  The first output
// layer contracts [s | r] with K=2h, i.e. its self and relational halves
// stacked.  Noise: Philox4x32-10 keyed by a seed the wrapper draws from the
// caller's torch.Generator, counter (chunk, step, sample, object), both
// Box-Muller branches.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef STOVE_O
#define STOVE_O 3
#endif
#ifndef STOVE_CL
#define STOVE_CL 16
#endif
#ifndef STOVE_H
#define STOVE_H 128
#endif
#ifndef STOVE_TB
#define STOVE_TB 16
#endif

namespace {

constexpr int O = STOVE_O;          // objects
constexpr int CL = STOVE_CL;        // latent width per object
constexpr int HID = STOVE_H;        // graph-net width
constexpr int TB = STOVE_TB;        // samples per block
constexpr int NT = 256;             // threads per block
constexpr int D = 6 + CL;           // state rows per object
constexpr int DOUT = 6 + 2 * CL;    // dv(2) + dl(cl) + raw std(4 + cl)
constexpr int DOUTP = (DOUT + 63) / 64 * 64;  // padded output width
constexpr int NPAIR = O * (O - 1);
constexpr int M = O * TB;           // (object, sample) rows
constexpr int MP = NPAIR * TB;      // (pair, sample) rows
constexpr int LDO = M + 4;          // padded leading dims (store conflicts)
constexpr int LDP = MP + 4;

static_assert(HID % 32 == 0 && M % 4 == 0, "widths must be multiples of 32 and 4");
static_assert(DOUTP <= HID && D <= HID, "output rows must fit a hidden buffer");

// ---- packed parameter layout (floats); the order and sizes match
// stove_tpu_torch/ops/fused_rollout.py::param_layout exactly.
constexpr int OFF_WE0 = 0;
constexpr int OFF_BE0 = OFF_WE0 + D * HID;
constexpr int OFF_WE1 = OFF_BE0 + HID;
constexpr int OFF_BE1 = OFF_WE1 + HID * HID;
constexpr int OFF_WS0 = OFF_BE1 + HID;
constexpr int OFF_BS0 = OFF_WS0 + HID * HID;
constexpr int OFF_WS1 = OFF_BS0 + HID;
constexpr int OFF_BS1 = OFF_WS1 + HID * HID;
constexpr int OFF_WRS = OFF_BS1 + HID;          // [W_recv | W_send] (h, 2h)
constexpr int OFF_BR0 = OFF_WRS + HID * 2 * HID;
constexpr int OFF_WR1 = OFF_BR0 + HID;
constexpr int OFF_BR1 = OFF_WR1 + HID * HID;
constexpr int OFF_WRF = OFF_BR1 + HID;          // rel features (h, h)
constexpr int OFF_BRF = OFF_WRF + HID * HID;
constexpr int OFF_WRA = OFF_BRF + HID;          // rel attention column (h)
constexpr int OFF_BRA = OFF_WRA + HID;          // (4; one used)
constexpr int OFF_WO0 = OFF_BRA + 4;            // [W_o0s ; W_o0r] (2h, h)
constexpr int OFF_BO0 = OFF_WO0 + 2 * HID * HID;
constexpr int OFF_WO1 = OFF_BO0 + HID;
constexpr int OFF_BO1 = OFF_WO1 + HID * HID;
constexpr int OFF_WO2 = OFF_BO1 + HID;          // (h, DOUTP), zero padded
constexpr int OFF_BO2 = OFF_WO2 + HID * DOUTP;
constexpr int N_PARAMS = OFF_BO2 + DOUTP;

// ---- shared memory layout (floats)
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }
constexpr int ZS_SIZE = D * LDO;                          // state
constexpr int AE_SIZE = cmax(2 * HID * LDO, HID * LDP);   // two (h, M) or one (h, MP)
constexpr int SR_SIZE = 2 * HID * LDO;                    // [s ; r]
constexpr int P2_SIZE = cmax(2 * HID * LDO, HID * LDP);   // [recv ; send] or pair
constexpr int LG_SIZE = (MP + 3) / 4 * 4;                 // pair attention
constexpr int WS_FLOATS = 8192;                           // weight chunk (32 KB)
constexpr int SMEM_FLOATS = ZS_SIZE + AE_SIZE + SR_SIZE + P2_SIZE + LG_SIZE + WS_FLOATS;
constexpr size_t SMEM_BYTES = sizeof(float) * SMEM_FLOATS;
static_assert(SMEM_BYTES <= 232448, "shared memory above the 227 KB a block can use");

// Rows per thread for an (Mrows x N) output: the smallest divisor of Mrows
// that lets N/4 * Mrows/TM threads cover the tile with NT threads.
__host__ __device__ constexpr int pick_tm(int mrows, int cg) {
    int tm = (mrows * cg + NT - 1) / NT;
    if (tm < 1) tm = 1;
    while (mrows % tm) ++tm;
    return tm;
}

// Y[n, m] = act(sum_k X[k, m] * W[k, n] + b[n]) for m < MR, n < N.
// X, Y in shared memory, feature-major with leading dims ldx, ldy; W in
// global memory (K, N) row-major ((in, out), as the checkpoint stores it).
// W streams through the shared staging buffer WS in chunks of KC rows: the
// block loads each weight once per step (the next chunk is in flight in
// registers while the current one is used), instead of every warp
// re-reading it through L1.  Every thread of the block must call this;
// the caller synchronises before Y is read.
template <int MR, int N, int K, bool RELU>
__device__ __forceinline__ void gemm(const float* __restrict__ X, int ldx,
                                     const float* __restrict__ W,
                                     const float* __restrict__ bias,
                                     float* __restrict__ Y, int ldy,
                                     float* __restrict__ WS) {
    constexpr int CG = N / 4;
    static_assert(N % 32 == 0 && CG <= NT, "N must be a multiple of 32, <= 4*NT");
    constexpr int TM = pick_tm(MR, CG);
    constexpr int RG = MR / TM;
    static_assert(RG * CG <= NT && RG % 4 == 0, "tile does not fit the block");
    constexpr int KC = K * N <= WS_FLOATS ? K : WS_FLOATS / N;  // rows per chunk
    static_assert(K % KC == 0, "K must be a multiple of the chunk rows");
    constexpr int NCHUNK = K / KC;
    constexpr int C4 = KC * N / 4;                  // float4 per chunk
    constexpr int PF = (C4 + NT - 1) / NT;          // float4 per thread per chunk
    // A warp covers 32 columns x 4 row groups (8 x 4 lanes): per k it reads
    // 128 B of W (one shared-memory wavefront, broadcast across its row
    // groups) and 4 distinct row slices of X.
    const int tid = threadIdx.x;
    const bool active = tid < RG * CG;
    const int warp = tid / 32, lane = tid % 32;
    const int n0 = (warp % (N / 32)) * 32 + (lane % 8) * 4;
    const int m0 = ((warp / (N / 32)) * 4 + lane / 8) * TM;
    const float4* W4 = reinterpret_cast<const float4*>(W);
    float4* WS4 = reinterpret_cast<float4*>(WS);

    float4 pre[PF];
#pragma unroll
    for (int q = 0; q < PF; ++q) {
        const int i = tid + q * NT;
        if (i < C4) pre[q] = __ldg(W4 + i);
    }
    float acc[TM][4];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    }
    for (int c = 0; c < NCHUNK; ++c) {
        __syncthreads();                    // WS is free: the last chunk is used
#pragma unroll
        for (int q = 0; q < PF; ++q) {
            const int i = tid + q * NT;
            if (i < C4) WS4[i] = pre[q];
        }
        __syncthreads();
        if (c + 1 < NCHUNK) {
#pragma unroll
            for (int q = 0; q < PF; ++q) {
                const int i = tid + q * NT;
                if (i < C4) pre[q] = __ldg(W4 + (size_t)(c + 1) * C4 + i);
            }
        }
        if (active) {
            const float* xc = X + m0 + c * KC * ldx;
#pragma unroll 8
            for (int k = 0; k < KC; ++k) {
                const float4 w = *reinterpret_cast<const float4*>(WS + k * N + n0);
                float xv[TM];
                const float* xk = xc + k * ldx;
                if constexpr (TM % 4 == 0) {
#pragma unroll
                    for (int i = 0; i < TM; i += 4) {
                        const float4 v = *reinterpret_cast<const float4*>(xk + i);
                        xv[i] = v.x; xv[i + 1] = v.y; xv[i + 2] = v.z; xv[i + 3] = v.w;
                    }
                } else if constexpr (TM % 2 == 0) {
#pragma unroll
                    for (int i = 0; i < TM; i += 2) {
                        const float2 v = *reinterpret_cast<const float2*>(xk + i);
                        xv[i] = v.x; xv[i + 1] = v.y;
                    }
                } else {
#pragma unroll
                    for (int i = 0; i < TM; ++i) xv[i] = xk[i];
                }
#pragma unroll
                for (int i = 0; i < TM; ++i) {
                    acc[i][0] = fmaf(xv[i], w.x, acc[i][0]);
                    acc[i][1] = fmaf(xv[i], w.y, acc[i][1]);
                    acc[i][2] = fmaf(xv[i], w.z, acc[i][2]);
                    acc[i][3] = fmaf(xv[i], w.w, acc[i][3]);
                }
            }
        }
    }
    if (!active) return;
    float bj[4] = {0.f, 0.f, 0.f, 0.f};
    if (bias != nullptr) {
        const float4 b = __ldg(reinterpret_cast<const float4*>(bias + n0));
        bj[0] = b.x; bj[1] = b.y; bj[2] = b.z; bj[3] = b.w;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        float* yp = Y + (n0 + j) * ldy + m0;
#pragma unroll
        for (int i = 0; i < TM; ++i) {
            float v = acc[i][j] + bj[j];
            yp[i] = RELU ? fmaxf(v, 0.f) : v;
        }
    }
}

__device__ __forceinline__ float sigmoidf(float x) {
    return 1.f / (1.f + expf(-x));
}

// Philox4x32-10 (Salmon et al., SC'11): counter-based, so every
// (chunk, step, sample, object) gets its own independent draw.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
    for (int r = 0; r < 10; ++r) {
        const uint32_t lo0 = 0xD2511F53u * c.x;
        const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
        const uint32_t lo1 = 0xCD9E8D57u * c.z;
        const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
        c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
        k0 += 0x9E3779B9u;
        k1 += 0xBB67AE85u;
    }
    return c;
}

// Both Box-Muller branches from one pair of 32-bit draws.  The top 24 bits
// make the uniforms; u1 lies in (0, 1], so log never sees 0.
__device__ __forceinline__ void box_muller(uint32_t a, uint32_t b, float& z0, float& z1) {
    const float u1 = (float)((a >> 8) + 1u) * (1.0f / 16777216.0f);
    const float u2 = (float)(b >> 8) * (1.0f / 16777216.0f);
    const float r = sqrtf(-2.0f * logf(u1));
    float s, c;
    sincospif(2.0f * u2, &s, &c);
    z0 = r * c;
    z1 = r * s;
}

__global__ void __launch_bounds__(NT, 1)
rollout_kernel(const float* __restrict__ z0, const float* __restrict__ P,
               float* __restrict__ out, int B, int H, int sample,
               unsigned long long seed, float size_std, float std_lo,
               float std_hi, float temp, int latent_residual) {
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    float* zs = smem;                 // (D, LDO) state
    float* AE = zs + ZS_SIZE;         // scratch: two (h, LDO) or one (h, LDP)
    float* AEb = AE + HID * LDO;
    float* SR = AE + AE_SIZE;         // (2h, LDO): rows [0,h) s, [h,2h) r
    float* P2 = SR + SR_SIZE;         // (2h, LDO) recv|send, then (h, LDP)
    float* LG = P2 + P2_SIZE;         // (MP) pair attention weights
    float* WS = LG + LG_SIZE;         // weight staging chunk

    const int tid = threadIdx.x;
    const int b0 = blockIdx.x * TB;
    constexpr int SD = O * D;
    const uint32_t k0 = (uint32_t)(seed & 0xffffffffull);
    const uint32_t k1 = (uint32_t)(seed >> 32);

    for (int i = tid; i < TB * SD; i += NT) {
        const int b = i / SD, r = i % SD, o = r / D, d = r % D;
        const int gb = b0 + b;
        zs[d * LDO + o * TB + b] = gb < B ? z0[(size_t)gb * SD + r] : 0.f;
    }
    __syncthreads();

    for (int t = 0; t < H; ++t) {
        // embed MLP, self MLP (all objects' rows at once)
        gemm<M, HID, D, true>(zs, LDO, P + OFF_WE0, P + OFF_BE0, AE, LDO, WS);
        __syncthreads();
        gemm<M, HID, HID, false>(AE, LDO, P + OFF_WE1, P + OFF_BE1, AEb, LDO, WS);   // e
        __syncthreads();
        gemm<M, HID, HID, true>(AEb, LDO, P + OFF_WS0, P + OFF_BS0, AE, LDO, WS);
        __syncthreads();
        gemm<M, HID, HID, false>(AE, LDO, P + OFF_WS1, P + OFF_BS1, SR, LDO, WS);    // s
        // receiver and sender halves of the first relational layer
        gemm<M, 2 * HID, HID, false>(AEb, LDO, P + OFF_WRS, nullptr, P2, LDO, WS);
        __syncthreads();
        // pair rows (o, j), j != o, o-major: relu(recv_o + send_j + b)
        for (int i = tid; i < HID * MP; i += NT) {
            const int k = i / MP, m = i % MP;
            const int p = m / TB, b = m % TB;
            const int o = p / (O - 1), jj = p % (O - 1);
            const int j = jj < o ? jj : jj + 1;
            const float v = P2[k * LDO + o * TB + b]
                          + P2[(HID + k) * LDO + j * TB + b] + __ldg(P + OFF_BR0 + k);
            AE[k * LDP + m] = fmaxf(v, 0.f);
        }
        __syncthreads();
        gemm<MP, HID, HID, true>(AE, LDP, P + OFF_WR1, P + OFF_BR1, P2, LDP, WS);
        __syncthreads();
        gemm<MP, HID, HID, false>(P2, LDP, P + OFF_WRF, P + OFF_BRF, AE, LDP, WS);  // features
        for (int m = tid; m < MP; m += NT) {                                     // attention
            float a = 0.f;
            for (int k = 0; k < HID; ++k) a = fmaf(P2[k * LDP + m], __ldg(P + OFF_WRA + k), a);
            LG[m] = sigmoidf(a + __ldg(P + OFF_BRA));
        }
        __syncthreads();
        // r_o = sum over senders j != o of feature * attention
        for (int i = tid; i < HID * M; i += NT) {
            const int k = i / M, m = i % M;
            const int o = m / TB, b = m % TB;
            float acc = 0.f;
#pragma unroll
            for (int jj = 0; jj < O - 1; ++jj) {
                const int pm = (o * (O - 1) + jj) * TB + b;
                acc += AE[k * LDP + pm] * LG[pm];
            }
            SR[(HID + k) * LDO + m] = acc;
        }
        __syncthreads();
        // output MLP on [s ; r]
        gemm<M, HID, 2 * HID, true>(SR, LDO, P + OFF_WO0, P + OFF_BO0, AE, LDO, WS);
        __syncthreads();
        gemm<M, HID, HID, true>(AE, LDO, P + OFF_WO1, P + OFF_BO1, AEb, LDO, WS);
        __syncthreads();
        gemm<M, DOUTP, HID, false>(AEb, LDO, P + OFF_WO2, P + OFF_BO2, AE, LDO, WS);
        __syncthreads();
        // Euler integration into AEb: v' = v + dv, p' = p + v', l' = l + dl
        for (int i = tid; i < D * M; i += NT) {
            const int d = i / M, m = i % M;
            float v;
            if (d < 2) {
                v = zs[d * LDO + m];
            } else if (d < 4) {
                const float vel = zs[(d + 2) * LDO + m] + AE[(d - 2) * LDO + m];
                v = zs[d * LDO + m] + vel;
            } else if (d < 6) {
                v = zs[d * LDO + m] + AE[(d - 4) * LDO + m];
            } else {
                const float dl = AE[(d - 4) * LDO + m];
                v = latent_residual ? zs[d * LDO + m] + dl : dl;
            }
            AEb[d * LDO + m] = v;
        }
        __syncthreads();
        if (sample) {
            // z = mean + temp * std * eps; std = size_std on the size rows,
            // lo + (hi - lo) * sigmoid(raw) on pos/vel/latent rows
            constexpr int NCH = (D + 3) / 4;
            for (int i = tid; i < NCH * M; i += NT) {
                const int c = i / M, m = i % M;
                const int o = m / TB, b = m % TB;
                const uint4 bits = philox4x32_10(
                    make_uint4((uint32_t)c, (uint32_t)t, (uint32_t)(b0 + b), (uint32_t)o), k0, k1);
                float nz[4];
                box_muller(bits.x, bits.y, nz[0], nz[1]);
                box_muller(bits.z, bits.w, nz[2], nz[3]);
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    const int d = 4 * c + q;
                    if (d < D) {
                        const float sd = d < 2 ? size_std
                            : std_lo + (std_hi - std_lo) * sigmoidf(AE[(CL + d) * LDO + m]);
                        zs[d * LDO + m] = AEb[d * LDO + m] + (temp * sd) * nz[q];
                    }
                }
            }
        } else {
            for (int i = tid; i < D * M; i += NT) {
                const int d = i / M, m = i % M;
                zs[d * LDO + m] = AEb[d * LDO + m];
            }
        }
        __syncthreads();
        for (int i = tid; i < TB * SD; i += NT) {
            const int b = i / SD, r = i % SD, o = r / D, d = r % D;
            const int gb = b0 + b;
            if (gb < B) out[((size_t)gb * H + t) * SD + r] = zs[d * LDO + o * TB + b];
        }
    }
}

}  // namespace

extern "C" {

int stove_rollout_param_count() { return N_PARAMS; }

int stove_rollout_smem_bytes() { return (int)SMEM_BYTES; }

int stove_rollout_tile() { return TB; }

// Launches the rollout on `stream`; returns the CUDA error code (0 = ok).
// Pointers are device pointers; the caller checks shapes and allocates out.
cudaError_t stove_rollout_launch(const float* z0, const float* params, float* out,
                                 int B, int H, int sample, unsigned long long seed,
                                 float size_std, float std_lo, float std_hi,
                                 float temp, int latent_residual, void* stream) {
    if (B <= 0 || H <= 0) return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        rollout_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
    if (err != cudaSuccess) return err;
    const int grid = (B + TB - 1) / TB;
    rollout_kernel<<<grid, NT, SMEM_BYTES, (cudaStream_t)stream>>>(
        z0, params, out, B, H, sample, seed, size_std, std_lo, std_hi, temp,
        latent_residual);
    return cudaGetLastError();
}

}  // extern "C"
