// Graph-net dynamics core shared by the rollout (rollout.cu) and the
// posterior scan (scan.cu): compile-time shapes, the packed parameter
// layout, the shared-memory layout, the block-wide matmul and one step of
// `dynamics.apply` up to the output MLP's raw outputs, with the optional
// action term and geometry-aware reward head.
//
// Counterpart of stove_tpu/ops/pallas_rollout.py::dyn_tile_core and
// reward_tile_pool.  The including file defines STOVE_O, STOVE_CL, STOVE_H
// and STOVE_TB (samples per block) or takes the defaults below; an
// action-conditioned model adds STOVE_ACT=1 and STOVE_NA (actions), a model
// with a reward head STOVE_REW=1.  Without them the layout, shared memory
// and code are those of the action-free model.  Everything here lives in an
// anonymous namespace: each kernel library gets its own copy.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
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
#ifndef STOVE_ACT
#define STOVE_ACT 0
#endif
#ifndef STOVE_NA
#define STOVE_NA 9
#endif
#ifndef STOVE_REW
#define STOVE_REW 0
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
constexpr bool ACT = STOVE_ACT != 0;  // one-hot action rows into embed layer 0
constexpr int NA = STOVE_NA;          // actions
constexpr bool REW = STOVE_REW != 0;  // reward head on the predicted mean

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
constexpr int OFF_WE0A = OFF_BO2 + DOUTP;       // (NA, h) action rows of embed[0]
constexpr int END_ACT = OFF_WE0A + (ACT ? NA * HID : 0);
// reward head: both heads' first layers side by side, K = [s ; r]
constexpr int OFF_WH0 = END_ACT;                // (2h, 2h): [score | attention]
constexpr int OFF_BH0 = OFF_WH0 + 4 * HID * HID;
constexpr int OFF_WHG = OFF_BH0 + 2 * HID;      // (2h) contact-gap row
constexpr int OFF_WHD = OFF_WHG + 2 * HID;      // (2h) min-distance row
constexpr int OFF_WRW1 = OFF_WHD + 2 * HID;     // score layer 1 (h, h)
constexpr int OFF_BRW1 = OFF_WRW1 + HID * HID;
constexpr int OFF_WRA1 = OFF_BRW1 + HID;        // attention layer 1 (h, h)
constexpr int OFF_BRA1 = OFF_WRA1 + HID * HID;
constexpr int OFF_WH2 = OFF_BRA1 + HID;         // (2h) last columns: score, attention
constexpr int OFF_BH2 = OFF_WH2 + 2 * HID;      // (4; two used)
constexpr int N_PARAMS = REW ? OFF_BH2 + 4 : END_ACT;

// ---- shared memory layout (floats)
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }
constexpr int ZS_SIZE = D * LDO;                          // state
constexpr int AE_SIZE = cmax(2 * HID * LDO, HID * LDP);   // two (h, M) or one (h, MP)
constexpr int SR_SIZE = 2 * HID * LDO;                    // [s ; r]
constexpr int P2_SIZE = cmax(2 * HID * LDO, HID * LDP);   // [recv ; send] or pair
constexpr int LG_SIZE = (MP + 3) / 4 * 4;                 // pair attention
constexpr int WS_FLOATS = 8192;                           // weight chunk (32 KB)
constexpr int RW_SIZE = REW ? 4 * LDO : 0;                // reward: gap, dist, score, logit
constexpr int ACT_SIZE = ACT ? (TB + 3) / 4 * 4 : 0;      // ints: the step's actions
constexpr int SMEM_FLOATS = ZS_SIZE + AE_SIZE + SR_SIZE + P2_SIZE + LG_SIZE + WS_FLOATS
                          + RW_SIZE + ACT_SIZE;
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

// One dynamics step for the block's TB samples: embed and self MLPs, the
// relational MLP over the O(O-1) ordered pairs (receiver|sender halves of
// its first layer as one N=2h matmul, the diagonal skipped), the attention-
// gated pair sums, and the output MLP on [s ; r].  Reads the state zs
// (D, LDO) and, with ACT, each sample's action act[b] (b < TB; written
// before the call, read after its first barrier); leaves the raw outputs
// -- dv (2), dl (cl), raw std (4 + cl), zero padding up to DOUTP -- in AE
// (DOUTP, LDO) and [s ; r] in SR (2h, LDO).  AEb, P2, LG and WS are
// scratch.  Every thread of the block calls it; it ends synchronised.
__device__ __forceinline__ void dyn_forward(const float* __restrict__ zs,
                                            const float* __restrict__ P,
                                            float* AE, float* AEb, float* SR,
                                            float* P2, float* LG, float* WS,
                                            const int* act = nullptr) {
    const int tid = threadIdx.x;
    // embed MLP, self MLP (all objects' rows at once).  The one-hot action
    // contracts with embed[0] to its row D + a: added to every object row
    // of the sample before layer 0's ReLU (an out-of-range action adds
    // nothing, as jax.nn.one_hot gives a zero row).
    if constexpr (ACT) {
        gemm<M, HID, D, false>(zs, LDO, P + OFF_WE0, P + OFF_BE0, AE, LDO, WS);
        __syncthreads();
        for (int i = tid; i < HID * M; i += NT) {
            const int k = i / M, m = i % M;
            const int a = act[m % TB];
            float v = AE[k * LDO + m];
            if (a >= 0 && a < NA) v += __ldg(P + OFF_WE0A + a * HID + k);
            AE[k * LDO + m] = fmaxf(v, 0.f);
        }
    } else {
        gemm<M, HID, D, true>(zs, LDO, P + OFF_WE0, P + OFF_BE0, AE, LDO, WS);
    }
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
}

// Euler integration of the raw outputs AE into the next-state mean, written
// to Y (D, LDO): v' = v + dv, p' = p + v', sizes carried, l' = l + dl
// (latent_residual) or dl.  Every thread calls it; the caller synchronises.
__device__ __forceinline__ void integrate_mean(const float* __restrict__ zs,
                                               const float* __restrict__ AE,
                                               float* __restrict__ Y,
                                               int latent_residual) {
    for (int i = threadIdx.x; i < D * M; i += NT) {
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
        Y[d * LDO + m] = v;
    }
}

// Geometry-aware reward head (pallas_rollout.py::reward_tile_pool,
// dynamics.py:175-197) on the predicted means Y (D, LDO) and the step's
// [s ; r] in SR (2h, LDO).  Per (object, sample) row: the contact gap
// min_j (dist - (s_o + s_j)) and min_j dist over the other objects, with
// dist = sqrt(|p_o - p_j|^2 + 1e-8) and s the mean of the two size rows;
// both heads' first layers as one N = 2h matmul over [s ; r] plus the gap
// and distance rows, ReLU; each head's h -> h ReLU layer; each head's last
// column.  Leaves the score in RW[2 LDO + m] and the attention logit in
// RW[3 LDO + m]; F0 (2h, LDO), F1 (2h, LDO), RW (4, LDO) and WS are
// scratch, and F1 may hold Y (read only before the first barrier).  Every thread of the block calls it; it ends synchronised.
__device__ __forceinline__ void reward_head(const float* Y,
                                            const float* __restrict__ SR,
                                            const float* __restrict__ P,
                                            float* F0, float* F1, float* RW,
                                            float* WS) {
    const int tid = threadIdx.x;
    for (int m = tid; m < M; m += NT) {
        const int o = m / TB, b = m % TB;
        const float px = Y[2 * LDO + m], py = Y[3 * LDO + m];
        const float so = 0.5f * (Y[m] + Y[LDO + m]);
        float mg = INFINITY, md = INFINITY;
#pragma unroll
        for (int j = 0; j < O; ++j) {
            if (j == o) continue;
            const int mj = j * TB + b;
            const float dx = px - Y[2 * LDO + mj], dy = py - Y[3 * LDO + mj];
            const float d = sqrtf(dx * dx + dy * dy + 1e-8f);
            const float sj = 0.5f * (Y[mj] + Y[LDO + mj]);
            mg = fminf(mg, d - (so + sj));
            md = fminf(md, d);
        }
        RW[m] = mg;
        RW[LDO + m] = md;
    }
    // (the matmul's first barrier orders RW before its use below)
    gemm<M, 2 * HID, 2 * HID, false>(SR, LDO, P + OFF_WH0, P + OFF_BH0, F0, LDO, WS);
    __syncthreads();
    for (int i = tid; i < 2 * HID * M; i += NT) {
        const int n = i / M, m = i % M;
        const float v = F0[n * LDO + m] + __ldg(P + OFF_WHG + n) * RW[m]
                      + __ldg(P + OFF_WHD + n) * RW[LDO + m];
        F0[n * LDO + m] = fmaxf(v, 0.f);
    }
    __syncthreads();
    gemm<M, HID, HID, true>(F0, LDO, P + OFF_WRW1, P + OFF_BRW1, F1, LDO, WS);
    gemm<M, HID, HID, true>(F0 + HID * LDO, LDO, P + OFF_WRA1, P + OFF_BRA1,
                            F1 + HID * LDO, LDO, WS);
    __syncthreads();
    for (int i = tid; i < 2 * M; i += NT) {
        const int hd = i / M, m = i % M;
        const float* f = F1 + hd * HID * LDO + m;
        float a = 0.f;
        for (int k = 0; k < HID; ++k) a = fmaf(f[k * LDO], __ldg(P + OFF_WH2 + hd * HID + k), a);
        RW[(2 + hd) * LDO + m] = a + __ldg(P + OFF_BH2 + hd);
    }
    __syncthreads();
}

// The reward of sample b < TB from reward_head's rows: softmax over the
// objects of the attention logits, the pooled score, then a sigmoid.
__device__ __forceinline__ float reward_pool(const float* __restrict__ RW, int b) {
    float mx = -INFINITY;
#pragma unroll
    for (int o = 0; o < O; ++o) mx = fmaxf(mx, RW[3 * LDO + o * TB + b]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int o = 0; o < O; ++o) {
        const float e = expf(RW[3 * LDO + o * TB + b] - mx);
        den += e;
        num += e * RW[2 * LDO + o * TB + b];
    }
    return sigmoidf(num / den);
}

}  // namespace
