// Graph-net dynamics core shared by the rollout (rollout.cu) and the
// posterior scan (scan.cu): compile-time shapes, the packed parameter
// layout, the shared-memory layout, the warp-level matmul, one step of
// `dynamics.apply` up to the output MLP's raw outputs with the optional
// action term, the Euler integration to the next mean, the geometry-aware
// reward head and the open-loop std head.
//
// Counterpart of stove_tpu/ops/pallas_rollout.py::dyn_tile_core,
// integrate_mean, reward_tile_pool and _make_kernel's open head.  The
// including file defines STOVE_O, STOVE_CL, STOVE_H and STOVE_TB (samples
// per block) or takes the defaults below; an action-conditioned model adds
// STOVE_ACT=1 and STOVE_NA (actions), a model with a reward head
// STOVE_REW=1, and the sampled rollout of a model with an open-loop std head
// STOVE_OPEN=1 (its weights follow all others in the packed buffer, so the
// buffer of a library with the head serves the libraries without it, the
// scan's among them, as its prefix).  Without them the layout, shared
// memory and code are those of the action-free model.  STOVE_BF16=1 is the
// TPU kernel's bfloat16 variant (make_mm at bf16: matmul operands rounded
// to bf16, f32 sums); STOVE_BF16=2 the dense path under
// compute_dtype=bfloat16 (stove_tpu/models/dynamics.py:61-68), which also
// rounds the operands the variant keeps in f32: the relational attention
// column's dot and the reward head's geometry rows and last columns
// (`dense_round`; a bf16 x bf16 product is exact in f32, so an FMA of the
// rounded operands is the dense path's product).  Everything here lives in an anonymous namespace:
// each kernel library gets its own copy.
//
// One core for both kernels: activations row-major in shared memory,
// warp-level matmuls -- mma.sync m16n8k16 on the tensor cores in the bf16
// library, FMA on the CUDA cores in the same layout in the float32 one --
// over weights packed once in fragment order (fused_rollout.prepare_params)
// and streamed through a cp.async ring; see the note below and at the top
// of rollout.cu.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

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
#ifndef STOVE_OPEN
#define STOVE_OPEN 0
#endif
#ifndef STOVE_BF16
#define STOVE_BF16 0
#endif

namespace {

// ===========================================================================
// The core.
//
// Activations live in shared memory row-major, X[r * ld + k], r over the
// (object, sample) rows r = o * TB + b -- or the (ordered pair, sample) rows
// of the relational MLP -- padded to whole m-tiles of 16 rows, k over
// features.  Y = X W is computed by warp-level mma.sync with the rows as the
// m dimension: bf16 m16n8k16 (f32 accumulators) in the bf16 library,
// FMA on the CUDA cores in the float32 library (each thread sums over k in
// order a tile of TM rows x 4 columns; three-pass TF32 on m16n8k8 missed
// the float32 checks, see rollout.cu).
//
// Weights: every matrix (K, N) is packed once by fused_rollout.prepare_params
// in k-tiles of 32 bytes a column (16 rows bf16, 8 rows f32).  In the bf16
// library in the order the B fragments load -- for each k-tile, for each
// pair of 8-column n-tiles, for each lane, the lane's fragment of both
// n-tiles as 16 bytes -- so a warp reads one k-tile of its two n-tiles as
// 512 contiguous bytes; in the float32 library row-major, a thread's four
// columns one float4 and a warp's 32 columns one 128-byte row.
// Each layer streams from global memory (L2) through a two-slot ring of
// CHUNK bytes in shared memory filled by cp.async: chunk c + 1 is in flight
// while chunk c is used -- across layers too, the next layer's first chunk
// while this layer's last is used -- and one barrier per chunk orders both.
// The FMA loop is unrolled a pass or two at a time, not whole: a step runs
// a dozen layers, and unrolled whole their code outgrew the instruction
// cache.  Warps split
// the n-tiles (each weight fragment is read by one warp) and, where a layer
// has fewer than 16 n-tiles, the m-tiles too; every warp holds the
// accumulators of all its tiles and reads the A fragments from shared memory.
// ===========================================================================

constexpr int O = STOVE_O;          // objects
constexpr int CL = STOVE_CL;        // latent width per object
constexpr int HID = STOVE_H;        // graph-net width
constexpr int TB = STOVE_TB;        // samples per block
constexpr int NT = 256;             // threads per block (8 warps)
constexpr int NW = NT / 32;
constexpr int D = 6 + CL;           // state width per object
constexpr int DOUT = 6 + 2 * CL;    // dv(2) + dl(cl) + raw std(4 + cl)
constexpr int DOUTP = (DOUT + 63) / 64 * 64;  // padded output width
constexpr int NPAIR = O * (O - 1);
constexpr bool ACT = STOVE_ACT != 0;  // one-hot action rows into embed layer 0
constexpr int NA = STOVE_NA;          // actions
constexpr bool REW = STOVE_REW != 0;  // reward head on the predicted mean
constexpr bool OPEN = STOVE_OPEN != 0;  // open-loop std head (sampled rollout)
constexpr int OPP = (4 + CL + 63) / 64 * 64;  // its padded output width (mma_gemm's N)

constexpr bool BF16 = STOVE_BF16 != 0;
constexpr bool DENSE_BF16 = STOVE_BF16 == 2;
constexpr int KTILE = BF16 ? 16 : 8;    // k of one mma
constexpr int EB = BF16 ? 2 : 4;        // bytes of a packed matrix element

constexpr int MR = O * TB;              // (object, sample) rows
constexpr int MPR = NPAIR * TB;         // (ordered pair, sample) rows
constexpr int MT = (MR + 15) / 16;      // their m-tiles
constexpr int PT = (MPR + 15) / 16;
constexpr int MROWS = MT * 16;
constexpr int PROWS = PT * 16;
constexpr int DP = (D + 31) / 32 * 32;  // state width padded to embed's K

static_assert(HID % 32 == 0 && DOUTP <= HID && OPP <= HID,
              "widths must be multiples of 32, outputs within a hidden row");

using act_t = std::conditional_t<BF16, __nv_bfloat16, float>;

// Leading dimension (elements) of a row of k features: rows are 4 (mod 32)
// words apart in the float32 library's float4 loads and bf16 pair loads, 8
// in the bf16 library's float2 loads of f32 rows, so each warp's fragment
// loads are free of bank conflicts.
__host__ __device__ constexpr int LD(int k) { return k + (BF16 ? 8 : 4); }
constexpr int LDZ = LD(DP), LDH = LD(HID), LD2 = LD(2 * HID);
constexpr int LDOUT = LD(DOUTP), LDOP = LD(OPP);

// ---- packed parameter layout (bytes); fused_rollout.kernel_layout
// computes the same offsets.  Matrices (K, N) in fragment order, K padded
// to DP for embed layer 0; vectors f32.  Core, then the action rows, then
// the reward head, then the open-loop std head, so the buffer of a library
// with a head serves the libraries without it as its prefix.
__host__ __device__ constexpr size_t MAT(int k, int n) { return (size_t)k * n * EB; }
constexpr size_t O_WE0 = 0;
constexpr size_t O_WE1 = O_WE0 + MAT(DP, HID);
constexpr size_t O_WS0 = O_WE1 + MAT(HID, HID);
constexpr size_t O_WS1 = O_WS0 + MAT(HID, HID);
constexpr size_t O_WRS = O_WS1 + MAT(HID, HID);       // [W_recv | W_send] (h, 2h)
constexpr size_t O_WR1 = O_WRS + MAT(HID, 2 * HID);
constexpr size_t O_WRF = O_WR1 + MAT(HID, HID);       // rel features (h, h)
constexpr size_t O_WO0 = O_WRF + MAT(HID, HID);       // [W_o0s ; W_o0r] (2h, h)
constexpr size_t O_WO1 = O_WO0 + MAT(2 * HID, HID);
constexpr size_t O_WO2 = O_WO1 + MAT(HID, HID);       // (h, DOUTP), zero padded
constexpr size_t O_VEC = O_WO2 + MAT(HID, DOUTP);
// core vectors, in floats from O_VEC
constexpr int V_BE0 = 0, V_BE1 = V_BE0 + HID, V_BS0 = V_BE1 + HID, V_BS1 = V_BS0 + HID;
constexpr int V_BR0 = V_BS1 + HID, V_BR1 = V_BR0 + HID, V_BRF = V_BR1 + HID;
constexpr int V_WRA = V_BRF + HID;                    // rel attention column (h)
constexpr int V_BRA = V_WRA + HID;                    // (4; one used)
constexpr int V_BO0 = V_BRA + 4, V_BO1 = V_BO0 + HID, V_BO2 = V_BO1 + HID;
constexpr int V_WE0A = V_BO2 + DOUTP;                 // (NA, h) action rows of embed[0]
constexpr int V_END = V_WE0A + (ACT ? NA * HID : 0);
constexpr size_t END_CORE = O_VEC + sizeof(float) * V_END;
// reward head: both heads' first layers side by side over K = [s ; r]
constexpr size_t O_WH0 = END_CORE;                    // (2h, 2h): [score | attention]
constexpr size_t O_WRW1 = O_WH0 + MAT(2 * HID, 2 * HID);   // score layer 1 (h, h)
constexpr size_t O_WRA1 = O_WRW1 + MAT(HID, HID);     // attention layer 1 (h, h)
constexpr size_t O_RVEC = O_WRA1 + MAT(HID, HID);
constexpr int R_BH0 = 0, R_WHG = R_BH0 + 2 * HID, R_WHD = R_WHG + 2 * HID;  // gap, distance rows
constexpr int R_BRW1 = R_WHD + 2 * HID, R_BRA1 = R_BRW1 + HID;
constexpr int R_WH2 = R_BRA1 + HID;                   // (2h) last columns: score, attention
constexpr int R_BH2 = R_WH2 + 2 * HID;                // (4; two used)
constexpr int R_END = R_BH2 + 4;
constexpr size_t END_REW = REW ? O_RVEC + sizeof(float) * R_END : END_CORE;
// open-loop std head: [W_op_s ; W_op_r] stacked along K to contract [s ; r]
constexpr size_t O_WOP0 = END_REW;                    // (2h, h)
constexpr size_t O_WOP1 = O_WOP0 + MAT(2 * HID, HID); // (h, OPP), zero padded
constexpr size_t O_OVEC = O_WOP1 + MAT(HID, OPP);
constexpr int P_BOP0 = 0, P_BOP1 = HID, P_END = HID + OPP;
constexpr size_t N_BYTES = OPEN ? O_OVEC + sizeof(float) * P_END : END_REW;

// ---- shared memory layout (bytes).  Two regions, R1 and R2, take the
// step's large activations in turn (a layer reads one and writes the other):
//   R2: embed hidden | e            R1: [recv | send] (f32)
//   R2: pair hidden h1              R1: h2 (f32)
//   R2: features (f32)              R1: output hidden g0
//   R2: output hidden g1            R1: raw outputs (f32) + open-head stds
//   R2: open-head hidden, reward layer-0 features   R1: reward layer 1 (f32)
// act_t rows are read by matmuls only (bf16 in the bf16 library, the
// rounding make_mm applies at its next matmul anyway); f32 rows are also
// read by elementwise code.
__host__ __device__ constexpr size_t cmaxz(size_t a, size_t b) { return a > b ? a : b; }
__host__ __device__ constexpr size_t al16(size_t b) { return (b + 15) / 16 * 16; }
constexpr size_t SA = sizeof(act_t);
constexpr size_t R1_BYTES = al16(cmaxz(cmaxz(MROWS * LD2 * 4, PROWS * LDH * 4),
                                       cmaxz(MROWS * LDH * SA, MROWS * (LDOUT + LDOP) * 4)));
constexpr size_t R2_BYTES = al16(cmaxz(cmaxz(2 * MROWS * LDH * SA, PROWS * LDH * SA),
                                       cmaxz(PROWS * LDH * 4, MROWS * LD2 * SA)));
// One ring slot: 32 KB for the float32 library at 16 samples a block (half
// the barriers of 16 KB, and its shared memory has the room), 16 KB else
// (two 4-sample blocks share an SM).
constexpr size_t CHUNK = !BF16 && TB >= 16 ? 32768 : 16384;
// Passes of the FMA loop unrolled at a time (mma_gemm): whole chunks
// unrolled outgrew the instruction cache (86.97 against 59.96 ms at
// B=16384, H=92 for billiards, tools/rollout_probe.py); the reward head's
// three more layers run best at one.
constexpr int FMA_UNROLL = REW ? 1 : 2;
constexpr size_t S_ZS = 0;                            // f32 (MROWS, LDZ) state
constexpr size_t S_ZN = S_ZS + al16(MROWS * LDZ * 4); // f32 (MROWS, LDZ) next mean
constexpr size_t S_SR = S_ZN + al16(MROWS * LDZ * 4); // act (MROWS, LD2) [s | r]
constexpr size_t S_R1 = S_SR + al16(MROWS * LD2 * SA);
constexpr size_t S_R2 = S_R1 + R1_BYTES;
constexpr size_t S_LG = S_R2 + R2_BYTES;              // f32 (PROWS) pair attention
constexpr size_t S_RW = S_LG + al16(PROWS * 4);       // f32 (4, MROWS) gap, dist, score, logit
constexpr size_t S_ACT = S_RW + al16(4 * MROWS * 4);  // int (TB) the step's actions
constexpr size_t S_RING = S_ACT + al16(TB * 4);       // 2 x CHUNK weight ring
constexpr size_t SMEM_BYTES = S_RING + 2 * CHUNK;
static_assert(SMEM_BYTES <= 232448, "shared memory above the 227 KB a block can use");

__device__ __forceinline__ float sigmoidf(float x) {
    return 1.f / (1.f + expf(-x));
}

// x rounded to bf16 (nearest even) in the STOVE_BF16=2 library, else x: an
// operand of a product the dense bf16 path rounds and the kernel's variant
// takes in f32.
__device__ __forceinline__ float dense_round(float x) {
    if constexpr (DENSE_BF16) return __bfloat162float(__float2bfloat16_rn(x));
    return x;
}

// ---- primitives (inline PTX) ------------------------------------------------
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// D += A B, bf16 operands, f32 accumulators (m16n8k16, row.col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}
// ---- end of primitives ------------------------------------------------------

__device__ __forceinline__ void st2(float* y, float a, float b) {
    *reinterpret_cast<float2*>(y) = make_float2(a, b);
}
__device__ __forceinline__ void st2(__nv_bfloat16* y, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(y) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ float2 ldg2(const float* p) {
    return __ldg(reinterpret_cast<const float2*>(p));
}

// Rows r and r + 8, columns k, k + 1 and k + 8, k + 9 of X as the bf16 A
// fragment of m16n8k16 (f32 rows rounded to bf16 here, nearest even).
template <typename TX>
__device__ __forceinline__ void load_a_bf16(const TX* X, int ldx, int r, int k,
                                            uint32_t (&a)[4]) {
    if constexpr (std::is_same<TX, float>::value) {
        const float2 v0 = *reinterpret_cast<const float2*>(X + r * ldx + k);
        const float2 v1 = *reinterpret_cast<const float2*>(X + (r + 8) * ldx + k);
        const float2 v2 = *reinterpret_cast<const float2*>(X + r * ldx + k + 8);
        const float2 v3 = *reinterpret_cast<const float2*>(X + (r + 8) * ldx + k + 8);
        a[0] = pack_bf16(v0.x, v0.y);
        a[1] = pack_bf16(v1.x, v1.y);
        a[2] = pack_bf16(v2.x, v2.y);
        a[3] = pack_bf16(v3.x, v3.y);
    } else {
        a[0] = *reinterpret_cast<const uint32_t*>(X + r * ldx + k);
        a[1] = *reinterpret_cast<const uint32_t*>(X + (r + 8) * ldx + k);
        a[2] = *reinterpret_cast<const uint32_t*>(X + r * ldx + k + 8);
        a[3] = *reinterpret_cast<const uint32_t*>(X + (r + 8) * ldx + k + 8);
    }
}

__device__ __forceinline__ void copy_chunk(unsigned char* dst, const unsigned char* src,
                                           int bytes) {
    for (int i = threadIdx.x * 16; i < bytes; i += NT * 16) cp_async16(dst + i, src + i);
}

// Bytes of one ring chunk of a packed (K, N) matrix: as many whole k-tiles
// (32 N bytes each) as a slot holds, at most all of them.
__host__ __device__ constexpr int chunk_bytes(int n, int k) {
    return ((int)CHUNK / (32 * n) < k / KTILE ? (int)CHUNK / (32 * n) : k / KTILE) * 32 * n;
}

// The matrix whose first chunk a gemm puts in flight at its last chunk: the
// next one the block multiplies by.
struct Next {
    const unsigned char* w;
    int bytes;
};
template <int N, int K>
__device__ __forceinline__ Next next_matrix(const unsigned char* w) {
    return Next{w, chunk_bytes(N, K)};
}

// Puts the first chunk of the step's first matrix in flight (before the
// first dyn_step; later steps find it issued by the step before).
__device__ __forceinline__ void stream_start(unsigned char* ring, int q, Next nx) {
    copy_chunk(ring + (q & 1) * CHUNK, nx.w, nx.bytes);
    cp_async_commit();
}

// Y = X W for the first ROWS rows of X (MTILES m-tiles of 16 rows in shared
// memory, leading dim ldx, K columns; rows past ROWS are padding whose
// results are dropped).  W: the (K, N) matrix packed by prepare_params in
// global memory, streamed through `ring` (two CHUNK slots; q counts the
// chunks the block has used, so consecutive calls alternate slots).  W's
// first chunk is already in flight (put there by the gemm before, or by
// stream_start); at its last chunk the gemm puts `nx`'s first chunk in
// flight into the other slot, so the weight stream never waits between
// layers.  For
// each output pair (r, n), (r, n + 1) the epilogue epi(r, n, v0, v1) adds
// bias, activation and stores.  Every thread of the block calls it; inputs
// written before the call are visible (every chunk starts with a barrier);
// the caller synchronises before the outputs are read by other threads.
template <int MTILES, int ROWS, int N, int K, typename TX, typename Epi>
__device__ __forceinline__ void mma_gemm(const TX* __restrict__ X, int ldx,
                                         const unsigned char* __restrict__ W,
                                         unsigned char* ring, int& q, Next nx,
                                         Epi epi) {
    constexpr int KT = K / KTILE;                  // k-tiles
    static_assert(K % KTILE == 0 && N % 16 == 0, "K, N must fill whole tiles");
    constexpr int ROWB = 32 * N;                   // bytes of one packed k-tile
    constexpr int CB = chunk_bytes(N, K);         // bytes per chunk
    constexpr int CKT = CB / ROWB;                 // k-tiles per chunk
    static_assert(CKT >= 1 && KT % CKT == 0, "a chunk must hold whole k-tiles");
    constexpr int NCH = KT / CKT;                  // chunks
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    // bf16 (mma.sync): warps split the pairs of 8-column n-tiles (each weight
    // fragment read by one warp) and, below 16 pairs, the m-tiles; lane
    // (g, t) holds the fragments' rows g, g + 8 and columns 2t, 2t + 1
    constexpr int NP = N / 16;                     // pairs of 8-column n-tiles
    constexpr int WN = NP < NW ? NP : NW;          // warps along n
    static_assert(NP % WN == 0 && NW % WN == 0, "n-tile pairs must split over warps");
    constexpr int WM = NW / WN;                    // warps along m
    constexpr int PPW = NP / WN;                   // n-tile pairs per warp
    constexpr int MTW = (MTILES + WM - 1) / WM;    // m-tiles per warp
    const int g = lane >> 2, t = lane & 3;
    const int wn = warp % WN, wm = warp / WN;
    // float32 (FMA): a warp covers 32 columns, 8 groups of 4 (a weight row
    // read as 128 contiguous bytes), and 4 row groups; warps split N, then
    // the rows; lane (cg, rg) holds TM rows rg, rg + 4, ... (consecutive
    // rows of a load fall in distinct banks) of its warp's rows, x 4 columns
    constexpr int FWN = N / 32;                    // warps along n
    static_assert(BF16 || (N % 64 == 0 && FWN <= NW),
                  "float32 layers need N a multiple of 64, at most 32 NW");
    constexpr int FRW = MTILES * 16 / (FWN <= NW ? NW / FWN : 1);  // rows a warp
    constexpr int TM = FRW / 4;                    // rows per thread
    const int n0 = (warp % FWN) * 32 + 4 * (lane & 7);
    const int r0 = (warp / FWN) * FRW + (lane >> 3);

    constexpr int AR = BF16 ? MTW : TM, AC = BF16 ? 2 * PPW : 1;
    float acc[AR][AC][4];
#pragma unroll
    for (int j = 0; j < AR; ++j)
#pragma unroll
        for (int i = 0; i < AC; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[j][i][e] = 0.f;

    for (int c = 0; c < NCH; ++c) {
        cp_async_wait_all();
        __syncthreads();            // chunk c landed for all; chunk c - 1 is used up
        if (c + 1 < NCH) {
            copy_chunk(ring + ((q + 1) & 1) * CHUNK, W + (size_t)(c + 1) * CB, CB);
        } else {
            copy_chunk(ring + ((q + 1) & 1) * CHUNK, nx.w, nx.bytes);
        }
        cp_async_commit();
        const unsigned char* ws = ring + (q & 1) * CHUNK;
        ++q;
        if constexpr (BF16) {
#pragma unroll
            for (int kk = 0; kk < CKT; ++kk) {
                const int k0 = (c * CKT + kk) * KTILE;
                const uint4* wrow = reinterpret_cast<const uint4*>(ws + kk * ROWB);
                uint4 b[PPW];
#pragma unroll
                for (int i = 0; i < PPW; ++i) b[i] = wrow[(wn + i * WN) * 32 + lane];
#pragma unroll
                for (int j = 0; j < MTW; ++j) {
                    const int mt = wm + j * WM;
                    if (MTW * WM > MTILES && mt >= MTILES) continue;
                    uint32_t a[4];
                    load_a_bf16(X, ldx, mt * 16 + g, k0 + 2 * t, a);
#pragma unroll
                    for (int i = 0; i < PPW; ++i) {
                        mma_bf16(acc[j][2 * i], a, b[i].x, b[i].y);
                        mma_bf16(acc[j][2 * i + 1], a, b[i].z, b[i].w);
                    }
                }
            }
        } else {
            // k in order over the chunk's CKT * 8 rows of W (row-major), four
            // k a pass (one float4 of each of the thread's rows of X),
            // FMA_UNROLL passes unrolled
            const float* wf = reinterpret_cast<const float*>(ws);
            const TX* xc = X + r0 * ldx + c * CKT * KTILE;
#pragma unroll (FMA_UNROLL)
            for (int kq = 0; kq < CKT * KTILE; kq += 4) {
                float4 xr[TM];
#pragma unroll
                for (int i = 0; i < TM; ++i)
                    xr[i] = *reinterpret_cast<const float4*>(xc + 4 * i * ldx + kq);
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    const float4 w = *reinterpret_cast<const float4*>(wf + (kq + u) * N + n0);
#pragma unroll
                    for (int i = 0; i < TM; ++i) {
                        const float x = reinterpret_cast<const float*>(&xr[i])[u];
                        acc[i][0][0] = fmaf(x, w.x, acc[i][0][0]);
                        acc[i][0][1] = fmaf(x, w.y, acc[i][0][1]);
                        acc[i][0][2] = fmaf(x, w.z, acc[i][0][2]);
                        acc[i][0][3] = fmaf(x, w.w, acc[i][0][3]);
                    }
                }
            }
        }
    }
    if constexpr (BF16) {
#pragma unroll
        for (int j = 0; j < MTW; ++j) {
            const int mt = wm + j * WM;
            if (MTW * WM > MTILES && mt >= MTILES) continue;
            const int r = mt * 16 + g;
#pragma unroll
            for (int i = 0; i < 2 * PPW; ++i) {
                const int n = (wn + (i >> 1) * WN) * 16 + (i & 1) * 8 + 2 * t;
                if (r < ROWS) epi(r, n, acc[j][i][0], acc[j][i][1]);
                if (r + 8 < ROWS) epi(r + 8, n, acc[j][i][2], acc[j][i][3]);
            }
        }
    } else {
#pragma unroll
        for (int i = 0; i < TM; ++i) {
            const int r = r0 + 4 * i;
            if (r < ROWS) {
                epi(r, n0, acc[i][0][0], acc[i][0][1]);
                epi(r, n0 + 2, acc[i][0][2], acc[i][0][3]);
            }
        }
    }
}

// The block's shared memory, carved per the S_* offsets.
struct Smem {
    float* zs;            // (MROWS, LDZ) state
    float* zn;            // (MROWS, LDZ) predicted mean
    act_t* sr;            // (MROWS, LD2) [s | r]
    unsigned char* r1;
    unsigned char* r2;
    float* lg;            // (PROWS) pair attention weights
    float* rw;            // (4, MROWS) reward head rows
    int* acts;            // (TB) the step's actions
    unsigned char* ring;  // weight ring
};

__device__ __forceinline__ Smem carve(unsigned char* base) {
    Smem s;
    s.zs = reinterpret_cast<float*>(base + S_ZS);
    s.zn = reinterpret_cast<float*>(base + S_ZN);
    s.sr = reinterpret_cast<act_t*>(base + S_SR);
    s.r1 = base + S_R1;
    s.r2 = base + S_R2;
    s.lg = reinterpret_cast<float*>(base + S_LG);
    s.rw = reinterpret_cast<float*>(base + S_RW);
    s.acts = reinterpret_cast<int*>(base + S_ACT);
    s.ring = base + S_RING;
    return s;
}

// The raw output rows (f32 (MROWS, LDOUT)) after dyn_step, in R1.
__device__ __forceinline__ float* raw_out(const Smem& s) {
    return reinterpret_cast<float*>(s.r1);
}

// One dynamics step for the block's TB samples (pallas_rollout.py::
// dyn_tile_core): embed and self MLPs over all object rows, the receiver|
// sender halves of the first relational layer as one N = 2h matmul, the
// pair rows relu(recv_o + send_j + b) of the O(O-1) ordered pairs (the
// diagonal skipped), the relational MLP, the attention logit of each pair
// row as a warp-wide f32 dot product, the gated sums r_o, and the output MLP
// on [s ; r].  Reads the state s.zs and, with ACT, the step's actions s.acts
// (written before the call); leaves [s | r] in s.sr and the raw outputs --
// dv (2), dl (cl), raw std (4 + cl), zero padding up to DOUTP -- in
// raw_out(s); `after` is the matrix the block multiplies by next, after the
// output MLP.  Every thread of the block calls it; it ends synchronised.
__device__ __forceinline__ void dyn_step(const Smem& s, const unsigned char* __restrict__ P,
                                         int& q, Next after) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const float* V = reinterpret_cast<const float*>(P + O_VEC);
    act_t* A0 = reinterpret_cast<act_t*>(s.r2);        // (MROWS, LDH)
    act_t* E = A0 + MROWS * LDH;                       // (MROWS, LDH)
    act_t* SR = s.sr;
    // embed layer 0; the one-hot action contracts with embed[0] to its row
    // D + a, added to every object row of the sample before the ReLU (an
    // out-of-range action adds nothing, as jax.nn.one_hot gives a zero row)
    mma_gemm<MT, MR, HID, DP>(s.zs, LDZ, P + O_WE0, s.ring, q,
        next_matrix<HID, HID>(P + O_WE1),
        [&](int r, int n, float v0, float v1) {
            const float2 b = ldg2(V + V_BE0 + n);
            v0 += b.x;
            v1 += b.y;
            if constexpr (ACT) {
                const int a = s.acts[r % TB];
                if (a >= 0 && a < NA) {
                    const float2 w = ldg2(V + V_WE0A + a * HID + n);
                    v0 += w.x;
                    v1 += w.y;
                }
            }
            st2(A0 + r * LDH + n, fmaxf(v0, 0.f), fmaxf(v1, 0.f));
        });
    mma_gemm<MT, MR, HID, HID>(A0, LDH, P + O_WE1, s.ring, q,           // e
        next_matrix<HID, HID>(P + O_WS0),
        [&](int r, int n, float v0, float v1) {
            const float2 b = ldg2(V + V_BE1 + n);
            st2(E + r * LDH + n, v0 + b.x, v1 + b.y);
        });
    mma_gemm<MT, MR, HID, HID>(E, LDH, P + O_WS0, s.ring, q,
        next_matrix<HID, HID>(P + O_WS1),
        [&](int r, int n, float v0, float v1) {
            const float2 b = ldg2(V + V_BS0 + n);
            st2(A0 + r * LDH + n, fmaxf(v0 + b.x, 0.f), fmaxf(v1 + b.y, 0.f));
        });
    mma_gemm<MT, MR, HID, HID>(A0, LDH, P + O_WS1, s.ring, q,           // s
        next_matrix<2 * HID, HID>(P + O_WRS),
        [&](int r, int n, float v0, float v1) {
            const float2 b = ldg2(V + V_BS1 + n);
            st2(SR + r * LD2 + n, v0 + b.x, v1 + b.y);
        });
    float* P2 = reinterpret_cast<float*>(s.r1);        // (MROWS, LD2) [recv | send]
    mma_gemm<MT, MR, 2 * HID, HID>(E, LDH, P + O_WRS, s.ring, q,
        next_matrix<HID, HID>(P + O_WR1),
        [&](int r, int n, float v0, float v1) { st2(P2 + r * LD2 + n, v0, v1); });
    __syncthreads();
    // pair rows (o, j), j != o, o-major: relu(recv_o + send_j + b)
    act_t* BH = reinterpret_cast<act_t*>(s.r2);        // (PROWS, LDH)
    for (int i = tid; i < MPR * (HID / 2); i += NT) {
        const int m = i / (HID / 2), k = 2 * (i % (HID / 2));
        const int p = m / TB, b = m % TB;
        const int o = p / (O - 1), jj = p % (O - 1);
        const int j = jj < o ? jj : jj + 1;
        const float2 rv = *reinterpret_cast<const float2*>(P2 + (o * TB + b) * LD2 + k);
        const float2 sv = *reinterpret_cast<const float2*>(P2 + (j * TB + b) * LD2 + HID + k);
        const float2 bb = ldg2(V + V_BR0 + k);
        st2(BH + m * LDH + k, fmaxf(rv.x + sv.x + bb.x, 0.f), fmaxf(rv.y + sv.y + bb.y, 0.f));
    }
    float* H2 = reinterpret_cast<float*>(s.r1);        // (PROWS, LDH) f32
    mma_gemm<PT, MPR, HID, HID>(BH, LDH, P + O_WR1, s.ring, q,
        next_matrix<HID, HID>(P + O_WRF),
        [&](int r, int n, float v0, float v1) {
            const float2 b = ldg2(V + V_BR1 + n);
            st2(H2 + r * LDH + n, fmaxf(v0 + b.x, 0.f), fmaxf(v1 + b.y, 0.f));
        });
    float* FT = reinterpret_cast<float*>(s.r2);        // (PROWS, LDH) features
    mma_gemm<PT, MPR, HID, HID>(H2, LDH, P + O_WRF, s.ring, q,
        next_matrix<HID, 2 * HID>(P + O_WO0),
        [&](int r, int n, float v0, float v1) {
            const float2 b = ldg2(V + V_BRF + n);
            st2(FT + r * LDH + n, v0 + b.x, v1 + b.y);
        });
    // attention: sigmoid(h2 . w_ra + b_ra) per pair row, in f32 (as the TPU
    // kernel's jnp.sum; both operands rounded in the dense bf16 library),
    // one warp per row (h2 is visible: the gemm above began with barriers)
    for (int m = warp; m < MPR; m += NW) {
        float a = 0.f;
        for (int k = lane; k < HID; k += 32)
            a = fmaf(dense_round(H2[m * LDH + k]), dense_round(__ldg(V + V_WRA + k)), a);
        a = warp_sum(a);
        if (lane == 0) s.lg[m] = sigmoidf(a + __ldg(V + V_BRA));
    }
    __syncthreads();
    // r_o = sum over senders j != o of feature * attention
    for (int i = tid; i < MR * (HID / 2); i += NT) {
        const int m = i / (HID / 2), k = 2 * (i % (HID / 2));
        const int o = m / TB, b = m % TB;
        float ax = 0.f, ay = 0.f;
#pragma unroll
        for (int jj = 0; jj < O - 1; ++jj) {
            const int pm = (o * (O - 1) + jj) * TB + b;
            const float2 f = *reinterpret_cast<const float2*>(FT + pm * LDH + k);
            const float w = s.lg[pm];
            ax += f.x * w;
            ay += f.y * w;
        }
        st2(SR + m * LD2 + HID + k, ax, ay);
    }
    // output MLP on [s ; r]
    act_t* G0 = reinterpret_cast<act_t*>(s.r1);
    act_t* G1 = reinterpret_cast<act_t*>(s.r2);
    mma_gemm<MT, MR, HID, 2 * HID>(SR, LD2, P + O_WO0, s.ring, q,
        next_matrix<HID, HID>(P + O_WO1),
        [&](int r, int n, float v0, float v1) {
            const float2 b = ldg2(V + V_BO0 + n);
            st2(G0 + r * LDH + n, fmaxf(v0 + b.x, 0.f), fmaxf(v1 + b.y, 0.f));
        });
    mma_gemm<MT, MR, HID, HID>(G0, LDH, P + O_WO1, s.ring, q,
        next_matrix<DOUTP, HID>(P + O_WO2),
        [&](int r, int n, float v0, float v1) {
            const float2 b = ldg2(V + V_BO1 + n);
            st2(G1 + r * LDH + n, fmaxf(v0 + b.x, 0.f), fmaxf(v1 + b.y, 0.f));
        });
    float* OUT = raw_out(s);
    mma_gemm<MT, MR, DOUTP, HID>(G1, LDH, P + O_WO2, s.ring, q, after,
        [&](int r, int n, float v0, float v1) {
            const float2 b = ldg2(V + V_BO2 + n);
            st2(OUT + r * LDOUT + n, v0 + b.x, v1 + b.y);
        });
    __syncthreads();
}

// Euler integration of the raw outputs into the next-state mean s.zn:
// v' = v + dv, p' = p + v', sizes carried, l' = l + dl (latent_residual) or
// dl.  Every thread calls it; the caller synchronises.
__device__ __forceinline__ void integrate_mean(const Smem& s, int latent_residual) {
    const float* OUT = raw_out(s);
    for (int i = threadIdx.x; i < MR * D; i += NT) {
        const int r = i / D, d = i % D;
        const float* z = s.zs + r * LDZ;
        const float* out = OUT + r * LDOUT;
        float v;
        if (d < 2) {
            v = z[d];
        } else if (d < 4) {
            v = z[d] + (z[d + 2] + out[d - 2]);
        } else if (d < 6) {
            v = z[d] + out[d - 4];
        } else {
            v = latent_residual ? z[d] + out[d - 4] : out[d - 4];
        }
        s.zn[r * LDZ + d] = v;
    }
}

// Open-loop std head (pallas_rollout.py:400-404) on the step's [s | r]:
// f = relu([W_op_s ; W_op_r]^T [s ; r] + b_op0) into R2, then the raw stds
// W_op1^T f + b_op1, f32 (MROWS, LDOP) after the raw outputs in R1 (column
// d - 2 for state column d >= 2), returned; `after` as dyn_step's.  Every
// thread calls it; it ends synchronised.
__device__ __forceinline__ const float* open_head(const Smem& s,
                                                  const unsigned char* __restrict__ P,
                                                  int& q, Next after) {
    const float* V = reinterpret_cast<const float*>(P + O_OVEC);
    act_t* F = reinterpret_cast<act_t*>(s.r2);
    float* RAW = raw_out(s) + MROWS * LDOUT;
    mma_gemm<MT, MR, HID, 2 * HID>(s.sr, LD2, P + O_WOP0, s.ring, q,
        next_matrix<OPP, HID>(P + O_WOP1),
        [&](int r, int n, float v0, float v1) {
            const float2 b = ldg2(V + P_BOP0 + n);
            st2(F + r * LDH + n, fmaxf(v0 + b.x, 0.f), fmaxf(v1 + b.y, 0.f));
        });
    mma_gemm<MT, MR, OPP, HID>(F, LDH, P + O_WOP1, s.ring, q, after,
        [&](int r, int n, float v0, float v1) {
            const float2 b = ldg2(V + P_BOP1 + n);
            st2(RAW + r * LDOP + n, v0 + b.x, v1 + b.y);
        });
    __syncthreads();
    return RAW;
}

// Geometry-aware reward head (pallas_rollout.py::reward_tile_pool) on the
// predicted means s.zn and the step's [s | r].  Per (object, sample) row:
// the contact gap min_j (dist - (s_o + s_j)) and min_j dist over the other
// objects (dist = sqrt(|p_o - p_j|^2 + 1e-8), s the mean of the two size
// columns); both heads' first layers as one N = 2h matmul over [s ; r] plus
// the gap and distance rows, ReLU; each head's h -> h ReLU layer (f32 out);
// each head's last column as a warp-wide f32 dot product (the gap and
// distance rows and the last columns on rounded operands in the dense bf16
// library: `dense_round`).  Leaves the score
// in rw[2 MROWS + r] and the attention logit in rw[3 MROWS + r].  Uses R1,
// R2; `after` as dyn_step's.  Every thread calls it; it ends synchronised.
__device__ __forceinline__ void reward_head(const Smem& s, const unsigned char* __restrict__ P,
                                            int& q, Next after) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const float* V = reinterpret_cast<const float*>(P + O_RVEC);
    float* RW = s.rw;
    for (int m = tid; m < MR; m += NT) {
        const int o = m / TB, b = m % TB;
        const float* y = s.zn + m * LDZ;
        const float so = 0.5f * (y[0] + y[1]);
        float mg = INFINITY, md = INFINITY;
#pragma unroll
        for (int j = 0; j < O; ++j) {
            if (j == o) continue;
            const float* yj = s.zn + (j * TB + b) * LDZ;
            const float dx = y[2] - yj[2], dy = y[3] - yj[3];
            const float d = sqrtf(dx * dx + dy * dy + 1e-8f);
            const float sj = 0.5f * (yj[0] + yj[1]);
            mg = fminf(mg, d - (so + sj));
            md = fminf(md, d);
        }
        RW[m] = mg;
        RW[MROWS + m] = md;
    }
    act_t* F0 = reinterpret_cast<act_t*>(s.r2);        // (MROWS, LD2)
    float* F1 = reinterpret_cast<float*>(s.r1);        // (MROWS, LD2) f32
    mma_gemm<MT, MR, 2 * HID, 2 * HID>(s.sr, LD2, P + O_WH0, s.ring, q,
        next_matrix<HID, HID>(P + O_WRW1),
        [&](int r, int n, float v0, float v1) {
            const float2 b = ldg2(V + R_BH0 + n);
            const float2 wg = ldg2(V + R_WHG + n), wd = ldg2(V + R_WHD + n);
            const float gp = dense_round(RW[r]), dd = dense_round(RW[MROWS + r]);
            st2(F0 + r * LD2 + n,
                fmaxf(v0 + b.x + dense_round(wg.x) * gp + dense_round(wd.x) * dd, 0.f),
                fmaxf(v1 + b.y + dense_round(wg.y) * gp + dense_round(wd.y) * dd, 0.f));
        });
    mma_gemm<MT, MR, HID, HID>(F0, LD2, P + O_WRW1, s.ring, q,
        next_matrix<HID, HID>(P + O_WRA1),
        [&](int r, int n, float v0, float v1) {
            const float2 b = ldg2(V + R_BRW1 + n);
            st2(F1 + r * LD2 + n, fmaxf(v0 + b.x, 0.f), fmaxf(v1 + b.y, 0.f));
        });
    mma_gemm<MT, MR, HID, HID>(F0 + HID, LD2, P + O_WRA1, s.ring, q, after,
        [&](int r, int n, float v0, float v1) {
            const float2 b = ldg2(V + R_BRA1 + n);
            st2(F1 + r * LD2 + HID + n, fmaxf(v0 + b.x, 0.f), fmaxf(v1 + b.y, 0.f));
        });
    __syncthreads();
    for (int i = warp; i < 2 * MR; i += NW) {
        const int hd = i / MR, m = i % MR;
        const float* f = F1 + m * LD2 + hd * HID;
        float a = 0.f;
        for (int k = lane; k < HID; k += 32)
            a = fmaf(dense_round(f[k]), dense_round(__ldg(V + R_WH2 + hd * HID + k)), a);
        a = warp_sum(a);
        if (lane == 0) RW[(2 + hd) * MROWS + m] = a + __ldg(V + R_BH2 + hd);
    }
    __syncthreads();
}

// The reward of sample b < TB from reward_head's rows: softmax over the
// objects of the attention logits, the pooled score, then a sigmoid.
__device__ __forceinline__ float reward_pool(const float* __restrict__ RW, int b) {
    float mx = -INFINITY;
#pragma unroll
    for (int o = 0; o < O; ++o) mx = fmaxf(mx, RW[3 * MROWS + o * TB + b]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int o = 0; o < O; ++o) {
        const float e = expf(RW[3 * MROWS + o * TB + b] - mx);
        den += e;
        num += e * RW[2 * MROWS + o * TB + b];
    }
    return sigmoidf(num / den);
}

}  // namespace
