// The window machinery both pair engines share (pair_engine.cu, the
// streaming engine K1, and pair_lists.cu, the list walk K6): asynchronous
// staging of candidate windows into dynamic shared memory, and the two
// phases that consume a window.
//
// A window holds up to W candidates: each one's position and sorted-array
// index (for the self test) packed in a float4 and its run ordinal, in two
// buffers, and its other j-fields in structure-of-arrays rows J[f][W]
// (f >= 3), in one buffer. Candidate position k of a window is staged by
// thread k % G with 4-byte cp.async copies; that thread adds its run's
// periodic shift to x/y/z in place once its own copies have landed
// (__fadd_rn, K1's order: rx = xi - (xj + shx)), before the barrier that
// publishes the positions.
//
// The pipeline per window i:
//   stage positions of i + 1 | wait positions of i, shift, publish |
//   mask phase of i (rows of i still landing) | wait rows of i, publish |
//   body phase of i | barrier | stage rows of i + 1 (they land during the
//   next mask phase).
// So the next window's positions load while this one computes, and its
// rows load while its own mask phase runs; the rows, most of a window's
// bytes for the momentum ops, need one buffer only.
//
// Consuming a window:
// - mask phase: every thread tests every candidate of the window (one
//   broadcast 16-byte shared-memory read of the candidate's packed
//   position and index, the exact __f*_rn mask of K1: d^2 < 4 h_i^2 and
//   not the self pair) and keeps its accepted-candidate bits, 32 per word,
//   in shared memory at mbits[q][t] (conflict-free: word q of consecutive
//   threads);
// - body phase: every thread walks its own set bits in ascending order
//   (__ffs, w &= w - 1) and runs the op's pair body on each, reading the
//   candidate's j-fields at its own position k. A warp's trip count is then
//   the largest count of its 32 lanes in the window, not the number of
//   candidates that any lane accepts. The symmetric cutoff d^2 < 4 h_j^2
//   of the momentum ops is tested here, on the few pairs the mask kept, so
//   that the mask phase is the same for every op.
// Each target's sums stay in ascending candidate order.
//
// The mask is the same for every SPH op of a step (the same positions and
// smoothing lengths), so the list walk can keep it: a walk in mode 1
// writes each thread's words to global memory, one in mode 2 reads them
// there instead of running the mask phase (pair_lists.cu; the caller
// names the mode, pair_engine.py's mask argument).

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

#include "cp_async.cuh"
#include "pair_ops.cuh"

// Candidates per window. 256: on the evolved Sedov 100^3 states a warp's
// body phase holds a pair in 0.45 of its lane-passes at 256 against 0.37
// at 128 (the body-pass counter of chip_smoke.py's engines line), and 512
// doubles a block's buffers (std momentum 25.6 -> 51 KB), which halves the
// resident blocks of the ops with many j-fields. A sweep rebuilds with
// -DENGINE_WINDOW=<multiple of 128>.
#ifndef ENGINE_WINDOW
#define ENGINE_WINDOW 256
#endif
constexpr int WINDOW = ENGINE_WINDOW;

// Minimum resident blocks of the largest block (256 threads) each kernel
// is compiled for: 2 caps registers at 128 a thread, so that 64-thread
// groups keep 16 warps (8 blocks) on an SM where shared memory allows; the
// light ops (4-5 j-fields: density, IAD, grad-h), whose mask phase is
// most of their time, get 4 (64 registers: 32 warps).
constexpr int MAX_BLOCK = 256;

template <class Op>
__host__ __device__ constexpr int min_blocks() {
    return Op::NJ <= 5 ? 4 : 2;
}

// The dynamic shared memory of a block: two position buffers (float4 x,
// y, z, idx bits), two run-ordinal buffers, one set of j-field rows, the
// mask words.
template <int NJ>
struct WindowLayout {
    static_assert(WINDOW % 128 == 0, "a window is a multiple of 128 candidates");
    static_assert(NJ > 3, "j-fields 0-2 are the candidate's position");
    static constexpr size_t XYZ = static_cast<size_t>(WINDOW) * 16;
    static constexpr size_t RUN = static_cast<size_t>(WINDOW) * 2;
    static constexpr size_t ROWS = 2 * (XYZ + RUN);
    static constexpr size_t MBITS = ROWS + static_cast<size_t>(NJ - 3) * WINDOW * 4;
    __host__ __device__ static constexpr size_t bytes(int group) {
        return MBITS + static_cast<size_t>(WINDOW / 32) * group * 4;
    }
};

struct WindowView {
    float4* xyz;     // [W] x, y, z (shifted once staged), idx bits
    uint16_t* run;   // [W] run ordinal
    float* rows;     // [NJ - 3][W]: j-field f at rows + (f - 3) * W
};

template <int NJ>
__device__ __forceinline__ WindowView window_view(unsigned char* smem, int b) {
    using L = WindowLayout<NJ>;
    return {reinterpret_cast<float4*>(smem + b * L::XYZ),
            reinterpret_cast<uint16_t*>(smem + 2 * L::XYZ + b * L::RUN),
            reinterpret_cast<float*>(smem + L::ROWS)};
}

// The window's j-fields as the ops' bodies index them, J[f][k] for f >= 3
// (rows 0-2 are never read: the engine passes the separation instead).
__device__ __forceinline__ const float (*j_rows(const WindowView& v))[WINDOW] {
    return reinterpret_cast<const float (*)[WINDOW]>(v.rows) - 3;
}

// Stage the position of candidate `cand` of run ordinal `run` at window
// position `pos`; its index goes in w by a plain store.
__device__ __forceinline__ void stage_position(const WindowView& v, int pos, int cand, int run,
                                               const EngineArgs& p) {
    float4* c = v.xyz + pos;
    cp_async4(&c->x, p.jfields[0] + cand);
    cp_async4(&c->y, p.jfields[1] + cand);
    cp_async4(&c->z, p.jfields[2] + cand);
    c->w = __int_as_float(cand);
    v.run[pos] = static_cast<uint16_t>(run);
}

// Stage the j-field rows of the positions this thread staged (k = t,
// t + G, ... < cnt), from their indices.
template <int NJ>
__device__ __forceinline__ void stage_rows(const WindowView& v, int cnt, int t, int G,
                                           const EngineArgs& p) {
    for (int k = t; k < cnt; k += G) {
        const int cand = __float_as_int(v.xyz[k].w);
#pragma unroll
        for (int f = 3; f < NJ; ++f) cp_async4(v.rows + (f - 3) * WINDOW + k, p.jfields[f] + cand);
    }
}

// After this thread's position copies landed: add the run shift to the
// x/y/z of the positions it staged.
__device__ __forceinline__ void fixup_shifts(const WindowView& v, int cnt, int t, int G,
                                             const float* shx, const float* shy,
                                             const float* shz) {
    for (int k = t; k < cnt; k += G) {
        const int r = v.run[k];
        float4* c = v.xyz + k;
        c->x = __fadd_rn(c->x, shx[r]);
        c->y = __fadd_rn(c->y, shy[r]);
        c->z = __fadd_rn(c->z, shz[r]);
    }
}

// Separation and d^2 of the target against a candidate at c (shift
// already added, or the per-pair minimum-image fold), in the plain
// version's order with no contraction.
template <bool FOLD>
__device__ __forceinline__ float pair_geom(const float4& c, float xi, float yi, float zi,
                                           float lx, float ly, float lz, float& rx, float& ry,
                                           float& rz) {
    rx = __fsub_rn(xi, c.x);
    ry = __fsub_rn(yi, c.y);
    rz = __fsub_rn(zi, c.z);
    if (FOLD) {
        rx = __fsub_rn(rx, __fmul_rn(lx, rintf(__fdiv_rn(rx, lx))));
        ry = __fsub_rn(ry, __fmul_rn(ly, rintf(__fdiv_rn(ry, ly))));
        rz = __fsub_rn(rz, __fmul_rn(lz, rintf(__fdiv_rn(rz, lz))));
    }
    return __fadd_rn(__fadd_rn(__fmul_rn(rx, rx), __fmul_rn(ry, ry)), __fmul_rn(rz, rz));
}

// Mask bit of one candidate: d^2 < 4 h_i^2 and not the self pair.
template <bool FOLD>
__device__ __forceinline__ unsigned mask_bit(const float4& c, float xi, float yi, float zi,
                                             float lx, float ly, float lz, float h4, int tgt) {
    float rx, ry, rz;
    const float d2 = pair_geom<FOLD>(c, xi, yi, zi, lx, ly, lz, rx, ry, rz);
    return static_cast<unsigned>(d2 < h4 && __float_as_int(c.w) != tgt);
}

// The mask phase over the published positions of a window of `cnt`
// candidates: this thread's accepted-candidate words to mbits (and, given
// gw, to global memory at gw[q * G]); returns their count.
template <bool FOLD>
__device__ __forceinline__ int mask_phase(const float4* xyz, int cnt, float xi, float yi,
                                          float zi, float lx, float ly, float lz, float h4,
                                          int tgt, unsigned* mbits, int t, int G,
                                          unsigned* gw) {
    int n = 0;
    for (int kb = 0; kb < cnt; kb += 32) {
        unsigned word = 0u;
        if (kb + 32 <= cnt) {
#pragma unroll
            for (int b = 0; b < 32; ++b)
                word |= mask_bit<FOLD>(xyz[kb + b], xi, yi, zi, lx, ly, lz, h4, tgt) << b;
        } else {
            for (int b = 0; b < cnt - kb; ++b)
                word |= mask_bit<FOLD>(xyz[kb + b], xi, yi, zi, lx, ly, lz, h4, tgt) << b;
        }
        mbits[(kb >> 5) * G + t] = word;
        if (gw) gw[(kb >> 5) * G] = word;
        n += __popc(word);
    }
    return n;
}

// The body phase: this thread's own accepted candidates in ascending
// order [under the symmetric cutoff on j-field sym], the op's pair body
// on each.
template <class Op, bool FOLD, bool SYM>
__device__ __forceinline__ void body_phase(const WindowView& v, int cnt, const float* I,
                                           float lx, float ly, float lz, const unsigned* mbits,
                                           int t, int G, float* acc, const EngineArgs& p) {
    const float (*J)[WINDOW] = j_rows(v);
    const int sym = p.sym_j;
    const int nw = (cnt + 31) >> 5;
    int q = 0;
    unsigned w = nw > 0 ? mbits[t] : 0u;
    while (true) {
        while (w == 0u && ++q < nw) w = mbits[q * G + t];
        if (w == 0u) break;
        const int k = (q << 5) + __ffs(w) - 1;
        w &= w - 1u;
        float rx, ry, rz;
        const float d2 = pair_geom<FOLD>(v.xyz[k], I[0], I[1], I[2], lx, ly, lz, rx, ry, rz);
        if (SYM && !(__fmul_rn(d2, J[sym][k]) < 4.0f)) continue;
        Op::template pair<WINDOW>(I, J, k, rx, ry, rz, d2, acc, p);
    }
}

// Every window of a block's candidates through the pipeline above.
// stage(b) stages the positions of the next window into position buffer
// b (block-uniform: every thread computes the same cursor) and returns its
// candidate count, 0 when none are left. The sums go to acc, the
// neighbour count (the mask's, before any symmetric cutoff) to nc. With
// gw (this thread's first accepted-candidate word in global memory, words
// G apart) mode 1 also writes the mask phase's words there and mode 2
// reads them instead of running the mask phase (the positions must be the
// ones they were written for; nc is then not counted).
template <class Op, bool FOLD, bool SYM, class Stage>
__device__ __forceinline__ void window_pipeline(unsigned char* smem, Stage&& stage,
                                                const float* I, int tgt, const float* shx,
                                                const float* shy, const float* shz, float lx,
                                                float ly, float lz, float* acc, int& nc,
                                                const EngineArgs& p, unsigned* gw = nullptr,
                                                int mode = 0) {
    const int t = threadIdx.x;
    const int G = blockDim.x;
    const float h4 = __fmul_rn(__fmul_rn(4.0f, I[3]), I[3]);
    unsigned* mbits = reinterpret_cast<unsigned*>(smem + WindowLayout<Op::NJ>::MBITS);

    int cnt = stage(0);
    cp_async_commit();
    stage_rows<Op::NJ>(window_view<Op::NJ>(smem, 0), cnt, t, G, p);
    cp_async_commit();
    for (int b = 0; cnt > 0; b ^= 1) {
        // the other position buffer was consumed (the barrier after the body)
        const int next = stage(b ^ 1);
        cp_async_commit();
        cp_async_wait<2>();  // this window's positions
        const WindowView v = window_view<Op::NJ>(smem, b);
        if (!FOLD) fixup_shifts(v, cnt, t, G, shx, shy, shz);
        __syncthreads();  // the positions are published
        if (mode == 2) {
            for (int q = 0; q < (cnt + 31) >> 5; ++q) mbits[q * G + t] = gw[q * G];
        } else {
            nc += mask_phase<FOLD>(v.xyz, cnt, I[0], I[1], I[2], lx, ly, lz, h4, tgt, mbits, t,
                                   G, mode == 1 ? gw : nullptr);
        }
        if (gw) gw += ((cnt + 31) >> 5) * G;
        cp_async_wait<1>();  // this window's rows
        __syncthreads();
        body_phase<Op, FOLD, SYM>(v, cnt, I, lx, ly, lz, mbits, t, G, acc, p);
        __syncthreads();  // the window is consumed: its buffers may be restaged
        stage_rows<Op::NJ>(window_view<Op::NJ>(smem, b ^ 1), next, t, G, p);
        cp_async_commit();
        cnt = next;
    }
}

// Opt a kernel in to its dynamic shared memory (above 48 KB only that
// way) for the largest block, and prefer shared memory over L1: the
// engines read candidates from shared memory only.
template <class K>
cudaError_t set_window_attrs(K kernel, size_t max_bytes) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(max_bytes));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                cudaSharedmemCarveoutMaxShared);
}

// Static facts of one kernel instantiation at a block of `group` threads:
// out[0] registers a thread, [1] local (spill) bytes a thread, [2] static
// shared bytes, [3] dynamic shared bytes, [4] resident blocks per SM,
// [5] the window W, [6] resident warps per SM.
template <class K>
int kernel_info(K kernel, size_t dyn_bytes, int group, int32_t* out) {
    cudaFuncAttributes fa;
    cudaError_t e = cudaFuncGetAttributes(&fa, kernel);
    if (e != cudaSuccess) return static_cast<int>(e);
    int blocks = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, group, dyn_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    out[0] = fa.numRegs;
    out[1] = static_cast<int32_t>(fa.localSizeBytes);
    out[2] = static_cast<int32_t>(fa.sharedSizeBytes);
    out[3] = static_cast<int32_t>(dyn_bytes);
    out[4] = blocks;
    out[5] = WINDOW;
    out[6] = blocks * ((group + 31) / 32);
    return 0;
}
