// The gravity near field K12 for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel of sphexa_tpu/gravity/traversal.py _pallas_p2p
// (group_pair_engine with the near-field pair_body and no distance
// cutoff). Every target of a block of blk SFC-consecutive particles sums
// the softened gravity of every particle of its block's near-field leaves,
// given as (NB, P) leaf ranges (start, length) of the j-buffer; slots past
// a block's list have length 0. The j-buffer (xj, yj, zj, mj, hj) holds nj
// >= n rows: the targets' own n rows on one device, or a rank's [own slab
// | halo rows] under a mesh (the JAX function's jdata form), the own rows
// at offset 0 in both, so a target's row is its own candidate's row. The
// targets are shifted by `shift` (an image offset, zero for an open box),
// and the pair with the target's own row counts only with allow_self.
// Per pair (rx = x_i - x_j): the
// distance clamped to h_i + h_j and floored at 1e-15,
// w = m_j / max(d^2, (h_i + h_j)^2, 1e-30)^(3/2), a -= r w, phi -= w d^2.
//
// The contract is the JAX function's; its blocking is not. The TPU kernel
// streams contiguous DMA runs, so the JAX wrapper first merges adjacent
// leaf ranges into long runs (_merge_runs). Here cp.async stages any number
// of short ranges as cheaply as one long run, so the kernel reads the leaf
// ranges as they come and nothing runs before it.
//
// Design: the all-pairs N-body tile.
// - One CTA per target block, blk / R threads; thread t keeps R targets
//   (rows b blk + t + r blk / R) in registers: the shifted position, h and
//   four float32 sums each. Tail targets past n re-read the last particle
//   and write nothing.
// - The CTA walks its block's leaf slots in order with a block-uniform
//   cursor and cuts the concatenated candidates into tiles of TILE, staged
//   by 4-byte cp.async (coalesced: a leaf is a run of consecutive rows)
//   into a ring of two tiles in shared memory while the previous tile
//   computes. Each candidate is stored once: a float4 {x, y, z, m}, its h
//   in a row of h of which one broadcast LDS.128 serves four candidates,
//   and its row index for the self test.
// - Every candidate's body runs for all R targets of the thread, so a pair
//   costs 1.25 / R shared-memory reads against about 18 instructions
//   (geometry 6, softening with its 1e-30 floor 4, rsqrt, w 3, sums 4):
//   the FP32 pipe bounds the kernel, not shared memory. The geometry and sums contract (FMA):
//   gravity has no cutoff whose pairs an FMA could flip.
// - The self test costs nothing off the tiles that hold one of the block's
//   own rows: the staging threads flag those (__syncthreads_or at the
//   barrier that publishes the tile), and only a flagged tile without
//   allow_self runs the body with the index compare. With h > 0 the self
//   pair at d^2 = 0 adds exactly 0, but a nonzero shift (Ewald images)
//   makes it a real pair.
// - Load balance: blocks differ widely in near-field size, so the wrapper
//   passes `order`, the blocks by descending candidate count (a device
//   argsort, no host sync), and CTA i runs block order[i]: the heaviest
//   blocks start first and the tail holds the light ones.
// - R is 2 or 4: the solver's target blocks are 64 (below 500k
//   particles; R = 2) and 256 (R = 4).
// Sums are float32 in candidate order, as the TPU kernel's.
//
// What bounds it on this card: the FP32 issue rate (the bound counts 25
// operations a candidate pair: chip_smoke.py GRAV_MASK_OPS +
// GRAV_BODY_OPS). Measured on the H100 at Evrard 125: PERF.md.

#include <cuda_runtime.h>
#include <cstdint>

#include "cp_async.cuh"

namespace {

constexpr int TILE = 256;     // candidates per staged tile
constexpr int MAX_BLK = 256;  // targets per block

// Registers: 64 a thread at R = 2 (32 resident warps per SM), 96 at R = 4
// (its 16 sums and 16 target fields).
template <int R>
constexpr int min_ctas() {
    return R == 4 ? 10 : 8;
}

// One tile of the ring.
struct Stage {
    float4 pm[TILE];  // x, y, z, m
    float h[TILE];
    int idx[TILE];  // sorted-array row (the self test); -1 pads
};

struct P2PArgs {
    const float *x, *y, *z, *h;           // (n,) the targets
    const float *xj, *yj, *zj, *mj, *hj;  // (nj,) the j-buffer the ranges index
    const float* shift;     // (3,) device: added to the targets
    const int32_t* starts;  // (nb, P) leaf range starts (j-buffer rows)
    const int32_t* lens;    // (nb, P) leaf range lengths, 0 past a block's list
    const int32_t* order;   // (nb,) the block each CTA runs
    float *ax, *ay, *az, *phi;
    int32_t n, nj, nb, P, blk, allow_self;
};

// rsqrt without the denormal path: its argument is at least 1e-30, a
// normal float, where the two agree
__device__ __forceinline__ float rsqrt_ftz(float v) {
    float r;
    asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
    return r;
}

template <int R>
struct Targets {
    float x[R], y[R], z[R], h[R];
    int row[R];
    float acc[R][4];
};

// One candidate's pair body for the thread's R targets; SELF drops the
// pair with the target's own row (the candidate's row cj).
template <int R, bool SELF>
__device__ __forceinline__ void body(Targets<R>& tg, const float4 c, float hj, int cj) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const float rx = tg.x[r] - c.x;
        const float ry = tg.y[r] - c.y;
        const float rz = tg.z[r] - c.z;
        const float d2 = fmaf(rz, rz, fmaf(ry, ry, rx * rx));
        const float hij = tg.h[r] + hj;
        const float r2 = fmaxf(d2, hij * hij);
        const float inv = rsqrt_ftz(fmaxf(r2, 1e-30f));
        float w = c.w * inv * inv * inv;
        if (SELF) w = cj != tg.row[r] ? w : 0.0f;
        tg.acc[r][0] = fmaf(-rx, w, tg.acc[r][0]);
        tg.acc[r][1] = fmaf(-ry, w, tg.acc[r][1]);
        tg.acc[r][2] = fmaf(-rz, w, tg.acc[r][2]);
        tg.acc[r][3] = fmaf(-w, d2, tg.acc[r][3]);
    }
}

// Every candidate of a published tile (cnt padded to four by massless
// candidates, which add exactly 0).
template <int R, bool SELF>
__device__ __forceinline__ void run_tile(Targets<R>& tg, const Stage& sg, int cnt) {
    const float4* h4 = reinterpret_cast<const float4*>(sg.h);
    const int4* i4 = reinterpret_cast<const int4*>(sg.idx);
    for (int k = 0; k < cnt; k += 4) {
        const float4 hq = h4[k >> 2];
        const int4 iq = SELF ? i4[k >> 2] : make_int4(0, 0, 0, 0);
        body<R, SELF>(tg, sg.pm[k], hq.x, iq.x);
        body<R, SELF>(tg, sg.pm[k + 1], hq.y, iq.y);
        body<R, SELF>(tg, sg.pm[k + 2], hq.z, iq.z);
        body<R, SELF>(tg, sg.pm[k + 3], hq.w, iq.w);
    }
}

template <int R>
__global__ void __launch_bounds__(MAX_BLK / R, min_ctas<R>())
    gravity_p2p_kernel(const __grid_constant__ P2PArgs p) {
    extern __shared__ __align__(16) unsigned char smem[];
    Stage* ring = reinterpret_cast<Stage*>(smem);
    __shared__ int s_nslot;
    const int T = blockDim.x, t = threadIdx.x;
    const int b = p.order[blockIdx.x];
    const int first = b * p.blk;  // the block's first target row
    const int32_t* starts = p.starts + static_cast<int64_t>(b) * p.P;
    const int32_t* lens = p.lens + static_cast<int64_t>(b) * p.P;

    // the slots to walk: up to the last one with candidates
    if (t == 0) s_nslot = 0;
    __syncthreads();
    int last = 0;
    for (int k = t; k < p.P; k += T)
        if (lens[k] > 0) last = k + 1;
    if (last > 0) atomicMax(&s_nslot, last);

    Targets<R> tg;
    const float sx = p.shift[0], sy = p.shift[1], sz = p.shift[2];
#pragma unroll
    for (int r = 0; r < R; ++r) {
        tg.row[r] = first + t + r * T;
        const int i = min(tg.row[r], p.n - 1);
        tg.x[r] = p.x[i] + sx;
        tg.y[r] = p.y[i] + sy;
        tg.z[r] = p.z[i] + sz;
        tg.h[r] = p.h[i];
#pragma unroll
        for (int a = 0; a < 4; ++a) tg.acc[r][a] = 0.0f;
    }
    __syncthreads();
    const int nslot = s_nslot;

    // staging cursor (block-uniform): the next slot and the offset in it
    int cw = 0, coff = 0;
    // stage the next tile into ring[s]; returns its candidate count and
    // sets `own` where a candidate this thread staged is one of the block's
    // target rows
    auto stage = [&](int s, bool& own) {
        Stage& sg = ring[s];
        int fill = 0;
        while (fill < TILE && cw < nslot) {
            const int start = __ldg(starts + cw), len = __ldg(lens + cw);
            const int take = min(TILE - fill, len - coff);
            for (int pos = first_own(fill, t, T); pos < fill + take; pos += T) {
                const int c = start + coff + (pos - fill);
                cp_async4(&sg.pm[pos].x, p.xj + c);
                cp_async4(&sg.pm[pos].y, p.yj + c);
                cp_async4(&sg.pm[pos].z, p.zj + c);
                cp_async4(&sg.pm[pos].w, p.mj + c);
                cp_async4(&sg.h[pos], p.hj + c);
                sg.idx[pos] = c;
                own |= static_cast<unsigned>(c - first) < static_cast<unsigned>(p.blk);
            }
            fill += take;
            coff += take;
            if (coff >= len) {
                ++cw;
                coff = 0;
            }
        }
        for (int pos = fill + t; pos < ((fill + 3) & ~3); pos += T) {
            sg.pm[pos] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            sg.h[pos] = 1.0f;
            sg.idx[pos] = -1;
        }
        return fill;
    };

    bool own = false;
    int cnt = stage(0, own);
    cp_async_commit();
    for (int s = 0; cnt > 0; s ^= 1) {
        // ring[s ^ 1] was consumed (the barrier after the last tile)
        bool own_next = false;
        const int next = stage(s ^ 1, own_next);
        cp_async_commit();
        cp_async_wait<1>();  // this thread's copies of ring[s]
        // ring[s] is published; it holds a target's own row somewhere
        const bool self_tile = __syncthreads_or(own) != 0 && p.allow_self == 0;
        if (self_tile)
            run_tile<R, true>(tg, ring[s], cnt);
        else
            run_tile<R, false>(tg, ring[s], cnt);
        __syncthreads();  // ring[s] is consumed: it may be restaged
        cnt = next;
        own = own_next;
    }

#pragma unroll
    for (int r = 0; r < R; ++r) {
        const int i = tg.row[r];
        if (i < p.n) {
            p.ax[i] = tg.acc[r][0];
            p.ay[i] = tg.acc[r][1];
            p.az[i] = tg.acc[r][2];
            p.phi[i] = tg.acc[r][3];
        }
    }
}

constexpr size_t RING_BYTES = 2 * sizeof(Stage);

// The kernel for R targets a thread, or null where R is not built.
using Kernel = void (*)(P2PArgs);

Kernel kernel_for(int r) {
    switch (r) {
        case 2: return gravity_p2p_kernel<2>;
        case 4: return gravity_p2p_kernel<4>;
        default: return nullptr;
    }
}

// threads of a CTA for blocks of blk targets, r a thread, or 0 where the
// pair is refused (a whole number of warps, at most MAX_BLK targets)
int threads_for(int blk, int r) {
    if (r <= 0 || blk <= 0 || blk > MAX_BLK || blk % (32 * r) != 0) return 0;
    return blk / r;
}

}  // namespace

extern "C" {

// x, y, z, h (n,) float32, the targets; xj, yj, zj, mj, hj (nj,) float32,
// nj >= n, the j-buffer whose rows the ranges index (the targets' own
// arrays with nj = n on one device); shift (3,) float32; starts, lens (nb,
// P) int32; order (nb,) int32, a permutation of the blocks; ax, ay, az,
// phi (n,) float32: all contiguous on the current device; launched on
// `stream`. nb = ceil(n / blk) blocks, r targets a thread (2 or 4; blk / r
// a multiple of 32, at most 256).
int launch_gravity_p2p(const float* x, const float* y, const float* z, const float* h,
                       const float* xj, const float* yj, const float* zj, const float* mj,
                       const float* hj, int nj, const float* shift, int allow_self,
                       const int32_t* starts, const int32_t* lens, const int32_t* order,
                       int n, int nb, int P, int blk, int r, float* ax, float* ay, float* az,
                       float* phi, void* stream) {
    const Kernel kern = kernel_for(r);
    const int threads = threads_for(blk, r);
    if (kern == nullptr || threads == 0 || order == nullptr || P <= 0 || nj < n ||
        nb != (n + blk - 1) / blk)
        return static_cast<int>(cudaErrorInvalidValue);
    if (nb == 0) return 0;
    const P2PArgs a{x,      y,     z,  h,  xj,  yj, zj, mj, hj, shift, starts, lens,
                    order,  ax,    ay, az, phi, n,  nj, nb, P,  blk,   allow_self};
    kern<<<nb, threads, RING_BYTES, static_cast<cudaStream_t>(stream)>>>(a);
    return static_cast<int>(cudaGetLastError());
}

// The static facts of the kernel a launch at (blk, r) runs, in
// kernel_info's order (engine_window.cuh): registers, local bytes, static
// and dynamic shared bytes, resident blocks per SM, the tile, resident
// warps per SM.
int gravity_p2p_info(int blk, int r, int32_t* out) {
    const Kernel kern = kernel_for(r);
    const int threads = threads_for(blk, r);
    if (kern == nullptr || threads == 0) return static_cast<int>(cudaErrorInvalidValue);
    cudaFuncAttributes fa;
    cudaError_t e = cudaFuncGetAttributes(&fa, kern);
    if (e != cudaSuccess) return static_cast<int>(e);
    int blocks = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, threads, RING_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    out[0] = fa.numRegs;
    out[1] = static_cast<int32_t>(fa.localSizeBytes);
    out[2] = static_cast<int32_t>(fa.sharedSizeBytes);
    out[3] = static_cast<int32_t>(RING_BYTES);
    out[4] = blocks;
    out[5] = TILE;
    out[6] = blocks * (threads / 32);
    return 0;
}

}  // extern "C"
