// Persistent neighbour lists for NVIDIA Hopper (sm_90a): the mark pass and
// the list walk.
//
// Replaces two TPU kernels of the JAX package:
// - the mark pass _mark_kernel_builder (sphexa_tpu/sph/pair_lists.py, its
//   pallas_call), here mark_kernel;
// - the list-walk engine group_pair_engine_lists (sphexa_tpu/sph/
//   pallas_pairs.py, its pallas_call) in the instantiations the JAX
//   dispatch sends there: std momentum/energy (list_walk<
//   MomentumEnergyStdOp>), VE momentum/energy (MomentumEnergyVeOp), the AV
//   switches (AvSwitchesOp) and divv/curlv with gradv (DivvCurlvOp<true>).
//
// A slot is one (run, chunk) pair of a group's candidate runs, in run
// order; a chunk is one 128-aligned row of the sorted arrays
// (row0 = start / 128, nch = (start % 128 + len + 127) / 128 chunks per run).
//
// Mark pass. One block of 128 threads per target group, one thread per lane
// of a chunk. The block reduces its group's bbox, inflates it by
// r = 2 max h + skin, then walks the build-time runs chunk by chunk: a lane
// is marked when its candidate lies in the run and its image position
// (x_j + shift, per axis) lies inside [min - r, max + r]. Each warp's
// __ballot_sync is one 32-bit word of the slot's 128-bit mask, written to
// bits[g][slot][warp]; after the walk the block counts every slot's marked
// lanes with __popc and zeroes the slots past its chunk total. Slots at or
// past slot_cap are not written (the chunk total still counts them: the
// host reads it as the overflow sentinel). The TPU kernel wrote one int32
// per lane, (NG, S_cap, 128); the bit masks are 32x smaller (28 MB at
// Sedov 100^3 against 896 MB). The bbox tests use __fadd_rn/__fsub_rn, so
// the marked set is the plain version's (and the JAX package's) bit for bit.
//
// What bounds the mark pass: it reads the x/y/z of every lane of every
// build-time chunk (the runs of neighbouring groups overlap, so mostly from
// L2) and does a dozen operations per lane; it runs once per list rebuild.
//
// List walk. One block per target group (blockDim = G, one thread per
// target, as in pair_engine.cu) walks the pruned runs' chunks in slot
// order. Per chunk every thread reads the slot's four mask words, takes the
// count with __popc, and compacts the marked lanes it owns (lanes t, t + G,
// ...) into a 256-entry shared-memory ring: a lane's rank is the __popc of
// the marked lanes below it. A staged entry holds the candidate's j-fields,
// its x/y/z with the run's shift added (__fadd_rn, K1's order) and its
// index for the self test. Whenever 128 staged candidates are waiting the
// block syncs and every thread runs the op's pair body over them; the tail
// (< 128) runs after the last chunk. The mask is K1's: d^2 < 4 h_i^2, the
// symmetric cutoff d^2 < 4 h_j^2, and not the self pair, with the same
// _rn intrinsics.
//
// The shared ring holds sj[NJ][256] floats: 29 KB for the av_clean VE
// momentum op's 29 j-fields, under the 48 KB of static shared memory.
//
// What bounds the list walk: the FP32 operations of the pair loop, as in
// K1, but over the marked lanes only (the candidates inside the group's
// skin-inflated bbox, a fraction of the streamed lanes). The ring keeps
// every math pass at a full tile of 128 candidates whatever each chunk's
// count, so the block syncs twice per 128 marked candidates, not per chunk.

#include <math_constants.h>

#include "pair_ops.cuh"

// Mirror of sphexa_torch.sph.pair_lists.MarkArgs (same field order).
struct MarkArgs {
    const int32_t* starts;   // (NG, W3) build-time runs
    const int32_t* lens;
    const float* shift_x;
    const float* shift_y;
    const float* shift_z;
    const int32_t* ncells;   // (NG,)
    const float* x;          // (n,) sorted positions and smoothing lengths
    const float* y;
    const float* z;
    const float* h;
    const float* skin;       // () device scalar: the coverage slack
    int32_t* bits;           // (NG, slot_cap, 4) marked-lane words
    int32_t* cnt;            // (NG, slot_cap) marked lanes per slot
    int32_t* total;          // (NG,) chunks of the group's runs
    int32_t n;
    int32_t num_groups;
    int32_t w3;
    int32_t group;
    int32_t slot_cap;
};

namespace {

constexpr int WORDS = TILE / 32;  // 32-bit mask words per chunk
constexpr int RING = 2 * TILE;    // staged candidates of the list walk

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

__global__ void __launch_bounds__(TILE) mark_kernel(const MarkArgs p) {
    __shared__ float red[7][WORDS];
    const int g = blockIdx.x;
    const int t = threadIdx.x;
    const int lane = t & 31;
    const int warp = t >> 5;

    // the group's bbox and max h (the tail group re-reads the last particle)
    float v[7] = {CUDART_INF_F, CUDART_INF_F, CUDART_INF_F,
                  -CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
    for (int k = t; k < p.group; k += TILE) {
        const int i = min(g * p.group + k, p.n - 1);
        const float xi = p.x[i], yi = p.y[i], zi = p.z[i];
        v[0] = fminf(v[0], xi);
        v[1] = fminf(v[1], yi);
        v[2] = fminf(v[2], zi);
        v[3] = fmaxf(v[3], xi);
        v[4] = fmaxf(v[4], yi);
        v[5] = fmaxf(v[5], zi);
        v[6] = fmaxf(v[6], p.h[i]);
    }
#pragma unroll
    for (int d = 0; d < 7; ++d) v[d] = d < 3 ? warp_min(v[d]) : warp_max(v[d]);
    if (lane == 0) {
#pragma unroll
        for (int d = 0; d < 7; ++d) red[d][warp] = v[d];
    }
    __syncthreads();
#pragma unroll
    for (int d = 0; d < 7; ++d) {
        float a = red[d][0];
        for (int w = 1; w < WORDS; ++w) a = d < 3 ? fminf(a, red[d][w]) : fmaxf(a, red[d][w]);
        v[d] = a;
    }
    const float r = __fadd_rn(__fmul_rn(2.0f, v[6]), *p.skin);
    const float lox = __fsub_rn(v[0], r), loy = __fsub_rn(v[1], r), loz = __fsub_rn(v[2], r);
    const float hix = __fadd_rn(v[3], r), hiy = __fadd_rn(v[4], r), hiz = __fadd_rn(v[5], r);

    const int S = p.slot_cap;
    int32_t* gbits = p.bits + static_cast<int64_t>(g) * S * WORDS;
    const int nrun = p.ncells[g];
    int slot_base = 0;
    for (int w = 0; w < nrun; ++w) {
        const int run = g * p.w3 + w;
        const int s = p.starts[run];
        const int len = p.lens[run];
        const float shx = p.shift_x[run], shy = p.shift_y[run], shz = p.shift_z[run];
        const int row0 = s / TILE;
        const int nch = (s - row0 * TILE + len + TILE - 1) / TILE;
        const int last = min(nch, S - slot_base);
        for (int c = 0; c < last; ++c) {
            const int cand = (row0 + c) * TILE + t;
            bool m = cand >= s && cand < s + len;
            if (m) {
                const float jx = __fadd_rn(p.x[cand], shx);
                const float jy = __fadd_rn(p.y[cand], shy);
                const float jz = __fadd_rn(p.z[cand], shz);
                m = jx >= lox && jx <= hix && jy >= loy && jy <= hiy && jz >= loz && jz <= hiz;
            }
            const unsigned word = __ballot_sync(0xffffffffu, m);
            if (lane == 0) gbits[(slot_base + c) * WORDS + warp] = static_cast<int32_t>(word);
        }
        slot_base += nch;
    }
    __syncthreads();  // the block's words are written and visible to it
    for (int sl = t; sl < S; sl += TILE) {
        int32_t* wd = gbits + sl * WORDS;
        int c = 0;
        if (sl < slot_base) {
#pragma unroll
            for (int k = 0; k < WORDS; ++k) c += __popc(static_cast<unsigned>(wd[k]));
        } else {
#pragma unroll
            for (int k = 0; k < WORDS; ++k) wd[k] = 0;  // dead slots read as empty
        }
        p.cnt[static_cast<int64_t>(g) * S + sl] = c;
    }
    if (t == 0) p.total[g] = slot_base;
}

// Pair math of one thread's target over `count` staged candidates from ring
// position `base` (0 or TILE; base + count <= RING). The mask is K1's.
template <class Op>
__device__ __forceinline__ void consume(const float (*sj)[RING], const int* sidx, int base,
                                        int count, const float* I, float h4, int tgt,
                                        float* acc, int& nc, const EngineArgs& p) {
    for (int k = base; k < base + count; ++k) {
        const float rx = __fsub_rn(I[0], sj[0][k]);
        const float ry = __fsub_rn(I[1], sj[1][k]);
        const float rz = __fsub_rn(I[2], sj[2][k]);
        const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(rx, rx), __fmul_rn(ry, ry)),
                                   __fmul_rn(rz, rz));
        bool mask = d2 < h4 && sidx[k] != tgt;
        if (p.sym_j >= 0) mask = mask && __fmul_rn(d2, sj[p.sym_j][k]) < 4.0f;
        if (mask) {
            Op::template pair<RING>(I, sj, k, rx, ry, rz, d2, acc, p);
            ++nc;
        }
    }
}

template <class Op>
__global__ void __launch_bounds__(256) list_walk(const EngineArgs p) {
    static_assert(Op::CUTOFF, "the list walk runs the SPH ops, which all cut off at 2 h_i");
    __shared__ float sj[Op::NJ][RING];
    __shared__ int sidx[RING];
    const int g = blockIdx.x;
    const int t = threadIdx.x;
    const int G = blockDim.x;
    const int tgt = g * G + t;
    const int ii = min(tgt, p.n - 1);  // tail threads re-read the last particle

    float I[Op::NI];
#pragma unroll
    for (int f = 0; f < Op::NI; ++f) I[f] = p.ifields[f][ii];
    const float h4 = __fmul_rn(__fmul_rn(4.0f, I[3]), I[3]);

    float acc[Op::NACC];
#pragma unroll
    for (int a = 0; a < Op::NACC; ++a) acc[a] = 0.0f;
    int nc = 0;

    const int S = p.slot_cap;
    const int4* gbits = reinterpret_cast<const int4*>(p.bits) + static_cast<int64_t>(g) * S;
    const int nrun = p.ncells[g];
    int slot = 0;     // slot of the current chunk
    int staged = 0;   // candidates staged so far (block-uniform)
    int done = 0;     // candidates consumed so far, a multiple of TILE
    for (int w = 0; w < nrun; ++w) {
        const int run = g * p.w3 + w;
        const int s = p.starts[run];
        const int len = p.lens[run];
        const float shx = p.shift_x[run], shy = p.shift_y[run], shz = p.shift_z[run];
        const int row0 = s / TILE;
        const int nch = (s - row0 * TILE + len + TILE - 1) / TILE;
        for (int c = 0; c < nch && slot < S; ++c, ++slot) {
            const int4 q = gbits[slot];
            const unsigned w0 = q.x, w1 = q.y, w2 = q.z, w3 = q.w;
            const int c0 = __popc(w0), c1 = __popc(w1), c2 = __popc(w2);
            const int cnt = c0 + c1 + c2 + __popc(w3);
            if (cnt == 0) continue;
            for (int l = t; l < TILE; l += G) {
                const int wi = l >> 5;
                const unsigned word = wi == 0 ? w0 : wi == 1 ? w1 : wi == 2 ? w2 : w3;
                const unsigned bit = 1u << (l & 31);
                if (!(word & bit)) continue;
                const int rank = __popc(word & (bit - 1u)) + (wi > 0 ? c0 : 0) +
                                 (wi > 1 ? c1 : 0) + (wi > 2 ? c2 : 0);
                const int pos = (staged + rank) & (RING - 1);
                const int cand = (row0 + c) * TILE + l;
                sj[0][pos] = __fadd_rn(p.jfields[0][cand], shx);
                sj[1][pos] = __fadd_rn(p.jfields[1][cand], shy);
                sj[2][pos] = __fadd_rn(p.jfields[2][cand], shz);
#pragma unroll
                for (int f = 3; f < Op::NJ; ++f) sj[f][pos] = p.jfields[f][cand];
                sidx[pos] = cand;
            }
            staged += cnt;
            if (staged - done >= TILE) {
                __syncthreads();  // the tile is staged
                consume<Op>(sj, sidx, done & (RING - 1), TILE, I, h4, tgt, acc, nc, p);
                done += TILE;
                __syncthreads();  // the tile is consumed before its half is restaged
            }
        }
    }
    if (staged > done) {
        __syncthreads();
        consume<Op>(sj, sidx, done & (RING - 1), staged - done, I, h4, tgt, acc, nc, p);
    }
    if (tgt < p.n) {
        float out[Op::NOUT];
        Op::finalize(I, acc, out, p);
#pragma unroll
        for (int o = 0; o < Op::NOUT; ++o) p.outs[o][tgt] = out[o];
        if (Op::WANT_NC && p.nc != nullptr) p.nc[tgt] = nc;
    }
}

template <class Op>
int launch_walk(const EngineArgs* a, void* stream) {
    if (a->num_groups <= 0) return 0;
    list_walk<Op><<<a->num_groups, a->group, 0, static_cast<cudaStream_t>(stream)>>>(*a);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int launch_mark(const MarkArgs* a, void* stream) {
    if (a->num_groups <= 0) return 0;
    mark_kernel<<<a->num_groups, TILE, 0, static_cast<cudaStream_t>(stream)>>>(*a);
    return static_cast<int>(cudaGetLastError());
}

int launch_momentum_energy_std_lists(const EngineArgs* a, void* stream) {
    return launch_walk<MomentumEnergyStdOp>(a, stream);
}

// divv/curlv takes the list walk only with gradv (the JAX dispatch streams
// the plain form over the pruned runs)
int launch_iad_divv_curlv_lists(const EngineArgs* a, void* stream) {
    if (!a->variant) return static_cast<int>(cudaErrorInvalidValue);
    return launch_walk<DivvCurlvOp<true>>(a, stream);
}

int launch_av_switches_lists(const EngineArgs* a, void* stream) {
    return launch_walk<AvSwitchesOp>(a, stream);
}

int launch_momentum_energy_ve_lists(const EngineArgs* a, void* stream) {
    return a->variant ? launch_walk<MomentumEnergyVeOp<true>>(a, stream)
                      : launch_walk<MomentumEnergyVeOp<false>>(a, stream);
}

}  // extern "C"
