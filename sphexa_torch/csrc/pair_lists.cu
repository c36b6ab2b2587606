// Persistent neighbour lists for NVIDIA Hopper (sm_90a): the mark pass and
// the list walk.
//
// Replaces two TPU kernels of the JAX package:
// - the mark pass _mark_kernel_builder (sphexa_tpu/sph/pair_lists.py, its
//   pallas_call), here mark_kernel;
// - the list-walk engine group_pair_engine_lists (sphexa_tpu/sph/
//   pallas_pairs.py, its pallas_call), here list_walk<Op, SYM>, in
//   every SPH op of list mode: density (and xmass over it), IAD, grad-h,
//   both forms of divv/curlv, the AV switches, std and VE momentum/energy.
//   The JAX dispatch sends density, IAD, grad-h and plain divv/curlv to
//   the streaming engine over the pruned runs (its skip_slots form)
//   because the TPU favours dense 128-lane chunks; here the marks cost
//   nothing to use, and the pairs and their order are the same (every
//   pair within 2 h is among the marked lanes while the lists are valid).
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
// target). The block walks the pruned runs' chunks in slot order and cuts
// their marked lanes into windows of W candidates, which go through
// engine_window.cuh's pipeline as K1's windows do (pair_engine.cu: cp.async
// staging of positions and j-field rows, the mask phase, the per-lane
// body phase). Staging a window: every thread reads the slot's four mask
// words and counts them with __popc (block-uniform: the cursor of run,
// chunk, slot and lanes already taken advances the same in every thread,
// and a chunk may straddle two windows); window position pos is staged by
// thread pos % G, which finds the lane of rank pos - fill + r0 among the
// slot's marked lanes (select_bit) and issues its 4-byte cp.async copies.
// The run's shift is added on the consumer side, once the copies landed,
// with __fadd_rn in K1's order. The mask is K1's: d^2 < 4 h_i^2 and not
// the self pair, with the same _rn intrinsics; the momentum ops' symmetric
// cutoff is tested in the body phase. The mask depends on the positions
// and smoothing lengths only, so within a step the first walk (density,
// which counts neighbours) writes every thread's accepted-candidate words
// (EngineArgs.mask_mode 1: EngineArgs.mask_words, 4 bytes per target per
// 32 marked lanes, 160 MB at Sedov 100^3) and the later walks of the step
// read them (mode 2) instead of running the mask phase; the force stage
// names each walk's mode (pair_engine.py, mask=).
//
// What bounds the list walk: the same as K1 (the mask test, and the
// gathers of the body phase), over the marked lanes only: about a third
// of the pruned runs' lanes at Sedov resolution (1,332 of 3,735 per group
// at side 40). Staging costs a few dozen integer operations per marked
// lane (the rank select and the copies), which the mask phase's 64
// targets per candidate amortise. Measured on the H100 at Sedov 100^3
// (PERF.md, chip_smoke.py phase 8): density's walk 1.74 ms against a bound
// of 0.23 ms (the mask over 1.28e9 candidate pairs); IAD 1.88 ms running
// its own mask and 1.22 ms reading density's words, std momentum 3.24 and
// 2.56 ms: a walk that reads the words pays the staging, the word reads
// and its body, 8-11x their bound, the body phase's gathers (each lane at
// its own candidate's rows, bank conflicts) most of it.

#include <math_constants.h>

#include <cstring>

#include "engine_window.cuh"

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

// Rank-select: the position of the r-th (from 0) set bit of w.
__device__ __forceinline__ int select_bit(unsigned w, int r) {
    int pos = 0;
    int c = __popc(w & 0xFFFFu);
    if (r >= c) { r -= c; w >>= 16; pos += 16; }
    c = __popc(w & 0xFFu);
    if (r >= c) { r -= c; w >>= 8; pos += 8; }
    c = __popc(w & 0xFu);
    if (r >= c) { r -= c; w >>= 4; pos += 4; }
    c = __popc(w & 0x3u);
    if (r >= c) { r -= c; w >>= 2; pos += 2; }
    return pos + (r >= static_cast<int>(w & 1u) ? 1 : 0);
}

template <class Op, bool SYM>
__global__ void __launch_bounds__(MAX_BLOCK, min_blocks<Op>())
    list_walk(const __grid_constant__ EngineArgs p) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int g = blockIdx.x;
    const int t = threadIdx.x;
    const int G = blockDim.x;
    const int tgt = g * G + t;
    const int ii = min(tgt, p.n - 1);  // tail threads re-read the last particle

    float I[Op::NI];
#pragma unroll
    for (int f = 0; f < Op::NI; ++f) I[f] = p.ifields[f][ii];

    float acc[Op::NACC];
#pragma unroll
    for (int a = 0; a < Op::NACC; ++a) acc[a] = 0.0f;
    int nc = 0;

    const int S = p.slot_cap;
    const int4* gbits = reinterpret_cast<const int4*>(p.bits) + static_cast<int64_t>(g) * S;
    const int nrun = p.ncells[g];
    const int64_t row = static_cast<int64_t>(g) * p.w3;
    // staging cursor (block-uniform): run, chunk in the run, slot, and the
    // marked lanes of the slot already staged; the current run's start,
    // first row and chunk count, and the current slot's mask words (the
    // next slot's load is issued one slot ahead)
    int cw = 0, cc = 0, slot = 0, r0 = 0;
    int s = 0, row0 = 0, nch = 0;
    auto load_run = [&]() {
        if (cw < nrun) {
            s = p.starts[row + cw];
            const int len = p.lens[row + cw];
            row0 = s / TILE;
            nch = len > 0 ? (s - row0 * TILE + len + TILE - 1) / TILE : 0;
        }
    };
    load_run();
    int4 q = slot < S ? gbits[slot] : make_int4(0, 0, 0, 0);
    auto stage = [&](int b) {
        const WindowView v = window_view<Op::NJ>(smem, b);
        int fill = 0;
        while (fill < WINDOW && cw < nrun && slot < S) {
            if (cc >= nch) {  // an empty run holds no slot
                cc = 0;
                ++cw;
                load_run();
                continue;
            }
            const int4 qn = slot + 1 < S ? gbits[slot + 1] : q;
            const unsigned w0 = q.x, w1 = q.y, w2 = q.z, w3 = q.w;
            const int c0 = __popc(w0), c01 = c0 + __popc(w1), c012 = c01 + __popc(w2);
            const int cnt = c012 + __popc(w3);
            const int take = min(WINDOW - fill, cnt - r0);
            for (int pos = first_own(fill, t, G); pos < fill + take; pos += G) {
                const int r = r0 + pos - fill;  // rank among the slot's marked lanes
                const int lane = r < c0     ? select_bit(w0, r)
                                 : r < c01  ? 32 + select_bit(w1, r - c0)
                                 : r < c012 ? 64 + select_bit(w2, r - c01)
                                            : 96 + select_bit(w3, r - c012);
                stage_position(v, pos, (row0 + cc) * TILE + lane, cw, p);
            }
            fill += take;
            r0 += take;
            if (r0 >= cnt) {  // the slot is staged: on to the next chunk
                r0 = 0;
                ++slot;
                q = qn;
                if (++cc >= nch) {
                    cc = 0;
                    ++cw;
                    load_run();
                }
            }
        }
        return fill;
    };
    unsigned* gw = p.mask_words && p.mask_mode
                       ? p.mask_words + static_cast<int64_t>(p.word_off[g]) * G + t
                       : nullptr;
    window_pipeline<Op, false, SYM>(smem, stage, I, tgt, p.shift_x + row, p.shift_y + row,
                                       p.shift_z + row, 0.0f, 0.0f, 0.0f, acc, nc, p, gw,
                                       gw ? p.mask_mode : 0);

    if (tgt < p.n) {
        float out[Op::NOUT];
        Op::finalize(I, acc, out, p);
#pragma unroll
        for (int o = 0; o < Op::NOUT; ++o) p.outs[o][tgt] = out[o];
        if (Op::WANT_NC && p.nc != nullptr) p.nc[tgt] = nc;
    }
}

template <class Op, bool SYM>
int walk_k(const EngineArgs* a, cudaStream_t st, int32_t* info) {
    auto kern = list_walk<Op, SYM>;
    using L = WindowLayout<Op::NJ>;
    if (info) {
        const cudaError_t attr = set_window_attrs(kern, L::bytes(MAX_BLOCK));
        if (attr != cudaSuccess) return static_cast<int>(attr);
        return kernel_info(kern, L::bytes(a->group), a->group, info);
    }
    static const cudaError_t attr = set_window_attrs(kern, L::bytes(MAX_BLOCK));
    if (attr != cudaSuccess) return static_cast<int>(attr);
    kern<<<a->num_groups, a->group, L::bytes(a->group), st>>>(*a);
    return static_cast<int>(cudaGetLastError());
}

// one launch, or with `info` the instantiation's static facts instead;
// the symmetric cutoff is compiled in only for the ops that may take it
template <class Op>
int launch_walk(const EngineArgs* a, void* stream, int32_t* info = nullptr) {
    if (!info && a->num_groups <= 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if constexpr (Op::SYM) {
        if (a->sym_j >= 0) return walk_k<Op, true>(a, st, info);
    } else if (a->sym_j >= 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return walk_k<Op, false>(a, st, info);
}

// every list-walk entry point, by name (without the _lists suffix)
int walk_dispatch(const char* name, const EngineArgs* a, void* stream, int32_t* info) {
    const bool v = a->variant != 0;
    if (!std::strcmp(name, "density")) return launch_walk<DensityOp>(a, stream, info);
    if (!std::strcmp(name, "iad")) return launch_walk<IadOp>(a, stream, info);
    if (!std::strcmp(name, "momentum_energy_std"))
        return launch_walk<MomentumEnergyStdOp>(a, stream, info);
    if (!std::strcmp(name, "ve_def_gradh")) return launch_walk<VeDefGradhOp>(a, stream, info);
    if (!std::strcmp(name, "iad_divv_curlv"))
        return v ? launch_walk<DivvCurlvOp<true>>(a, stream, info)
                 : launch_walk<DivvCurlvOp<false>>(a, stream, info);
    if (!std::strcmp(name, "av_switches")) return launch_walk<AvSwitchesOp>(a, stream, info);
    if (!std::strcmp(name, "momentum_energy_ve"))
        return v ? launch_walk<MomentumEnergyVeOp<true>>(a, stream, info)
                 : launch_walk<MomentumEnergyVeOp<false>>(a, stream, info);
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

int launch_mark(const MarkArgs* a, void* stream) {
    if (a->num_groups <= 0) return 0;
    mark_kernel<<<a->num_groups, TILE, 0, static_cast<cudaStream_t>(stream)>>>(*a);
    return static_cast<int>(cudaGetLastError());
}

int launch_density_lists(const EngineArgs* a, void* stream) {
    return walk_dispatch("density", a, stream, nullptr);
}

int launch_iad_lists(const EngineArgs* a, void* stream) {
    return walk_dispatch("iad", a, stream, nullptr);
}

int launch_momentum_energy_std_lists(const EngineArgs* a, void* stream) {
    return walk_dispatch("momentum_energy_std", a, stream, nullptr);
}

int launch_ve_def_gradh_lists(const EngineArgs* a, void* stream) {
    return walk_dispatch("ve_def_gradh", a, stream, nullptr);
}

int launch_iad_divv_curlv_lists(const EngineArgs* a, void* stream) {
    return walk_dispatch("iad_divv_curlv", a, stream, nullptr);
}

int launch_av_switches_lists(const EngineArgs* a, void* stream) {
    return walk_dispatch("av_switches", a, stream, nullptr);
}

int launch_momentum_energy_ve_lists(const EngineArgs* a, void* stream) {
    return walk_dispatch("momentum_energy_ve", a, stream, nullptr);
}

// the static facts (kernel_info in engine_window.cuh) of the list-walk
// instantiation that launch_<name>_lists would run with these arguments
int list_walk_info(const char* name, const EngineArgs* a, int32_t* out) {
    return walk_dispatch(name, a, nullptr, out);
}

}  // extern "C"
