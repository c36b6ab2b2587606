// Persistent neighbour lists for NVIDIA Hopper (sm_90a): the list build and
// the list walk.
//
// Replaces two TPU kernels of the JAX package:
// - the mark pass _mark_kernel_builder (sphexa_tpu/sph/pair_lists.py, its
//   pallas_call), here list_build_kernel, which also does the run merge
//   before it and the prune after it (XLA passes around the TPU kernel);
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
// List build. One block of 128 threads per target group takes the group's
// window^3 culled cells as pair_engine.window_cells_culled writes them
// (int64 starts and lengths, the bool verdict, float32 image shifts) and
// writes finished lists, the composition merge runs -> mark -> prune ->
// gathers of the plain version (pair_lists.build_lists_plain) bit for bit,
// in five phases over shared memory:
// 1. the group's bbox and max h, inflated by r = 2 max h + skin (__fadd_rn,
//    __fmul_rn, __fsub_rn: the plain version's float32 rounding);
// 2. the kept cells ranked by start by counting (ties by column: the stable
//    sort of pair_engine._merge_runs), and each cell's link to the one
//    before it (same image shift, gap within `gap` rows);
// 3. the run merge: one thread walks the ranked cells with the run_cap
//    test, the only sequential clause (a few hundred integer operations),
//    and writes each run's bounds and first slot;
// 4. the mark: each warp takes a slot at a time, lane l reading candidates
//    l + 32 k (k = 0..3) of the chunk, 12 independent loads in flight (12
//    resident blocks keep the rest of the SM's loads in flight); the
//    ballot of k is word k of the slot's 128-bit mask, kept in shared
//    memory with its popcount;
// 5. the prune (pair_lists._prune_empty_chunks): a slot is kept when it has
//    a marked lane, a kept slot heads a new run when it is its run's first
//    chunk or follows a slot that is not kept; one block scan over (kept,
//    head) gives every kept slot its compacted index and every head its
//    run index; a pruned run spans [max(run start, row 128) of its head,
//    min(run end, (row + 1) 128) of its last kept chunk). The tables, the
//    words and counts are written compacted with zero tails, no atomics.
// Slots at or past slot_cap are not marked; the chunk total still counts
// them (the host reads it as the overflow sentinel). The TPU kernel wrote
// one int32 per lane, (NG, S_cap, 128); the bit masks are 32x smaller.
//
// What bounds the list build: its bytes, the cull tables read once (29
// bytes a cell) and the lists written once, and the positions of every
// lane of every chunk it marks (the chunks of neighbouring groups overlap,
// so those come mostly from L2); a dozen operations per lane. Its phases
// wait on memory and on the block's barriers in turn, so resident blocks,
// not loads in flight per warp, set its speed (BUILD_MIN_BLOCKS). Its
// time beside its bound: PERF.md, chip_smoke.py phase 8.
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

#include <climits>
#include <cstring>

#include "engine_window.cuh"

// Mirror of sphexa_torch.sph.pair_lists.BuildArgs (same field order).
struct BuildArgs {
    const int64_t* cell_start;  // (NG, W3) window cells: first sorted-array row
    const int64_t* cell_len;    // (NG, W3) rows (capped), 0 where the cell is absent
    const uint8_t* cell_keep;   // (NG, W3) the cull's verdict (bool)
    const float* cell_shift;    // (NG, W3, 3) the cell's periodic image offset
    const float* x;             // (n,) sorted positions and smoothing lengths
    const float* y;
    const float* z;
    const float* h;
    const float* skin;          // () device scalar: the coverage slack
    int32_t* starts;            // (NG, slot_cap) pruned runs
    int32_t* lens;
    float* shift_x;
    float* shift_y;
    float* shift_z;
    int32_t* ncells;            // (NG,) pruned runs of each group
    int32_t* bits;              // (NG, slot_cap, 4) marked-lane words, pruned order
    int32_t* cnt;               // (NG, slot_cap) marked lanes per slot, pruned order
    int32_t* total;             // (NG,) chunks of the group's merged runs (unclipped)
    int32_t n;
    int32_t num_groups;
    int32_t w3;
    int32_t group;
    int32_t slot_cap;
    int32_t run_cap;
    int32_t gap;
};

namespace {

constexpr int WORDS = TILE / 32;       // 32-bit mask words per chunk
constexpr int BUILD_THREADS = 128;
constexpr int BUILD_WARPS = BUILD_THREADS / 32;
// Every phase of the build waits on memory or on its block's barriers, so
// it is compiled for 12 resident blocks (40 registers a thread, no
// spills), which hide each other's latency, rather than for more loads in
// flight a warp at fewer blocks.
constexpr int BUILD_MIN_BLOCKS = 12;

#ifndef PAIR_WENDLAND_TU  // the list build: in this file's own object only
// The build's shared memory, carved from one dynamic buffer: per window
// cell (W = w3) its key and, in start order, start, end, shift and link;
// per merged run its bounds, first slot and head cell; per slot its run,
// words and count; per pruned run its bounds and merged run.
struct BuildSmem {
    int* key;       // [W] start of a kept cell, INT_MAX for a dropped one
    int* cs;        // [W] kept cells in start order: start
    int* ce;        //     end
    int* link;      //     1 when the cell may join the run of the one before
    float* csh;     // [3 W] its image shift
    int* rs;        // [W] merged runs: start
    int* re;        //     end
    int* rhead;     //     the run's first cell (its shift)
    int* rfirst;    // [W + 1] first slot of each run; rfirst[nruns] the total
    int* srun;      // [S] run of each slot
    unsigned* sbits;  // [4 S] the slot's mask words
    int* scnt;      // [S] its marked lanes
    int* pst;       // [S] pruned runs: start
    int* pend;      //     end
    int* prun;      //     merged run (its shift)
};

__host__ __device__ constexpr size_t build_smem_bytes(int w3, int s) {
    return 4 * (static_cast<size_t>(w3) * 11 + 1 + static_cast<size_t>(s) * 9);
}

__device__ BuildSmem carve(unsigned char* smem, int W, int S) {
    int* p = reinterpret_cast<int*>(smem);
    BuildSmem m;
    m.key = p;
    m.cs = p += W;
    m.ce = p += W;
    m.link = p += W;
    m.csh = reinterpret_cast<float*>(p += W);
    m.rs = p += 3 * W;
    m.re = p += W;
    m.rhead = p += W;
    m.rfirst = p += W;
    m.srun = p += W + 1;
    m.sbits = reinterpret_cast<unsigned*>(p += S);
    m.scnt = p += 4 * S;
    m.pst = p += S;
    m.pend = p += S;
    m.prun = p += S;
    return m;
}

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

__global__ void __launch_bounds__(BUILD_THREADS, BUILD_MIN_BLOCKS)
    list_build_kernel(const BuildArgs p) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ float red[7][BUILD_WARPS];
    __shared__ unsigned wsum[BUILD_WARPS];
    __shared__ int nkept, nruns;
    const int g = blockIdx.x;
    const int t = threadIdx.x;
    const int lane = t & 31;
    const int warp = t >> 5;
    const int W = p.w3;
    const int S = p.slot_cap;
    const BuildSmem m = carve(smem, W, S);
    const int64_t cell0 = static_cast<int64_t>(g) * W;

    // 1. the group's bbox and max h (the tail group re-reads the last
    // particle); the keys of its cells
    if (t == 0) nkept = 0;
    float v[7] = {CUDART_INF_F, CUDART_INF_F, CUDART_INF_F,
                  -CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
    for (int k = t; k < p.group; k += BUILD_THREADS) {
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
    for (int i = t; i < W; i += BUILD_THREADS)
        m.key[i] = p.cell_keep[cell0 + i] ? static_cast<int>(p.cell_start[cell0 + i]) : INT_MAX;
    __syncthreads();
#pragma unroll
    for (int d = 0; d < 7; ++d) {
        float a = red[d][0];
        for (int w = 1; w < BUILD_WARPS; ++w) a = d < 3 ? fminf(a, red[d][w]) : fmaxf(a, red[d][w]);
        v[d] = a;
    }
    const float r = __fadd_rn(__fmul_rn(2.0f, v[6]), *p.skin);
    const float lox = __fsub_rn(v[0], r), loy = __fsub_rn(v[1], r), loz = __fsub_rn(v[2], r);
    const float hix = __fadd_rn(v[3], r), hiy = __fadd_rn(v[4], r), hiz = __fadd_rn(v[5], r);

    // 2. rank the kept cells by start (ties by column), in order
    for (int i = t; i < W; i += BUILD_THREADS) {
        const int ki = m.key[i];
        if (ki == INT_MAX) continue;
        int rank = 0;
        for (int j = 0; j < W; ++j) {
            const int kj = m.key[j];
            rank += (kj < ki) | ((kj == ki) & (j < i));
        }
        m.cs[rank] = ki;
        m.ce[rank] = ki + static_cast<int>(p.cell_len[cell0 + i]);
#pragma unroll
        for (int d = 0; d < 3; ++d) m.csh[3 * rank + d] = p.cell_shift[3 * (cell0 + i) + d];
        atomicAdd(&nkept, 1);
    }
    __syncthreads();
    const int nk = nkept;
    // the join clauses that do not depend on the open run: the same image
    // shift as the cell before and a gap of at most `gap` rows after its
    // end (the first cell is compared with a zero shift and an end of
    // -2^30, _merge_runs' initial carry)
    for (int k = t; k < nk; k += BUILD_THREADS) {
        const bool first = k == 0;
        const float px = first ? 0.0f : m.csh[3 * k - 3];
        const float py = first ? 0.0f : m.csh[3 * k - 2];
        const float pz = first ? 0.0f : m.csh[3 * k - 1];
        const long long prev_end = first ? -(1LL << 30) : m.ce[k - 1];
        m.link[k] = m.csh[3 * k] == px && m.csh[3 * k + 1] == py && m.csh[3 * k + 2] == pz &&
                    m.cs[k] - prev_end <= p.gap;
    }
    __syncthreads();

    // 3. the run merge: a cell joins the open run when linked and the run
    // stays within run_cap rows; a run ends at its cells' largest end
    if (t == 0) {
        int nr = 0, run_start = 0, run_end = 0, slots = 0;
        for (int k = 0; k < nk; ++k) {
            const int s = m.cs[k], e = m.ce[k];
            if (m.link[k] && e - run_start <= p.run_cap) {
                run_end = max(run_end, e);
                continue;
            }
            if (nr > 0) {
                const int rs0 = m.rs[nr - 1];
                m.re[nr - 1] = run_end;
                m.rfirst[nr - 1] = slots;
                slots += (rs0 % TILE + run_end - rs0 + TILE - 1) / TILE;
            }
            m.rs[nr] = s;
            m.rhead[nr] = k;
            ++nr;
            run_start = s;
            run_end = e;
        }
        if (nr > 0) {
            const int rs0 = m.rs[nr - 1];
            m.re[nr - 1] = run_end;
            m.rfirst[nr - 1] = slots;
            slots += (rs0 % TILE + run_end - rs0 + TILE - 1) / TILE;
        }
        m.rfirst[nr] = slots;
        nruns = nr;
    }
    __syncthreads();
    const int nr = nruns;
    const int total = m.rfirst[nr];
    const int nslots = min(total, S);
    for (int q = t; q < nr; q += BUILD_THREADS) {
        const int end = min(m.rfirst[q + 1], nslots);
        for (int sl = m.rfirst[q]; sl < end; ++sl) m.srun[sl] = q;
    }
    __syncthreads();

    // 4. the mark, a slot a warp at a time: lane l tests candidates
    // l + 32 k of the chunk that lie in the run at their image position
    // against the inflated bbox (12 independent loads a lane)
    for (int sl = warp; sl < nslots; sl += BUILD_WARPS) {
        const int q = m.srun[sl];
        const int rs0 = m.rs[q], re0 = m.re[q];
        const int row = rs0 / TILE + (sl - m.rfirst[q]);
        const float* sh = m.csh + 3 * m.rhead[q];
        bool in[WORDS];
        float jx[WORDS], jy[WORDS], jz[WORDS];
#pragma unroll
        for (int k = 0; k < WORDS; ++k) {
            const int cand = row * TILE + 32 * k + lane;
            in[k] = cand >= rs0 && cand < re0;
            jx[k] = in[k] ? __fadd_rn(p.x[cand], sh[0]) : 0.0f;
            jy[k] = in[k] ? __fadd_rn(p.y[cand], sh[1]) : 0.0f;
            jz[k] = in[k] ? __fadd_rn(p.z[cand], sh[2]) : 0.0f;
        }
        int c = 0;
#pragma unroll
        for (int k = 0; k < WORDS; ++k) {
            const bool mk = in[k] && jx[k] >= lox && jx[k] <= hix && jy[k] >= loy &&
                            jy[k] <= hiy && jz[k] >= loz && jz[k] <= hiz;
            const unsigned word = __ballot_sync(0xffffffffu, mk);
            c += __popc(word);
            if (lane == k) m.sbits[WORDS * sl + k] = word;
        }
        if (lane == 0) m.scnt[sl] = c;
    }
    __syncthreads();

    // 5. the prune: each thread takes `per` consecutive slots; one block
    // scan of (kept, heads), packed in one int (both < 2^16), gives each
    // kept slot its compacted index and each head its pruned run
    const int per = (S + BUILD_THREADS - 1) / BUILD_THREADS;
    const int s_lo = min(t * per, S), s_hi = min(s_lo + per, S);
    auto kept = [&](int sl) { return sl >= 0 && sl < nslots && m.scnt[sl] > 0; };
    auto first_chunk = [&](int sl) { return sl == m.rfirst[m.srun[sl]]; };
    unsigned mine = 0;
    for (int sl = s_lo; sl < s_hi; ++sl) {
        if (kept(sl)) mine += 1u + ((first_chunk(sl) || !kept(sl - 1)) ? 1u << 16 : 0u);
    }
    unsigned incl = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const unsigned y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y;
    }
    if (lane == 31) wsum[warp] = incl;
    __syncthreads();
    unsigned base = incl - mine, all = 0;
#pragma unroll
    for (int w = 0; w < BUILD_WARPS; ++w) {
        base += w < warp ? wsum[w] : 0;
        all += wsum[w];
    }
    const int nkept_slots = all & 0xffffu, nheads = all >> 16;
    int ko = base & 0xffffu, ho = base >> 16;
    int4* gbits = reinterpret_cast<int4*>(p.bits) + static_cast<int64_t>(g) * S;
    int32_t* gcnt = p.cnt + static_cast<int64_t>(g) * S;
    for (int sl = s_lo; sl < s_hi; ++sl) {
        if (!kept(sl)) continue;
        const unsigned* wd = m.sbits + WORDS * sl;
        gbits[ko] = make_int4(wd[0], wd[1], wd[2], wd[3]);
        gcnt[ko] = m.scnt[sl];
        ++ko;
        const int q = m.srun[sl];
        const int row = m.rs[q] / TILE + (sl - m.rfirst[q]);
        if (first_chunk(sl) || !kept(sl - 1)) {
            m.pst[ho] = max(m.rs[q], row * TILE);
            m.prun[ho] = q;
            ++ho;
        }
        if (!kept(sl + 1) || first_chunk(sl + 1)) m.pend[ho - 1] = min(m.re[q], (row + 1) * TILE);
    }
    for (int k = nkept_slots + t; k < S; k += BUILD_THREADS) {
        gbits[k] = make_int4(0, 0, 0, 0);
        gcnt[k] = 0;
    }
    __syncthreads();
    const int64_t row0 = static_cast<int64_t>(g) * S;
    for (int k = t; k < S; k += BUILD_THREADS) {
        int st = 0, ln = 0;
        float sx = 0.0f, sy = 0.0f, sz = 0.0f;
        if (k < nheads) {
            const float* sh = m.csh + 3 * m.rhead[m.prun[k]];
            st = m.pst[k];
            ln = m.pend[k] - st;
            sx = sh[0];
            sy = sh[1];
            sz = sh[2];
        }
        p.starts[row0 + k] = st;
        p.lens[row0 + k] = ln;
        p.shift_x[row0 + k] = sx;
        p.shift_y[row0 + k] = sy;
        p.shift_z[row0 + k] = sz;
    }
    if (t == 0) {
        p.ncells[g] = nheads;
        p.total[g] = total;
    }
}

// Lets the list build take `bytes` of dynamic shared memory (above the
// default 48 KB only by the attribute). A refused size is returned and
// cleared from the runtime's last error, so that it does not surface at
// the next launch's check.
cudaError_t allow_build_smem(size_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    const cudaError_t e = cudaFuncSetAttribute(
        list_build_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (e != cudaSuccess) cudaGetLastError();
    return e;
}
#endif  // PAIR_WENDLAND_TU

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

// every list-walk entry point, by name (without the _lists suffix), in the
// op form of NC polynomial coefficients
template <int NC>
int walk_dispatch_nc(const char* name, const EngineArgs* a, void* stream, int32_t* info) {
    const bool v = a->variant != 0;
    if (!std::strcmp(name, "density")) return launch_walk<DensityOp<NC>>(a, stream, info);
    if (!std::strcmp(name, "iad")) return launch_walk<IadOp<NC>>(a, stream, info);
    if (!std::strcmp(name, "momentum_energy_std"))
        return launch_walk<MomentumEnergyStdOp<NC>>(a, stream, info);
    if (!std::strcmp(name, "ve_def_gradh"))
        return launch_walk<VeDefGradhOp<NC>>(a, stream, info);
    if (!std::strcmp(name, "iad_divv_curlv"))
        return v ? launch_walk<DivvCurlvOp<true, NC>>(a, stream, info)
                 : launch_walk<DivvCurlvOp<false, NC>>(a, stream, info);
    if (!std::strcmp(name, "av_switches"))
        return launch_walk<AvSwitchesOp<NC>>(a, stream, info);
    if (!std::strcmp(name, "momentum_energy_ve"))
        return v ? launch_walk<MomentumEnergyVeOp<true, NC>>(a, stream, info)
                 : launch_walk<MomentumEnergyVeOp<false, NC>>(a, stream, info);
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

#ifdef PAIR_WENDLAND_TU
// pair_lists_wendland.cu: the wendland-c6 form's instantiations only
extern "C" int list_walk_dispatch_wendland(const char* name, const EngineArgs* a, void* stream,
                                           int32_t* info) {
    return walk_dispatch_nc<NCOEF_WENDLAND>(name, a, stream, info);
}
#else
// the wendland-c6 form lives in pair_lists_wendland.cu, built in an nvcc
// process of its own beside this one, as pair_engine.cu's
extern "C" int list_walk_dispatch_wendland(const char* name, const EngineArgs* a, void* stream,
                                           int32_t* info);

namespace {

int walk_dispatch(const char* name, const EngineArgs* a, void* stream, int32_t* info) {
    if (a->ncoef == NCOEF_SINC) return walk_dispatch_nc<NCOEF_SINC>(name, a, stream, info);
    if (a->ncoef == NCOEF_WENDLAND) return list_walk_dispatch_wendland(name, a, stream, info);
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// the list build: one block per group, shared memory sized from w3 and
// slot_cap (a size past the card's limit is refused)
int launch_mark(const BuildArgs* a, void* stream) {
    if (a->num_groups <= 0) return 0;
    const size_t bytes = build_smem_bytes(a->w3, a->slot_cap);
    const cudaError_t e = allow_build_smem(bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    list_build_kernel<<<a->num_groups, BUILD_THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
        *a);
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

// the list build's static facts at these sizes, in kernel_info's order
// (engine_window.cuh): registers, local bytes, static and dynamic shared
// bytes, resident blocks per SM, the chunk's lanes, resident warps per SM
int list_build_info(int w3, int slot_cap, int32_t* out) {
    const size_t bytes = build_smem_bytes(w3, slot_cap);
    cudaError_t e = allow_build_smem(bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    cudaFuncAttributes fa;
    e = cudaFuncGetAttributes(&fa, list_build_kernel);
    if (e != cudaSuccess) return static_cast<int>(e);
    int blocks = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, list_build_kernel, BUILD_THREADS,
                                                      bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    out[0] = fa.numRegs;
    out[1] = static_cast<int32_t>(fa.localSizeBytes);
    out[2] = static_cast<int32_t>(fa.sharedSizeBytes);
    out[3] = static_cast<int32_t>(bytes);
    out[4] = blocks;
    out[5] = TILE;
    out[6] = blocks * BUILD_WARPS;
    return 0;
}

// the static facts (kernel_info in engine_window.cuh) of the list-walk
// instantiation that launch_<name>_lists would run with these arguments
int list_walk_info(const char* name, const EngineArgs* a, int32_t* out) {
    return walk_dispatch(name, a, nullptr, out);
}

}  // extern "C"
#endif  // PAIR_WENDLAND_TU
