// Stream compaction of the gravity MAC classes for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel compact_class_lists
// (sphexa_tpu/gravity/pallas_compact.py, its _kernel and pallas_call):
// per row of a packed (B, C) int32 array (cls << 24) | idx, the class-0
// (M2P) and class-1 (P2P) values in candidate order, truncated at fixed
// caps, the tails zeroed, and the unclipped counts. The TPU kernel ranks
// lanes with MXU products and stages through a 256-lane window only
// because Mosaic has no lane shuffle; here a warp ranks its lanes with
// __ballot_sync and __popc, which is the contract without that blocking.
//
// Design. One CUDA block of CT threads per row. The row streams through in
// tiles of CT candidates, one per thread (coalesced loads). Per tile and
// class each warp takes the ballot of its lanes in that class; a lane's
// rank is the popcount of the ballot's lower bits, its warp's offset the
// sum of the lower warps' popcounts (CT/32 words in shared memory). A
// value goes to list_k[row, done_k + offset + rank] while that index is
// below cap_k, then done_k advances by the tile's count. After the last
// tile the block zeroes list_k past min(done_k, cap_k) and writes the
// unclipped counts. No atomics: the order is the candidate order, so the
// lists are bit-equal to the stable sort of the plain version.
//
// What bounds it on this card: device memory. Each packed word is read
// once and each list word written once (about 280 MB per Evrard 10^6
// solve); the per-tile work is two ballots, a few popcounts and two
// barriers.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int CT = 256;           // threads per block = candidates per tile
constexpr int WARPS = CT / 32;
constexpr int IDX_BITS = 24;
constexpr int32_t IDX_MASK = (1 << IDX_BITS) - 1;
constexpr int32_t DEAD = 2 << IDX_BITS;

__global__ void __launch_bounds__(CT)
compact_class_lists_kernel(const int32_t* __restrict__ packed, int C, int cap0, int cap1,
                           int32_t* __restrict__ list0, int32_t* __restrict__ list1,
                           int32_t* __restrict__ counts) {
    __shared__ int wcnt[2][WARPS];
    const int row = blockIdx.x;
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const int32_t* in = packed + static_cast<size_t>(row) * C;
    int32_t* out0 = list0 + static_cast<size_t>(row) * cap0;
    int32_t* out1 = list1 + static_cast<size_t>(row) * cap1;
    const unsigned below = (1u << lane) - 1u;  // the lanes under this one
    int done0 = 0, done1 = 0;
    for (int base = 0; base < C; base += CT) {
        const int i = base + t;
        const int32_t v = i < C ? __ldg(in + i) : DEAD;
        const int cls = v >> IDX_BITS;
        const unsigned b0 = __ballot_sync(0xffffffffu, cls == 0);
        const unsigned b1 = __ballot_sync(0xffffffffu, cls == 1);
        if (lane == 0) {
            wcnt[0][warp] = __popc(b0);
            wcnt[1][warp] = __popc(b1);
        }
        __syncthreads();
        int off0 = 0, off1 = 0, tot0 = 0, tot1 = 0;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
            const int c0 = wcnt[0][w], c1 = wcnt[1][w];
            if (w < warp) {
                off0 += c0;
                off1 += c1;
            }
            tot0 += c0;
            tot1 += c1;
        }
        if (cls == 0) {
            const int pos = done0 + off0 + __popc(b0 & below);
            if (pos < cap0) out0[pos] = v & IDX_MASK;
        } else if (cls == 1) {
            const int pos = done1 + off1 + __popc(b1 & below);
            if (pos < cap1) out1[pos] = v & IDX_MASK;
        }
        done0 += tot0;
        done1 += tot1;
        __syncthreads();  // the next tile rewrites wcnt
    }
    for (int k = min(done0, cap0) + t; k < cap0; k += CT) out0[k] = 0;
    for (int k = min(done1, cap1) + t; k < cap1; k += CT) out1[k] = 0;
    if (t == 0) {
        counts[2 * row] = done0;
        counts[2 * row + 1] = done1;
    }
}

}  // namespace

extern "C" {

// packed (B, C), list0 (B, cap0), list1 (B, cap1), counts (B, 2): all
// int32, contiguous, on the current device; launched on ``stream``.
int launch_compact_class_lists(const int32_t* packed, int B, int C, int cap0, int cap1,
                               int32_t* list0, int32_t* list1, int32_t* counts,
                               void* stream) {
    if (B <= 0) return 0;
    compact_class_lists_kernel<<<B, CT, 0, static_cast<cudaStream_t>(stream)>>>(
        packed, C, cap0, cap1, list0, list1, counts);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
