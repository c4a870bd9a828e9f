// BVH8 closest-hit / any-hit traversal for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel cadrays_tpu/ops/pallas_wide.py:_make_kernel in
// its variants (a) non-instanced, (b) instanced (two-level TLAS/BLAS),
// (c) hbm_tris and (d) seeded stacks. One source serves all four: (b)
// is the template parameter INSTANCED, (d) the optional `start` table,
// and (c) is (a) or (b) itself (see below). For every ray it computes
// what that kernel computes:
//   * stack walk of the wide tree: entries are wide nodes (-widx - 2,
//     root = -2) or merged leaves (first | count << 24);
//   * per-child slab test as _slab8: safe inverse direction with the
//     +-1e-12 clamp, t_near * 0.9999996 clamped at >= 0,
//     t_far * 1.0000004, hit iff t_near <= min(t_far, t_cap); empty
//     slots (meta 0x7FFFFFFF) are never pushed;
//   * hit children pushed far-to-near by the octant of the ray's WORLD
//     direction (x >= 0 -> bit 0, y -> bit 1, z -> bit 2) from worder's
//     rank nibbles, each entry carrying its t_near; a pop whose t_near
//     is greater than the ray's best t is skipped;
//   * Moller-Trumbore leaf tests (det threshold 1e-12, eps 1e-7) in the
//     reference's operation order; a hit updates only on a strictly
//     smaller t, so the lower k wins within a leaf and the earlier leaf
//     across leaves;
//   * any-hit rays stop at their first hitting leaf.
// Variant (b) adds, as pallas_wide.py:181-195, 208-211, 240-241,
// 262-277, 366-377, 452-454:
//   * each stack entry carries an instance id (the root -1); a pushed
//     child takes winst[widx, k] when that is >= 0, else its parent's;
//   * every pop moves the ray into the entry's space through the 3x4
//     row instinv[inst] (row n_inst is the identity, for -1): the
//     direction is not renormalised, so t stays in world units, and its
//     safe inverse is recomputed there;
//   * leaves index the compact shared-BLAS table (wtris_packed), and a
//     hit adds wdelta[inst] (0 in the identity slot) in int32, which
//     gives the fused per-instance triangle id.
// Variant (c), hbm_tris (pallas_wide.py:279-290, 480-554, 613): on the
// TPU a triangle table above VMEM stays in HBM and each leaf's rows are
// DMA'd into a two-slot buffer while the previous leaf is tested. This
// card has no such split to manage: the kernel reads the (T, 12) table
// from device memory through L1 and L2 at any row count, so (c) is (a)
// or (b) over a large table. The deferred leaf changed only when a leaf
// was tested, not the order of the tests, so the closest hit is the
// same up to ties.
// Variant (d), seeded stacks (pallas_wide.py:221-241, 622-626): with a
// `start` table of (nb, 4) rows [meta0, inst0, meta1, inst1], thread r
// starts from row r / block instead of the root: stack[0] = meta0 with
// instance inst0, stack[1] = meta1 with inst1 where meta1 is not
// 0x7FFFFFFF (so meta1 pops first), both at entry distance 0, and an
// empty stack when meta0 is 0x7FFFFFFF. A seed is a wide node or a
// leaf of an instance's BLAS. trace_wide_rebinned (ops/wide.py) builds
// the table.
//
// Design. The TPU walked a block of rays as one packet because it has no
// vector gather; this card has gathers, so each thread walks its own ray
// with its own stack (STACK_CAP int32 entries + float entry distances,
// + int32 instance ids in variant (b), in local memory). The host
// wrapper (ops/wide.py) checks that 1 + 7 * depth <= STACK_CAP before
// launching.
//
// What bounds it: the walk is a chain of dependent loads (pop -> node
// row -> 8 slab tests -> pushes -> pop) per thread, so it is bound by
// load latency and divergence, not by DRAM bytes or fp32 throughput:
// the tables of the Cornell box (about 230 KB) and of the 100-torus
// assembly (about 280 KB: 98 wide nodes, 5,312 compact triangles) sit
// in L2, and the 54-part distinct assembly's (611,264 compact rows of
// 48 B, 29 MB, and 3,483 wide nodes) fits its 50 MB. This first version is one thread per ray with a local-memory
// stack and is not tuned (no shared-memory stack, no ray reordering
// inside the kernel, no persistent threads).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false
//        -shared -Xcompiler -fPIC (see kernels/build.py). -fmad=false
// keeps every product rounded on its own, as the plain PyTorch version
// (ops/wide.py:trace_wide_ref) rounds it, so the two agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#define STACK_CAP 192
#define WIDTH 8
#define EMPTY_SLOT 0x7FFFFFFF
#define LEAF_MASK 0x00FFFFFF

__device__ __forceinline__ float safe_inv(float c) {
    float s = (fabsf(c) < 1e-12f) ? ((c >= 0.0f) ? 1e-12f : -1e-12f) : c;
    return 1.0f / s;
}

template <bool INSTANCED>
__global__ void __launch_bounds__(128)
wide_trace_kernel(const float* __restrict__ origin,
                  const float* __restrict__ direction,
                  const float* __restrict__ t_max,
                  const float* __restrict__ wboxes,
                  const int32_t* __restrict__ wmeta,
                  const int32_t* __restrict__ worder,
                  const float* __restrict__ tris,
                  const int32_t* __restrict__ winst,
                  const float* __restrict__ instinv,
                  const int32_t* __restrict__ wdelta,
                  const int32_t* __restrict__ start, int block, int n_inst,
                  int n_rays, int any_hit,
                  float* __restrict__ out_t, int32_t* __restrict__ out_tri,
                  float* __restrict__ out_u, float* __restrict__ out_v) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= n_rays) return;

    const float ox = origin[3 * r + 0];
    const float oy = origin[3 * r + 1];
    const float oz = origin[3 * r + 2];
    const float dx = direction[3 * r + 0];
    const float dy = direction[3 * r + 1];
    const float dz = direction[3 * r + 2];
    const float tm = t_max[r];

    float t = fminf(tm, 1e30f);
    int32_t tri = -1;
    float u = 0.0f, v = 0.0f;

    if (tm > 0.0f) {  // t_max <= 0 marks a dead lane: it reports a miss
        const float ix = safe_inv(dx);
        const float iy = safe_inv(dy);
        const float iz = safe_inv(dz);
        const int oct = (dx >= 0.0f ? 1 : 0) | (dy >= 0.0f ? 2 : 0)
                      | (dz >= 0.0f ? 4 : 0);

        int32_t stack[STACK_CAP];
        float tstk[STACK_CAP];
        int32_t istk[INSTANCED ? STACK_CAP : 1];
        int sp = 1;
        stack[0] = -2;
        tstk[0] = 0.0f;
        istk[0] = -1;
        if (start != nullptr) {  // variant (d): the block's seeds
            const int32_t* seed = start + (size_t)(r / block) * 4;
            const int32_t m0 = seed[0];
            const int32_t m1 = seed[2];
            stack[0] = m0;
            if constexpr (INSTANCED) istk[0] = seed[1];
            sp = 0;
            if (m0 != EMPTY_SLOT) {
                sp = 1;
                if (m1 != EMPTY_SLOT) {
                    stack[1] = m1;
                    tstk[1] = 0.0f;
                    if constexpr (INSTANCED) istk[1] = seed[3];
                    sp = 2;
                }
            }
        }

        while (sp > 0) {
            --sp;
            const int32_t e = stack[sp];
            if (tstk[sp] > t) continue;  // the tightened t excludes it

            // the ray in the entry's space (world space in variant a)
            float lox = ox, loy = oy, loz = oz;
            float ldx = dx, ldy = dy, ldz = dz;
            float lix = ix, liy = iy, liz = iz;
            int slot = 0;  // row of instinv / wdelta
            int32_t inst = -1;
            if constexpr (INSTANCED) {
                inst = istk[sp];
                slot = inst < 0 ? n_inst : inst;
                const float* m = instinv + (size_t)slot * 12;
                lox = m[0] * ox + m[1] * oy + m[2] * oz + m[3];
                loy = m[4] * ox + m[5] * oy + m[6] * oz + m[7];
                loz = m[8] * ox + m[9] * oy + m[10] * oz + m[11];
                ldx = m[0] * dx + m[1] * dy + m[2] * dz;
                ldy = m[4] * dx + m[5] * dy + m[6] * dz;
                ldz = m[8] * dx + m[9] * dy + m[10] * dz;
                lix = safe_inv(ldx);
                liy = safe_inv(ldy);
                liz = safe_inv(ldz);
            }

            if (e >= 0) {
                const int first = e & LEAF_MASK;
                const int count = (int)((uint32_t)e >> 24);
                float bt = t, bu = 0.0f, bv = 0.0f;
                int bk = -1;
                for (int k = 0; k < count; ++k) {
                    const float* row = tris + (size_t)(first + k) * 12;
                    const float r0 = row[0], r1 = row[1], r2 = row[2];
                    const float r3 = row[3], r4 = row[4], r5 = row[5];
                    const float r6 = row[6], r7 = row[7], r8 = row[8];
                    const float pvx = ldy * r8 - ldz * r7;
                    const float pvy = ldz * r6 - ldx * r8;
                    const float pvz = ldx * r7 - ldy * r6;
                    const float det = r3 * pvx + r4 * pvy + r5 * pvz;
                    if (!(fabsf(det) > 1e-12f)) continue;
                    const float inv_det = 1.0f / det;
                    const float tvx = lox - r0;
                    const float tvy = loy - r1;
                    const float tvz = loz - r2;
                    const float uu = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
                    const float qvx = tvy * r5 - tvz * r4;
                    const float qvy = tvz * r3 - tvx * r5;
                    const float qvz = tvx * r4 - tvy * r3;
                    const float vv = (ldx * qvx + ldy * qvy + ldz * qvz) * inv_det;
                    const float tt = (r6 * qvx + r7 * qvy + r8 * qvz) * inv_det;
                    const bool hit = (uu >= -1e-7f) & (vv >= -1e-7f)
                                   & (uu + vv <= 1.0000001f) & (tt > 1e-7f);
                    if (hit && tt < bt) {
                        bt = tt; bu = uu; bv = vv; bk = k;
                    }
                }
                if (bk >= 0) {
                    t = bt; u = bu; v = bv; tri = first + bk;
                    if constexpr (INSTANCED) tri += wdelta[slot];
                    if (any_hit) break;
                }
            } else {
                const int w = -e - 2;
                const float* b = wboxes + (size_t)w * (WIDTH * 6);
                const int32_t* meta = wmeta + (size_t)w * WIDTH;
                const uint32_t rword = (uint32_t)worder[(size_t)w * 8 + oct];
                float tn[WIDTH];
                unsigned push = 0;
#pragma unroll
                for (int k = 0; k < WIDTH; ++k) {
                    const float tx0 = (b[6 * k + 0] - lox) * lix;
                    const float ty0 = (b[6 * k + 1] - loy) * liy;
                    const float tz0 = (b[6 * k + 2] - loz) * liz;
                    const float tx1 = (b[6 * k + 3] - lox) * lix;
                    const float ty1 = (b[6 * k + 4] - loy) * liy;
                    const float tz1 = (b[6 * k + 5] - loz) * liz;
                    float t_near = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                                         fminf(tz0, tz1));
                    float t_far = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                                        fmaxf(tz0, tz1));
                    t_near = fmaxf(t_near * 0.9999996f, 0.0f);
                    t_far = t_far * 1.0000004f;
                    tn[k] = t_near;
                    if (t_near <= fminf(t_far, t) && meta[k] != EMPTY_SLOT)
                        push |= 1u << k;
                }
                // far-to-near: rank 0 (farthest) goes deepest
#pragma unroll
                for (int rank = 0; rank < WIDTH; ++rank) {
#pragma unroll
                    for (int k = 0; k < WIDTH; ++k) {
                        if (((rword >> (4 * k)) & 0xFu) == (uint32_t)rank
                                && ((push >> k) & 1u)) {
                            stack[sp] = meta[k];
                            tstk[sp] = tn[k];
                            if constexpr (INSTANCED) {
                                const int32_t ik = winst[(size_t)w * WIDTH + k];
                                istk[sp] = ik >= 0 ? ik : inst;
                            }
                            ++sp;
                        }
                    }
                }
            }
        }
    }

    out_t[r] = t;
    out_tri[r] = tri;
    out_u[r] = u;
    out_v[r] = v;
}

// instanced != 0 selects variant (b); winst, instinv ((n_inst + 1) x 12,
// identity last) and wdelta (n_inst + 1, 0 last) are then required, and
// tris is the compact shared-BLAS table. Variant (a) ignores them.
// start != NULL selects variant (d): (ceil(n_rays / block), 4) seeds.
extern "C" int crt_wide_trace(const float* origin, const float* direction,
                              const float* t_max, const float* wboxes,
                              const int32_t* wmeta, const int32_t* worder,
                              const float* tris, const int32_t* winst,
                              const float* instinv, const int32_t* wdelta,
                              const int32_t* start, int block,
                              int n_inst, int n_rays, int any_hit,
                              int instanced, float* out_t, int32_t* out_tri,
                              float* out_u, float* out_v, void* stream) {
    const int threads = 128;
    const int blocks = (n_rays + threads - 1) / threads;
    if (instanced) {
        wide_trace_kernel<true><<<blocks, threads, 0, (cudaStream_t)stream>>>(
            origin, direction, t_max, wboxes, wmeta, worder, tris, winst,
            instinv, wdelta, start, block, n_inst, n_rays, any_hit, out_t,
            out_tri, out_u, out_v);
    } else {
        wide_trace_kernel<false><<<blocks, threads, 0, (cudaStream_t)stream>>>(
            origin, direction, t_max, wboxes, wmeta, worder, tris, winst,
            instinv, wdelta, start, block, n_inst, n_rays, any_hit, out_t,
            out_tri, out_u, out_v);
    }
    return (int)cudaGetLastError();
}
