// Binary threaded-BVH closest-hit / any-hit traversal for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel cadrays_tpu/ops/pallas_traverse.py:
// _traverse_kernel (wrapper trace_pallas, the reference's "pallas"
// traversal backend). It computes what that kernel computes for every
// ray:
//   * a stackless walk of the threaded binary tree over nodes_packed
//     (N, 8) f32 rows [min xyz | max xyz | skip | leafbits], the last two
//     bitcast int32; the walk starts at node 0 and ends at node -1;
//   * the slab test against the ray's best t with the safe inverse
//     direction (+-1e-12 clamp), t_near * 0.9999996 clamped at >= 0 and
//     t_far * 1.0000004; a missed node moves on to its skip link;
//   * a hit inner node (leafbits < 0) descends to -leafbits - 2; a hit
//     leaf (first | count << 24, at most 4 triangles) runs
//     Moller-Trumbore on its triangles in the reference's component
//     order (det threshold 1e-12, eps 1e-7), updating only on a strictly
//     smaller t, then moves on to its skip link;
//   * initial t = min(t_max, 1e30); t_max <= 0 marks a dead lane, which
//     reports a miss;
//   * any-hit rays stop after their first hitting leaf.
//
// Design. The TPU walked a block of 2048 rays as one packet with a
// scalar node pointer, because it has no vector gather. This card
// gathers per thread, so each thread walks its own ray: the state is
// one node index, no stack at all.
//
// What bounds it: every step is a dependent load (node row -> slab test
// -> next node), so the walk is bound by load latency and divergence,
// not by DRAM bytes or fp32 throughput; the Cornell box's tables
// (2,691 nodes and 4,578 triangle rows, about 300 KB) sit in L2. This
// first version is one thread per ray and is not tuned.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false
//        -shared -Xcompiler -fPIC (see kernels/build.py). -fmad=false
// keeps every product rounded on its own, as the plain PyTorch version
// (ops/binary.py:trace_binary_ref) rounds it, so the two agree bit for
// bit.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_LEAF 4
#define LEAF_MASK 0x00FFFFFF

__device__ __forceinline__ float safe_inv(float c) {
    float s = (fabsf(c) < 1e-12f) ? ((c >= 0.0f) ? 1e-12f : -1e-12f) : c;
    return 1.0f / s;
}

__global__ void __launch_bounds__(128)
binary_trace_kernel(const float* __restrict__ origin,
                    const float* __restrict__ direction,
                    const float* __restrict__ t_max,
                    const float* __restrict__ nodes,
                    const float* __restrict__ tris,
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

    if (tm > 0.0f) {
        const float ix = safe_inv(dx);
        const float iy = safe_inv(dy);
        const float iz = safe_inv(dz);
        int node = 0;
        while (node >= 0) {
            const float4* row = reinterpret_cast<const float4*>(
                nodes + (size_t)node * 8);
            const float4 a = row[0];  // min xyz, max x
            const float4 b = row[1];  // max yz, skip, leafbits
            const int32_t skip = __float_as_int(b.z);
            const int32_t leafbits = __float_as_int(b.w);

            const float tx0 = (a.x - ox) * ix;
            const float ty0 = (a.y - oy) * iy;
            const float tz0 = (a.z - oz) * iz;
            const float tx1 = (a.w - ox) * ix;
            const float ty1 = (b.x - oy) * iy;
            const float tz1 = (b.y - oz) * iz;
            const float t_near = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                                       fminf(tz0, tz1));
            const float t_far = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                                      fmaxf(tz0, tz1));
            const bool hit = fmaxf(t_near * 0.9999996f, 0.0f)
                           <= fminf(t_far * 1.0000004f, t);
            if (!hit) {
                node = skip;
                continue;
            }
            if (leafbits < 0) {
                node = -leafbits - 2;
                continue;
            }
            const int first = leafbits & LEAF_MASK;
            const int count = leafbits >> 24;
#pragma unroll
            for (int k = 0; k < MAX_LEAF; ++k) {
                if (k >= count) break;
                const float* q = tris + (size_t)(first + k) * 12;
                const float r0 = q[0], r1 = q[1], r2 = q[2];
                const float r3 = q[3], r4 = q[4], r5 = q[5];
                const float r6 = q[6], r7 = q[7], r8 = q[8];
                const float pvx = dy * r8 - dz * r7;
                const float pvy = dz * r6 - dx * r8;
                const float pvz = dx * r7 - dy * r6;
                const float det = r3 * pvx + r4 * pvy + r5 * pvz;
                if (!(fabsf(det) > 1e-12f)) continue;
                const float inv_det = 1.0f / det;
                const float tvx = ox - r0;
                const float tvy = oy - r1;
                const float tvz = oz - r2;
                const float uu = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
                const float qvx = tvy * r5 - tvz * r4;
                const float qvy = tvz * r3 - tvx * r5;
                const float qvz = tvx * r4 - tvy * r3;
                const float vv = (dx * qvx + dy * qvy + dz * qvz) * inv_det;
                const float tt = (r6 * qvx + r7 * qvy + r8 * qvz) * inv_det;
                const bool h = (uu >= -1e-7f) & (vv >= -1e-7f)
                             & (uu + vv <= 1.0000001f) & (tt > 1e-7f);
                if (h && tt < t) {
                    t = tt; u = uu; v = vv; tri = first + k;
                }
            }
            if (any_hit && tri >= 0) break;
            node = skip;
        }
    }

    out_t[r] = t;
    out_tri[r] = tri;
    out_u[r] = u;
    out_v[r] = v;
}

extern "C" int crt_binary_trace(const float* origin, const float* direction,
                                const float* t_max, const float* nodes,
                                const float* tris, int n_rays, int any_hit,
                                float* out_t, int32_t* out_tri, float* out_u,
                                float* out_v, void* stream) {
    const int threads = 128;
    const int blocks = (n_rays + threads - 1) / threads;
    binary_trace_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        origin, direction, t_max, nodes, tris, n_rays, any_hit, out_t,
        out_tri, out_u, out_v);
    return (int)cudaGetLastError();
}
