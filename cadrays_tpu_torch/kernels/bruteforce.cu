// Brute-force closest-hit ray-triangle intersection for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel cadrays_tpu/ops/mxu_intersect.py:
// _intersect_kernel (wrapper trace_bruteforce, the reference's
// "bruteforce" traversal backend). It computes what that kernel
// computes for every ray:
//   * against every triangle, the four Moller-Trumbore products from
//     the ray's features X = [o, d, m = o x d, 1] and the triangle's
//     constants [n | k | c2 | c3 | e1 | e2] (ops/bruteforce.tri_tables):
//       det = -d.n, t.det = o.n - k, u.det = -d.c2 + m.e2,
//       v.det = -d.c3 - m.e1,
//     each the sum of its nonzero terms in feature order;
//   * the sign-folded hit test: s = sign(det), a = u.det*s,
//     b = v.det*s, c = t.det*s, hit iff |det| > 1e-12, a >= -1e-7|det|,
//     b >= -1e-7|det|, a + b <= |det|(1 + 1e-7), c > 1e-7|det| and
//     c < t_max|det|;
//   * t = c * (1 / max(|det|, 1e-30)), an IEEE reciprocal and then a
//     multiply, as pl.reciprocal(approx=False) computes it;
//   * a strict-< running argmin in triangle order, from
//     best t = min(t_max, 1e30): among equal t the smallest index wins;
//     zero padding rows have det = 0 and never hit. Any-hit queries run
//     the same reduction.
// The wrapper (ops/bruteforce.py) then recomputes exact t, u, v on the
// winning triangle, as the reference does outside its kernel.
//
// Design. The TPU took the four products as one X @ W matmul on its
// matrix unit. Here they stay in fp32 on CUDA cores: TF32 tensor cores
// round the inputs to 10 mantissa bits, which loses closer hits. One
// thread per ray; a block of 256 rays stages tiles of 512 triangles
// (32 KB of constants) in shared memory, and every thread reads the
// same triangle at once (a broadcast, no bank conflicts).
//
// What bounds it: R x Tpad tests of about 50 fp32 operations each
// (1.21e9 tests for 262,144 rays against the Cornell box's 4,608 padded
// rows), so it is bound by fp32 operations, not bytes; -fmad=false
// doubles the instruction count of the products against fused
// multiply-adds.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false
//        -shared -Xcompiler -fPIC (see kernels/build.py). -fmad=false
// keeps every product rounded on its own, as the plain PyTorch version
// (ops/bruteforce.py:trace_bruteforce_ref) rounds it, so the two agree
// bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#define TRI_TILE 512
#define THREADS 256

__global__ void __launch_bounds__(THREADS)
bruteforce_kernel(const float* __restrict__ origin,
                  const float* __restrict__ direction,
                  const float* __restrict__ t_max,
                  const float4* __restrict__ table,  // (n_tri, 16) f32
                  int n_tri, int n_rays, int32_t* __restrict__ out_tri) {
    __shared__ float4 tile[TRI_TILE * 4];
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    const bool live = r < n_rays;
    const int rr = live ? r : 0;

    const float ox = origin[3 * rr + 0];
    const float oy = origin[3 * rr + 1];
    const float oz = origin[3 * rr + 2];
    const float dx = direction[3 * rr + 0];
    const float dy = direction[3 * rr + 1];
    const float dz = direction[3 * rr + 2];
    const float tm = t_max[rr];
    const float mx = oy * dz - oz * dy;
    const float my = oz * dx - ox * dz;
    const float mz = ox * dy - oy * dx;

    const float cap = fminf(tm, 1e30f);
    float best_t = cap;
    int best_i = -1;

    for (int base = 0; base < n_tri; base += TRI_TILE) {
        __syncthreads();  // the previous tile is no longer read
        for (int i = threadIdx.x; i < TRI_TILE * 4; i += THREADS)
            tile[i] = table[(size_t)base * 4 + i];
        __syncthreads();
        for (int j = 0; j < TRI_TILE; ++j) {
            const float4 w0 = tile[4 * j + 0];  // n xyz, k
            const float4 w1 = tile[4 * j + 1];  // c2 xyz, c3 x
            const float4 w2 = tile[4 * j + 2];  // c3 yz, e1 xy
            const float4 w3 = tile[4 * j + 3];  // e1 z, e2 xyz
            const float det = (-(dx * w0.x) - dy * w0.y) - dz * w0.z;
            const float tdet = ((ox * w0.x + oy * w0.y) + oz * w0.z) - w0.w;
            const float udet = ((((-(dx * w1.x) - dy * w1.y) - dz * w1.z)
                                 + mx * w3.y) + my * w3.z) + mz * w3.w;
            const float vdet = ((((-(dx * w1.w) - dy * w2.x) - dz * w2.y)
                                 - mx * w2.z) - my * w2.w) - mz * w3.x;
            const float s = det >= 0.0f ? 1.0f : -1.0f;
            const float dabs = fabsf(det);
            const float a = udet * s;
            const float b = vdet * s;
            const float c = tdet * s;
            const float tol = 1e-7f * dabs;
            const bool hit = (dabs > 1e-12f) & (a >= -tol) & (b >= -tol)
                           & (a + b <= dabs * 1.0000001f)
                           & (c > 1e-7f * dabs) & (c < tm * dabs);
            if (hit) {
                const float tv = c * (1.0f / fmaxf(dabs, 1e-30f));
                if (tv < best_t) {
                    best_t = tv;
                    best_i = base + j;
                }
            }
        }
    }
    if (live) out_tri[r] = best_t < cap ? best_i : -1;
}

extern "C" int crt_bruteforce(const float* origin, const float* direction,
                              const float* t_max, const float* table,
                              int n_tri, int n_rays, int32_t* out_tri,
                              void* stream) {
    if (n_tri % TRI_TILE != 0) return (int)cudaErrorInvalidValue;
    const int blocks = (n_rays + THREADS - 1) / THREADS;
    bruteforce_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        origin, direction, t_max, reinterpret_cast<const float4*>(table),
        n_tri, n_rays, out_tri);
    return (int)cudaGetLastError();
}
