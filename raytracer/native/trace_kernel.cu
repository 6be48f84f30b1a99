// BVH traversal for NVIDIA Hopper, called from JAX through the XLA FFI.
//
// One thread per ray with its own 64-entry stack in local memory, after the
// reference's per-ray megakernel (renderer.wgsl:210-346). The tree is the
// packed layout of raytracer/ops/trace.py: node rows of 8*W floats (children
// box mnx, mny, mnz, mxx, mxy, mxz, then int32 ref and cnt, W slots each)
// and triangle records [v0, e1, e2, g] of 12 floats (three float4 loads).
// The visiting order, the tie rules and the outputs are exactly those of
// trace_reference in that module, which is this kernel's test oracle.
//
// Build: python -m raytracer.ops.cuda_trace

#include <cstdint>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kStack = 64;        // renderer.wgsl:8
constexpr int kBlock = 128;
constexpr float kInf = 1e30f;
constexpr float kEps = 1e-7f;     // renderer.wgsl:178

__device__ __forceinline__ float safe_inv(float x) {
  return fabsf(x) > 1e-8f ? 1.0f / x : kInf;
}

template <int W, bool kAnyHit>
__global__ void __launch_bounds__(kBlock)
trace_kernel(const float* __restrict__ nodes, const float4* __restrict__ tris,
             const int32_t* __restrict__ ids, const float* __restrict__ orig,
             const float* __restrict__ dir, const float* __restrict__ t_max,
             int64_t n, float* __restrict__ t_out, float* __restrict__ nx_out,
             float* __restrict__ ny_out, float* __restrict__ nz_out,
             int32_t* __restrict__ tri_out) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  const float ox = orig[3 * i], oy = orig[3 * i + 1], oz = orig[3 * i + 2];
  const float dx = dir[3 * i], dy = dir[3 * i + 1], dz = dir[3 * i + 2];
  const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);

  float best = t_max[i];
  int best_row = -1;
  int stack_e[kStack];
  float stack_d[kStack];
  int sp = (best > 0.0f) ? 0 : -1;   // t_max <= 0 (or NaN): inactive ray
  stack_e[0] = 0;
  stack_d[0] = -kInf;

  while (sp >= 0) {
    const int e = stack_e[sp];
    const float dist = stack_d[sp];
    --sp;
    if (!(dist < best)) continue;
    if (e >= 0) {
      // node: slab-test the W children, push the hits far -> near
      const float4* row = reinterpret_cast<const float4*>(nodes) +
                          static_cast<int64_t>(e) * (2 * W);
      float g[8][W];
#pragma unroll
      for (int q = 0; q < 2 * W; ++q) {
        const float4 v = __ldg(row + q);
        const int grp = (4 * q) / W, k = (4 * q) % W;
        g[grp][k] = v.x;
        g[grp][k + 1] = v.y;
        g[grp][k + 2] = v.z;
        g[grp][k + 3] = v.w;
      }
      float tmin[W];
      int ent[W];
      bool hit[W];
      int nhit = 0;
#pragma unroll
      for (int k = 0; k < W; ++k) {
        const float t1x = (g[0][k] - ox) * ix, t2x = (g[3][k] - ox) * ix;
        const float t1y = (g[1][k] - oy) * iy, t2y = (g[4][k] - oy) * iy;
        const float t1z = (g[2][k] - oz) * iz, t2z = (g[5][k] - oz) * iz;
        const float tn = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)),
                               fminf(t1z, t2z));
        const float tf = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)),
                               fmaxf(t1z, t2z));
        const int ref = __float_as_int(g[6][k]);
        const int cnt = __float_as_int(g[7][k]);
        hit[k] = cnt >= 0 && tf >= fmaxf(tn, 0.0f) && tn < best;
        tmin[k] = tn;
        ent[k] = cnt > 0 ? ~((ref << 6) | (cnt - 1)) : ref;
        nhit += hit[k] ? 1 : 0;
      }
      // stable ascending rank by entry distance; rank 0 is pushed last
#pragma unroll
      for (int k = 0; k < W; ++k) {
        if (!hit[k]) continue;
        int rank = 0;
#pragma unroll
        for (int j = 0; j < W; ++j) {
          rank += (j != k && hit[j] &&
                   (tmin[j] < tmin[k] || (tmin[j] == tmin[k] && j < k)))
                      ? 1 : 0;
        }
        const int pos = sp + nhit - rank;
        if (pos <= kStack - 1) {
          stack_e[pos] = ent[k];
          stack_d[pos] = tmin[k];
        }
      }
      sp = min(sp + nhit, kStack - 1);
    } else {
      // leaf: Moller-Trumbore over its triangles in row order
      const int code = ~e;
      const int first = code >> 6;
      const int cnt = (code & 63) + 1;
      for (int j = 0; j < cnt; ++j) {
        const float4* r = tris + 3 * static_cast<int64_t>(first + j);
        const float4 a = __ldg(r), b = __ldg(r + 1), c = __ldg(r + 2);
        const float e1x = a.w, e1y = b.x, e1z = b.y;
        const float e2x = b.z, e2y = b.w, e2z = c.x;
        const float px = dy * e2z - dz * e2y;
        const float py = dz * e2x - dx * e2z;
        const float pz = dx * e2y - dy * e2x;
        const float det = e1x * px + e1y * py + e1z * pz;
        const float inv_det = 1.0f / (det == 0.0f ? 1.0f : det);
        const float sx = ox - a.x, sy = oy - a.y, sz = oz - a.z;
        const float u = inv_det * (sx * px + sy * py + sz * pz);
        const float qx = sy * e1z - sz * e1y;
        const float qy = sz * e1x - sx * e1z;
        const float qz = sx * e1y - sy * e1x;
        const float v = inv_det * (dx * qx + dy * qy + dz * qz);
        const float t = inv_det * (e2x * qx + e2y * qy + e2z * qz);
        if (fabsf(det) >= kEps && u >= 0.0f && u <= 1.0f && v >= 0.0f &&
            u + v <= 1.0f && t > kEps && t < best) {
          best = t;
          best_row = first + j;
          if (kAnyHit) {
            sp = -1;
            break;
          }
        }
      }
    }
  }

  if (best_row >= 0) {
    const float4 c = __ldg(tris + 3 * static_cast<int64_t>(best_row) + 2);
    const float s = rsqrtf(c.y * c.y + c.z * c.z + c.w * c.w);
    t_out[i] = best;
    nx_out[i] = c.y * s;
    ny_out[i] = c.z * s;
    nz_out[i] = c.w * s;
    tri_out[i] = ids[best_row];
  } else {
    t_out[i] = kInf;
    nx_out[i] = 0.0f;
    ny_out[i] = 0.0f;
    nz_out[i] = 0.0f;
    tri_out[i] = -1;
  }
}

template <int W, bool kAnyHit>
void launch(cudaStream_t stream, int64_t n, const float* nodes,
            const float* tris, const int32_t* ids, const float* orig,
            const float* dir, const float* t_max, float* t, float* nx,
            float* ny, float* nz, int32_t* tri) {
  const int64_t blocks = (n + kBlock - 1) / kBlock;
  trace_kernel<W, kAnyHit><<<static_cast<unsigned>(blocks), kBlock, 0, stream>>>(
      nodes, reinterpret_cast<const float4*>(tris), ids, orig, dir, t_max, n,
      t, nx, ny, nz, tri);
}

ffi::Error TraceImpl(cudaStream_t stream, ffi::Buffer<ffi::F32> nodes,
                     ffi::Buffer<ffi::F32> tris, ffi::Buffer<ffi::S32> ids,
                     ffi::Buffer<ffi::F32> orig, ffi::Buffer<ffi::F32> dir,
                     ffi::Buffer<ffi::F32> t_max,
                     ffi::ResultBuffer<ffi::F32> t,
                     ffi::ResultBuffer<ffi::F32> nx,
                     ffi::ResultBuffer<ffi::F32> ny,
                     ffi::ResultBuffer<ffi::F32> nz,
                     ffi::ResultBuffer<ffi::S32> tri, bool any_hit) {
  const auto nd = nodes.dimensions();
  if (nd.size() != 2 || (nd[1] != 32 && nd[1] != 64)) {
    return ffi::Error::InvalidArgument("nodes must be (M, 32) or (M, 64)");
  }
  const auto td = tris.dimensions();
  if (td.size() != 2 || td[1] != 12 ||
      ids.element_count() != static_cast<size_t>(td[0])) {
    return ffi::Error::InvalidArgument("tris must be (T, 12) with (T,) ids");
  }
  const int64_t n = static_cast<int64_t>(t_max.element_count());
  if (orig.element_count() != static_cast<size_t>(3 * n) ||
      dir.element_count() != static_cast<size_t>(3 * n)) {
    return ffi::Error::InvalidArgument("origins/directions must be (R, 3)");
  }
  if (n == 0) return ffi::Error::Success();
#define RT_LAUNCH(W, ANY)                                                    \
  launch<W, ANY>(stream, n, nodes.typed_data(), tris.typed_data(),           \
                 ids.typed_data(), orig.typed_data(), dir.typed_data(),      \
                 t_max.typed_data(), t->typed_data(), nx->typed_data(),      \
                 ny->typed_data(), nz->typed_data(), tri->typed_data())
  if (nd[1] == 32) {
    if (any_hit) RT_LAUNCH(4, true); else RT_LAUNCH(4, false);
  } else {
    if (any_hit) RT_LAUNCH(8, true); else RT_LAUNCH(8, false);
  }
#undef RT_LAUNCH
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(RtTrace, TraceImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()   // nodes
                                  .Arg<ffi::Buffer<ffi::F32>>()   // tris
                                  .Arg<ffi::Buffer<ffi::S32>>()   // ids
                                  .Arg<ffi::Buffer<ffi::F32>>()   // origins
                                  .Arg<ffi::Buffer<ffi::F32>>()   // directions
                                  .Arg<ffi::Buffer<ffi::F32>>()   // t_max
                                  .Ret<ffi::Buffer<ffi::F32>>()   // t
                                  .Ret<ffi::Buffer<ffi::F32>>()   // nx
                                  .Ret<ffi::Buffer<ffi::F32>>()   // ny
                                  .Ret<ffi::Buffer<ffi::F32>>()   // nz
                                  .Ret<ffi::Buffer<ffi::S32>>()   // tri
                                  .Attr<bool>("any_hit"));
