// bvh_convert.cpp — native BVH2 → BVH4 tooling (C++20).
//
// This framework's equivalent of the reference's offline native converter
// (reference tests/test.cpp → bin/test): loads the u32 BVH2.bin artifact,
// performs the O(N) index-preserving wide promotion, reports timing and
// leaf/internal counts, pretty-prints the tree to depth 3, and writes
// BVH4_wide.bin. Formats are the exact reference ABIs (PathTracer.js:8-13):
//   BVH2.bin      u32[1 + 6*M] — [numNodes2, (b0,b1,b2,left,right,meta)*M]
//   BVH4_wide.bin u32[1 + 8*M] — [numNodes4, (b0,b1,b2,c0..c3,meta)*M]
//
// Additionally exposes an extern "C" surface (promotion + the greedy
// re-emission collapse of PathTracer.js:506-667) so the Python runtime can
// call the native paths via ctypes when the shared library is built.
//
// Build: build.sh (produces both bin/bvh_convert and lib/libbvhtool.so).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <chrono>
#include <cmath>
#include <deque>
#include <vector>

namespace {

constexpr uint32_t kNode2Stride = 6;
constexpr uint32_t kNode4Stride = 8;
constexpr uint32_t kLeafFlag = 0x80000000u;
constexpr uint32_t kInvalid = 0xFFFFFFFFu;

inline size_t off2(uint32_t n) { return 1 + size_t(n) * kNode2Stride; }
inline size_t off4(uint32_t n) { return 1 + size_t(n) * kNode4Stride; }

// ---- fp16 helpers (decode + truncating encode, matching the JS codec) ----

float f16_to_f32(uint16_t h) {
  uint32_t s = uint32_t(h & 0x8000u) << 16;
  uint32_t e = (h >> 10) & 0x1F;
  uint32_t m = h & 0x03FF;
  uint32_t u;
  if (e == 0) {
    if (m == 0) {
      u = s;
    } else {
      e = 1;
      while ((m & 0x0400u) == 0) { m <<= 1; --e; }
      m &= 0x03FF;
      u = s | ((e + 112) << 23) | (m << 13);
    }
  } else if (e == 31) {
    u = s | 0x7F800000u | (m << 13);
  } else {
    u = s | ((e + 112) << 23) | (m << 13);
  }
  float out;
  std::memcpy(&out, &u, 4);
  return out;
}

uint16_t f32_to_f16_trunc(float v) {
  uint32_t u;
  std::memcpy(&u, &v, 4);
  uint32_t s = (u >> 16) & 0x8000u;
  int32_t e = int32_t((u >> 23) & 0xFF) - 112;
  uint32_t m = (u >> 13) & 0x03FF;
  if (e <= 0) return uint16_t(s);
  if (e >= 31) return uint16_t(s | 0x7C00u);
  return uint16_t(s | (uint32_t(e) << 10) | m);
}

struct Box {
  float mn[3], mx[3];
};

Box decode_bounds(const uint32_t* b) {
  auto lo = [](uint32_t u) { return f16_to_f32(uint16_t(u & 0xFFFF)); };
  auto hi = [](uint32_t u) { return f16_to_f32(uint16_t(u >> 16)); };
  return Box{{lo(b[0]), hi(b[0]), lo(b[1])}, {hi(b[1]), lo(b[2]), hi(b[2])}};
}

void encode_bounds_trunc(const Box& box, uint32_t* out) {
  auto pack = [](float a, float b) {
    return uint32_t(f32_to_f16_trunc(a)) | (uint32_t(f32_to_f16_trunc(b)) << 16);
  };
  out[0] = pack(box.mn[0], box.mn[1]);
  out[1] = pack(box.mn[2], box.mx[0]);
  out[2] = pack(box.mx[1], box.mx[2]);
}

bool leafish2_buf(const uint32_t* bvh2, uint32_t n, uint32_t num_nodes2) {
  if (n >= num_nodes2) return true;
  return (bvh2[off2(n) + 5] & kLeafFlag) != 0;
}

}  // namespace

extern "C" {

// O(N) index-preserving promotion (reference test.cpp:104-196 behavior).
// bvh2/out are full artifact images incl. the count header; out must have
// room for 1 + numNodes2*8 words. Returns numNodes4 (== numNodes2), and the
// leaf/internal counts through the out-params if non-null.
uint32_t bvh_promote_wide(const uint32_t* bvh2_buf, uint32_t* out_buf,
                          uint64_t* leaf_count, uint64_t* internal_count) {
  const uint32_t num_nodes2 = bvh2_buf[0];
  out_buf[0] = num_nodes2;
  uint64_t leaves = 0, internals = 0;
  for (uint32_t n = 0; n < num_nodes2; ++n) {
    const uint32_t* src = bvh2_buf + off2(n);
    uint32_t* dst = out_buf + off4(n);
    dst[0] = src[0];
    dst[1] = src[1];
    dst[2] = src[2];
    const uint32_t meta = src[5];
    if (meta & kLeafFlag) {
      ++leaves;
      dst[3] = dst[4] = dst[5] = dst[6] = kInvalid;
      dst[7] = meta;
      continue;
    }
    ++internals;
    uint32_t kids[4] = {kInvalid, kInvalid, kInvalid, kInvalid};
    uint32_t k = 0;
    for (uint32_t c : {src[3], src[4]}) {
      if (c == kInvalid) continue;
      const bool is_leaf = (c >= num_nodes2) || (bvh2_buf[off2(c) + 5] & kLeafFlag);
      if (is_leaf) {
        if (k < 4) kids[k++] = c;
      } else {
        if (k < 4) kids[k++] = bvh2_buf[off2(c) + 3];
        if (k < 4) kids[k++] = bvh2_buf[off2(c) + 4];
      }
    }
    dst[3] = kids[0];
    dst[4] = kids[1];
    dst[5] = kids[2];
    dst[6] = kids[3];
    dst[7] = 0;
  }
  if (leaf_count) *leaf_count = leaves;
  if (internal_count) *internal_count = internals;
  return num_nodes2;
}

// Greedy re-emission collapse (PathTracer.js:506-667 semantics): pre-order
// output, ≤4 grandchildren gathered by repeatedly expanding the first
// internal kid, internal bounds re-merged in f32 and truncation-packed.
// out_buf must have room for 1 + numNodes2*8 words (worst case: no
// contraction). Returns numNodes4. Iterative DFS — no recursion limits.
uint32_t bvh_collapse4(const uint32_t* bvh2_buf, uint32_t* out_buf) {
  const uint32_t num_nodes2 = bvh2_buf[0];
  if (num_nodes2 == 0) {
    out_buf[0] = 0;
    return 0;
  }
  uint32_t emitted = 0;
  auto emit = [&]() { return emitted++; };

  struct Frame {
    uint32_t node2;
    uint32_t idx4;
    uint32_t kids[4];
    int nkids;
    int next;
  };
  std::vector<Frame> stack;
  stack.reserve(128);

  auto gather_kids = [&](uint32_t n, uint32_t* kids) -> int {
    uint32_t buf[4] = {bvh2_buf[off2(n) + 3], bvh2_buf[off2(n) + 4], 0, 0};
    int len = 2;
    bool changed = true;
    while (len < 4 && changed) {
      changed = false;
      for (int i = 0; i < len; ++i) {
        const uint32_t k = buf[i];
        const bool is_leaf =
            k == kInvalid || leafish2_buf(bvh2_buf, k, num_nodes2);
        if (!is_leaf) {
          const uint32_t l = bvh2_buf[off2(k) + 3];
          const uint32_t r = bvh2_buf[off2(k) + 4];
          for (int j = len; j > i + 1; --j) buf[j] = buf[j - 1];
          buf[i] = l;
          buf[i + 1] = r;
          ++len;
          changed = true;
          break;
        }
      }
    }
    for (int i = 0; i < len && i < 4; ++i) kids[i] = buf[i];
    return len < 4 ? len : 4;
  };

  const uint32_t root_idx = emit();
  stack.push_back(Frame{0, root_idx, {0, 0, 0, 0}, -1, 0});

  while (!stack.empty()) {
    Frame& f = stack.back();
    const uint32_t meta = bvh2_buf[off2(f.node2) + 5];

    if (f.nkids < 0) {
      if (meta & kLeafFlag) {  // leaf passthrough
        uint32_t* dst = out_buf + off4(f.idx4);
        const uint32_t* src = bvh2_buf + off2(f.node2);
        dst[0] = src[0];
        dst[1] = src[1];
        dst[2] = src[2];
        dst[3] = dst[4] = dst[5] = dst[6] = kInvalid;
        dst[7] = meta;
        stack.pop_back();
        continue;
      }
      f.nkids = gather_kids(f.node2, f.kids);
      f.next = 0;
      // pre-clear child slots
      uint32_t* dst = out_buf + off4(f.idx4);
      dst[3] = dst[4] = dst[5] = dst[6] = kInvalid;
    }

    if (f.next < f.nkids) {
      const uint32_t child4 = emit();
      out_buf[off4(f.idx4) + 3 + f.next] = child4;
      const uint32_t child2 = f.kids[f.next];
      ++f.next;
      stack.push_back(Frame{child2, child4, {0, 0, 0, 0}, -1, 0});
      continue;
    }

    // merge children bounds in f32, truncate-pack
    Box box{{INFINITY, INFINITY, INFINITY}, {-INFINITY, -INFINITY, -INFINITY}};
    uint32_t* dst = out_buf + off4(f.idx4);
    for (int i = 0; i < 4; ++i) {
      const uint32_t ci = dst[3 + i];
      if (ci == kInvalid) continue;
      const Box cb = decode_bounds(out_buf + off4(ci));
      for (int a = 0; a < 3; ++a) {
        box.mn[a] = std::fmin(box.mn[a], cb.mn[a]);
        box.mx[a] = std::fmax(box.mx[a], cb.mx[a]);
      }
    }
    encode_bounds_trunc(box, dst);
    dst[7] = 0;
    stack.pop_back();
  }

  out_buf[0] = emitted;
  return emitted;
}

}  // extern "C"

#ifdef BVHTOOL_MAIN

#include <fstream>
#include <iostream>

static bool load_u32(const char* path, std::vector<uint32_t>& out) {
  std::ifstream f(path, std::ios::binary | std::ios::ate);
  if (!f) return false;
  const std::streamsize size = f.tellg();
  if (size <= 0 || (size & 3)) return false;
  f.seekg(0);
  out.resize(size_t(size) / 4);
  return bool(f.read(reinterpret_cast<char*>(out.data()), size));
}

static bool save_u32(const char* path, const std::vector<uint32_t>& data) {
  std::ofstream f(path, std::ios::binary);
  if (!f) return false;
  f.write(reinterpret_cast<const char*>(data.data()),
          std::streamsize(data.size() * 4));
  return bool(f);
}

static void print_depth3(const std::vector<uint32_t>& bvh4, uint32_t num_nodes4) {
  struct Item { uint32_t node, depth; };
  std::deque<Item> q{{0, 0}};
  std::cout << "\n=== BVH4 nodes to depth 3 ===\n";
  while (!q.empty()) {
    const Item it = q.front();
    q.pop_front();
    if (it.node >= num_nodes4) continue;
    const size_t o = off4(it.node);
    const uint32_t meta = bvh4[o + 7];
    std::cout << "Node " << it.node << " | depth " << it.depth << " | "
              << ((meta & kLeafFlag) ? "LEAF" : "INTERNAL") << " | kids: ";
    for (int i = 0; i < 4; ++i) {
      const uint32_t c = bvh4[o + 3 + i];
      if (c != kInvalid) std::cout << c << " ";
    }
    std::cout << "\n";
    if (it.depth == 3) continue;
    if (!(meta & kLeafFlag)) {
      for (int i = 0; i < 4; ++i) {
        const uint32_t c = bvh4[o + 3 + i];
        if (c != kInvalid) q.push_back({c, it.depth + 1});
      }
    }
  }
  std::cout << "=============================\n\n";
}

int main(int argc, char** argv) {
  const char* in_path = "data/BVH2.bin";
  const char* out_path = "data/BVH4_wide.bin";
  bool use_collapse = false;
  int argi = 1;
  if (argi < argc && std::strcmp(argv[argi], "--collapse") == 0) {
    use_collapse = true;
    ++argi;
  }
  if (argi < argc) in_path = argv[argi++];
  if (argi < argc) out_path = argv[argi++];

  std::vector<uint32_t> bvh2;
  if (!load_u32(in_path, bvh2)) {
    std::cerr << "error: cannot read " << in_path << "\n";
    return 1;
  }
  const uint32_t num_nodes2 = bvh2[0];
  std::vector<uint32_t> bvh4(1 + size_t(num_nodes2) * kNode4Stride, 0);

  uint64_t leaves = 0, internals = 0;
  const auto t0 = std::chrono::high_resolution_clock::now();
  uint32_t num_nodes4;
  if (use_collapse) {
    num_nodes4 = bvh_collapse4(bvh2.data(), bvh4.data());
    for (uint32_t n = 0; n < num_nodes4; ++n) {
      if (bvh4[off4(n) + 7] & kLeafFlag) ++leaves; else ++internals;
    }
  } else {
    num_nodes4 = bvh_promote_wide(bvh2.data(), bvh4.data(), &leaves, &internals);
  }
  const auto t1 = std::chrono::high_resolution_clock::now();
  const double ms = std::chrono::duration<double, std::milli>(t1 - t0).count();

  std::cout << (use_collapse ? "BVH2 -> BVH4 (collapse) time: "
                             : "BVH2 -> BVH4 (O(N) promote) time: ")
            << ms << " ms\n";
  std::cout << "leaves: " << leaves << " internals: " << internals << "\n";
  bvh4.resize(1 + size_t(num_nodes4) * kNode4Stride);
  print_depth3(bvh4, num_nodes4);
  if (!save_u32(out_path, bvh4)) {
    std::cerr << "error: cannot write " << out_path << "\n";
    return 1;
  }
  return 0;
}

#endif  // BVHTOOL_MAIN
