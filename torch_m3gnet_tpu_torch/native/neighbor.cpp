// Cell-list PBC neighbour search and three-body enumeration (host side).
//
// Own copy of torch_m3gnet_tpu/native/neighbor.cpp for the PyTorch port:
// O(N) cell binning with periodic ghost expansion; emits a full directed
// edge list grouped by source atom with deterministic (dst, shift) ordering
// within each source, the order of the numpy path of data/neighborlist.py.
// torch_m3gnet_tpu_torch/native/__init__.py builds it with
// g++ -O3 -shared -fPIC -std=c++17 into _build/ at first use and binds it
// with ctypes.
//
// C ABI:
//   m3g_neighbor_list(lattice[9] row-major rows a1,a2,a3,
//                     pos[3n], n, cutoff,
//                     cap, out_src[cap], out_dst[cap], out_shift[3*cap],
//                     out_dist[cap])
//   returns number of edges, or -(needed) if cap was insufficient.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

struct Ghost {
  double x, y, z;
  int32_t atom;
  int16_t s0, s1, s2;
};

struct Edge {
  int64_t dst;
  int16_t s0, s1, s2;
  double dist;
};

inline void invert3(const double a[9], double inv[9]) {
  const double det = a[0] * (a[4] * a[8] - a[5] * a[7]) -
                     a[1] * (a[3] * a[8] - a[5] * a[6]) +
                     a[2] * (a[3] * a[7] - a[4] * a[6]);
  const double id = 1.0 / det;
  inv[0] = (a[4] * a[8] - a[5] * a[7]) * id;
  inv[1] = (a[2] * a[7] - a[1] * a[8]) * id;
  inv[2] = (a[1] * a[5] - a[2] * a[4]) * id;
  inv[3] = (a[5] * a[6] - a[3] * a[8]) * id;
  inv[4] = (a[0] * a[8] - a[2] * a[6]) * id;
  inv[5] = (a[2] * a[3] - a[0] * a[5]) * id;
  inv[6] = (a[3] * a[7] - a[4] * a[6]) * id;
  inv[7] = (a[1] * a[6] - a[0] * a[7]) * id;
  inv[8] = (a[0] * a[4] - a[1] * a[3]) * id;
}

}  // namespace

extern "C" int64_t m3g_neighbor_list(const double* lattice, const double* pos,
                                     int64_t n, double cutoff, int64_t cap,
                                     int64_t* out_src, int64_t* out_dst,
                                     int64_t* out_shift, double* out_dist) {
  if (n == 0) return 0;
  const double c2 = cutoff * cutoff;

  // Image bounds per lattice direction: ceil(cutoff / plane spacing) + 1,
  // spacing_i = 1 / |row_i(inv(A)^T)| = 1 / |col_i(inv(A))|.
  double inv[9];
  invert3(lattice, inv);
  int nb[3];
  for (int i = 0; i < 3; ++i) {
    const double bx = inv[0 + i], by = inv[3 + i], bz = inv[6 + i];
    const double blen = std::sqrt(bx * bx + by * by + bz * bz);
    nb[i] = static_cast<int>(std::ceil(cutoff * blen)) + 1;
  }

  // Bounding box of home atoms, expanded by cutoff.
  double lo[3] = {1e300, 1e300, 1e300}, hi[3] = {-1e300, -1e300, -1e300};
  for (int64_t i = 0; i < n; ++i)
    for (int d = 0; d < 3; ++d) {
      lo[d] = std::min(lo[d], pos[3 * i + d]);
      hi[d] = std::max(hi[d], pos[3 * i + d]);
    }
  for (int d = 0; d < 3; ++d) {
    lo[d] -= cutoff * 1.000001;
    hi[d] += cutoff * 1.000001;
  }

  // Ghost expansion with bbox pruning.
  std::vector<Ghost> ghosts;
  ghosts.reserve(static_cast<size_t>(n) * 8);
  for (int s0 = -nb[0]; s0 <= nb[0]; ++s0)
    for (int s1 = -nb[1]; s1 <= nb[1]; ++s1)
      for (int s2 = -nb[2]; s2 <= nb[2]; ++s2) {
        const double ox = s0 * lattice[0] + s1 * lattice[3] + s2 * lattice[6];
        const double oy = s0 * lattice[1] + s1 * lattice[4] + s2 * lattice[7];
        const double oz = s0 * lattice[2] + s1 * lattice[5] + s2 * lattice[8];
        for (int64_t j = 0; j < n; ++j) {
          const double x = pos[3 * j] + ox, y = pos[3 * j + 1] + oy,
                       z = pos[3 * j + 2] + oz;
          if (x < lo[0] || x > hi[0] || y < lo[1] || y > hi[1] || z < lo[2] ||
              z > hi[2])
            continue;
          ghosts.push_back({x, y, z, static_cast<int32_t>(j),
                            static_cast<int16_t>(s0), static_cast<int16_t>(s1),
                            static_cast<int16_t>(s2)});
        }
      }

  // Grid of cell size >= cutoff over the bbox.
  int dims[3];
  double cell[3];
  for (int d = 0; d < 3; ++d) {
    dims[d] = std::max(1, static_cast<int>((hi[d] - lo[d]) / cutoff));
    cell[d] = (hi[d] - lo[d]) / dims[d] + 1e-12;
  }
  const int64_t ncell = static_cast<int64_t>(dims[0]) * dims[1] * dims[2];
  auto cell_of = [&](double x, double y, double z) -> int64_t {
    int cx = std::min(dims[0] - 1, std::max(0, (int)((x - lo[0]) / cell[0])));
    int cy = std::min(dims[1] - 1, std::max(0, (int)((y - lo[1]) / cell[1])));
    int cz = std::min(dims[2] - 1, std::max(0, (int)((z - lo[2]) / cell[2])));
    return (static_cast<int64_t>(cx) * dims[1] + cy) * dims[2] + cz;
  };

  // Counting sort of ghosts into cells.
  std::vector<int64_t> cell_start(ncell + 1, 0);
  std::vector<int32_t> ghost_cell(ghosts.size());
  for (size_t g = 0; g < ghosts.size(); ++g) {
    ghost_cell[g] = static_cast<int32_t>(
        cell_of(ghosts[g].x, ghosts[g].y, ghosts[g].z));
    ++cell_start[ghost_cell[g] + 1];
  }
  for (int64_t c = 0; c < ncell; ++c) cell_start[c + 1] += cell_start[c];
  std::vector<int32_t> cell_items(ghosts.size());
  {
    std::vector<int64_t> cur(cell_start.begin(), cell_start.end() - 1);
    for (size_t g = 0; g < ghosts.size(); ++g)
      cell_items[cur[ghost_cell[g]]++] = static_cast<int32_t>(g);
  }

  int64_t count = 0;
  std::vector<Edge> local;
  local.reserve(256);
  for (int64_t i = 0; i < n; ++i) {
    local.clear();
    const double xi = pos[3 * i], yi = pos[3 * i + 1], zi = pos[3 * i + 2];
    const int cx = std::min(dims[0] - 1, std::max(0, (int)((xi - lo[0]) / cell[0])));
    const int cy = std::min(dims[1] - 1, std::max(0, (int)((yi - lo[1]) / cell[1])));
    const int cz = std::min(dims[2] - 1, std::max(0, (int)((zi - lo[2]) / cell[2])));
    for (int dx = -1; dx <= 1; ++dx) {
      const int gx = cx + dx;
      if (gx < 0 || gx >= dims[0]) continue;
      for (int dy = -1; dy <= 1; ++dy) {
        const int gy = cy + dy;
        if (gy < 0 || gy >= dims[1]) continue;
        for (int dz = -1; dz <= 1; ++dz) {
          const int gz = cz + dz;
          if (gz < 0 || gz >= dims[2]) continue;
          const int64_t cid = (static_cast<int64_t>(gx) * dims[1] + gy) * dims[2] + gz;
          for (int64_t it = cell_start[cid]; it < cell_start[cid + 1]; ++it) {
            const Ghost& g = ghosts[cell_items[it]];
            const double ddx = g.x - xi, ddy = g.y - yi, ddz = g.z - zi;
            const double d2 = ddx * ddx + ddy * ddy + ddz * ddz;
            if (d2 > c2 || d2 < 1e-16) continue;
            local.push_back({g.atom, g.s0, g.s1, g.s2, std::sqrt(d2)});
          }
        }
      }
    }
    std::sort(local.begin(), local.end(), [](const Edge& a, const Edge& b) {
      if (a.dst != b.dst) return a.dst < b.dst;
      if (a.s0 != b.s0) return a.s0 < b.s0;
      if (a.s1 != b.s1) return a.s1 < b.s1;
      return a.s2 < b.s2;
    });
    for (const Edge& e : local) {
      if (count < cap) {
        out_src[count] = i;
        out_dst[count] = e.dst;
        out_shift[3 * count] = e.s0;
        out_shift[3 * count + 1] = e.s1;
        out_shift[3 * count + 2] = e.s2;
        out_dist[count] = e.dist;
      }
      ++count;
    }
  }
  return count <= cap ? count : -count;
}

// Three-body (triplet) index enumeration: all ordered pairs of distinct
// edges sharing a source node, both within the 3-body cutoff.
//
// Emission order matches the numpy path of data/triplets.py exactly:
// participating edges of a node keep ascending edge-id order; pairs emitted
// as (j-slot major, k-slot minor, k != j). Returns T, or -(needed) if cap
// was insufficient.
extern "C" int64_t m3g_threebody(const int64_t* edge_src,
                                 const double* dist, int64_t num_nodes,
                                 int64_t num_edges, double cutoff,
                                 int64_t cap, int64_t* out_e1,
                                 int64_t* out_e2, int64_t* out_per_node,
                                 int64_t* out_per_edge) {
  // Counting sort of participating edges by source (stable: edge ids stay
  // ascending within a node regardless of provider ordering).
  std::vector<int64_t> deg(num_nodes, 0);
  for (int64_t e = 0; e < num_edges; ++e) {
    out_per_edge[e] = 0;
    if (dist[e] <= cutoff) ++deg[edge_src[e]];
  }
  std::vector<int64_t> start(num_nodes + 1, 0);
  for (int64_t i = 0; i < num_nodes; ++i) start[i + 1] = start[i] + deg[i];
  std::vector<int64_t> slots(start[num_nodes]);
  {
    std::vector<int64_t> fill(start.begin(), start.end() - 1);
    for (int64_t e = 0; e < num_edges; ++e)
      if (dist[e] <= cutoff) slots[fill[edge_src[e]]++] = e;
  }

  int64_t total = 0;
  for (int64_t i = 0; i < num_nodes; ++i) {
    const int64_t d = deg[i];
    out_per_node[i] = d * (d - 1);
    total += d * (d - 1);
  }
  if (total > cap) return -total;

  int64_t t = 0;
  for (int64_t i = 0; i < num_nodes; ++i) {
    const int64_t lo = start[i], hi = start[i + 1];
    const int64_t d = hi - lo;
    if (d < 2) continue;
    for (int64_t j = lo; j < hi; ++j) {
      out_per_edge[slots[j]] = d - 1;
      const int64_t e1 = slots[j];
      for (int64_t k = lo; k < hi; ++k) {
        if (k == j) continue;
        out_e1[t] = e1;
        out_e2[t] = slots[k];
        ++t;
      }
    }
  }
  return t;
}
