// 3-D medial-axis thinning (Lee/Kashyap/Chu-style 6-subiteration erosion).
//
// Native replacement for skimage.morphology.skeletonize_3d used by the
// reference skeleton extractor (reference skeletonizer.py:244). The volume is
// iteratively eroded from the six face directions; a border voxel is deleted
// when (1) it is not a line endpoint, (2) deletion preserves the Euler
// characteristic of the closed-cube union of its 3x3x3 neighbourhood
// (26-connectivity object model), and (3) the foreground of its punctured
// 26-neighbourhood stays connected (simple point). Candidates are re-checked
// sequentially so parallel deletions cannot break topology.
//
// Exposed as a C ABI for ctypes; operates in place on a uint8 volume.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Vol {
  const uint8_t* data;
  int X, Y, Z;
  inline bool at(int x, int y, int z) const {
    if (x < 0 || y < 0 || z < 0 || x >= X || y >= Y || z >= Z) return false;
    return data[(static_cast<int64_t>(x) * Y + y) * Z + z] != 0;
  }
};

// --- Euler characteristic of a union of closed unit cubes ---------------
// Neighbourhood patch is 3x3x3 voxels; its cell complex lives on a 4x4x4
// vertex lattice. chi = V - E + F - C.
int euler_patch(const bool nb[3][3][3]) {
  bool vert[4][4][4] = {};
  bool ex[3][4][4] = {}, ey[4][3][4] = {}, ez[4][4][3] = {};
  bool fxy[3][3][4] = {}, fxz[3][4][3] = {}, fyz[4][3][3] = {};
  int cubes = 0;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      for (int k = 0; k < 3; ++k) {
        if (!nb[i][j][k]) continue;
        ++cubes;
        for (int a = 0; a < 2; ++a)
          for (int b = 0; b < 2; ++b) {
            for (int c = 0; c < 2; ++c) vert[i + a][j + b][k + c] = true;
            ex[i][j + a][k + b] = true;
            ey[i + a][j][k + b] = true;
            ez[i + a][j + b][k] = true;
          }
        fxy[i][j][k] = fxy[i][j][k + 1] = true;
        fxz[i][j][k] = fxz[i][j + 1][k] = true;
        fyz[i][j][k] = fyz[i + 1][j][k] = true;
      }
  int V = 0, E = 0, F = 0;
  for (auto& p2 : vert) for (auto& p1 : p2) for (bool v : p1) V += v;
  for (auto& p2 : ex) for (auto& p1 : p2) for (bool v : p1) E += v;
  for (auto& p2 : ey) for (auto& p1 : p2) for (bool v : p1) E += v;
  for (auto& p2 : ez) for (auto& p1 : p2) for (bool v : p1) E += v;
  for (auto& p2 : fxy) for (auto& p1 : p2) for (bool v : p1) F += v;
  for (auto& p2 : fxz) for (auto& p1 : p2) for (bool v : p1) F += v;
  for (auto& p2 : fyz) for (auto& p1 : p2) for (bool v : p1) F += v;
  return V - E + F - cubes;
}

void load_neighbourhood(const Vol& v, int x, int y, int z, bool nb[3][3][3]) {
  for (int i = -1; i <= 1; ++i)
    for (int j = -1; j <= 1; ++j)
      for (int k = -1; k <= 1; ++k)
        nb[i + 1][j + 1][k + 1] = v.at(x + i, y + j, z + k);
}

bool euler_invariant(bool nb[3][3][3]) {
  int with_p = euler_patch(nb);
  nb[1][1][1] = false;
  int without_p = euler_patch(nb);
  nb[1][1][1] = true;
  return with_p == without_p;
}

// foreground of punctured 26-neighbourhood stays one 26-component
bool is_simple(const bool nb[3][3][3]) {
  int label[27];
  int coords[27][3];
  int n = 0;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      for (int k = 0; k < 3; ++k) {
        if (i == 1 && j == 1 && k == 1) continue;
        if (nb[i][j][k]) {
          coords[n][0] = i; coords[n][1] = j; coords[n][2] = k;
          label[n] = n;
          ++n;
        }
      }
  if (n == 0) return false;
  // union-find over 26-adjacency
  std::vector<int> parent(n);
  for (int a = 0; a < n; ++a) parent[a] = a;
  auto find = [&](int a) {
    while (parent[a] != a) { parent[a] = parent[parent[a]]; a = parent[a]; }
    return a;
  };
  for (int a = 0; a < n; ++a)
    for (int b = a + 1; b < n; ++b) {
      int dx = coords[a][0] - coords[b][0];
      int dy = coords[a][1] - coords[b][1];
      int dz = coords[a][2] - coords[b][2];
      if (dx >= -1 && dx <= 1 && dy >= -1 && dy <= 1 && dz >= -1 && dz <= 1) {
        int ra = find(a), rb = find(b);
        if (ra != rb) parent[ra] = rb;
      }
    }
  int root = find(0);
  for (int a = 1; a < n; ++a)
    if (find(a) != root) return false;
  return true;
}

int count_fg_neighbours(const bool nb[3][3][3]) {
  int c = 0;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      for (int k = 0; k < 3; ++k)
        if (!(i == 1 && j == 1 && k == 1)) c += nb[i][j][k];
  return c;
}

const int DIRS[6][3] = {{0, 0, 1}, {0, 0, -1}, {0, 1, 0},
                        {0, -1, 0}, {1, 0, 0}, {-1, 0, 0}};

}  // namespace

extern "C" int apnerf_skeletonize3d(uint8_t* vol, int X, int Y, int Z,
                                    int max_iter) {
  Vol v{vol, X, Y, Z};
  auto idx = [&](int x, int y, int z) {
    return (static_cast<int64_t>(x) * Y + y) * Z + z;
  };
  std::vector<int64_t> cand;
  int iterations = 0;
  bool changed = true;
  while (changed && iterations < max_iter) {
    changed = false;
    ++iterations;
    for (auto& d : DIRS) {
      cand.clear();
      for (int x = 0; x < X; ++x)
        for (int y = 0; y < Y; ++y)
          for (int z = 0; z < Z; ++z) {
            if (!vol[idx(x, y, z)]) continue;
            // border point in direction d (6-neighbour in d is background)
            if (v.at(x + d[0], y + d[1], z + d[2])) continue;
            // anti-collapse guard: only erode if the object is >1 voxel
            // thick along d; otherwise a flat sheet/ribbon whose every voxel
            // is a d-border would be eaten greedily in a single pass.
            if (!v.at(x - d[0], y - d[1], z - d[2])) continue;
            bool nb[3][3][3];
            load_neighbourhood(v, x, y, z, nb);
            int nfg = count_fg_neighbours(nb);
            if (nfg <= 1) continue;  // endpoint: keep
            if (!euler_invariant(nb)) continue;
            nb[1][1][1] = false;
            if (!is_simple(nb)) continue;
            cand.push_back(idx(x, y, z));
          }
      // sequential re-check (other deletions may invalidate simplicity)
      for (int64_t c : cand) {
        int x = static_cast<int>(c / (static_cast<int64_t>(Y) * Z));
        int y = static_cast<int>((c / Z) % Y);
        int z = static_cast<int>(c % Z);
        if (!v.at(x - d[0], y - d[1], z - d[2])) continue;
        bool nb[3][3][3];
        load_neighbourhood(v, x, y, z, nb);
        int nfg = count_fg_neighbours(nb);
        if (nfg <= 1) continue;
        if (!euler_invariant(nb)) continue;
        nb[1][1][1] = false;
        if (!is_simple(nb)) continue;
        vol[c] = 0;
        changed = true;
      }
    }
  }
  return iterations;
}
