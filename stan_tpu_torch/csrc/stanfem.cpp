// Copied from native/stanfem.cpp, without stanfem_node_incidence (the
// port builds its incidence tables in numpy, fem/operator.node_incidence),
// and with the general operator's float64 host twin added at the end.
//
// The host runtime of stan_tpu_torch: plain C++ with OpenMP that runs on
// the CPU beside the card, with a C ABI bound by ctypes
// (stan_tpu_torch/native.py). It is built at first use with the host C++
// compiler into stan_tpu_torch/_build/ (stan_tpu_torch/_build.py); it holds
// no CUDA code and replaces no kernel. Its functions:
//   * the data loader: the Nastran .bdf parser (reference semantics:
//     src/STAN_Database/Node.cs:25-80 GRID fields,
//     src/STAN_Database/Element.cs:35-73 CHEXA cards,
//     src/STAN_Database/Database.cs:39-111 line scan) and the protobuf wire
//     scanner behind the STdb fast decode (io/stdb.deserialize_fast);
//   * the graph builder: the BFS node order (reference algorithm:
//     src/STAN_Database/Database.cs:140-234);
//   * the float64 interior sweep of the assembled stencil, the hot loop of
//     the host float64 operator (fem/stencil.apply_numpy);
//   * the float64 element stiffnesses of an arbitrary mesh and their sweep,
//     the host float64 twin of the general operator
//     (fem/hostops.general_twin_np).
//
// The Python implementations in the port stay as the semantic spec: the
// tests hold each function here to them, output for output.

#include <algorithm>
#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Nastran .bdf parsing
// ---------------------------------------------------------------------------

struct BdfMesh {
  int64_t n_nodes;
  int64_t n_elems;
  int64_t nodes_per_elem;
  int64_t* node_ids;   // [n_nodes] sorted ascending
  double* coords;      // [n_nodes * 3]
  int64_t* elem_ids;   // [n_elems]
  int64_t* elem_pids;  // [n_elems]
  int64_t* conn;       // [n_elems * nodes_per_elem] dense node indices
  int64_t n_errors;    // parse failures collected, not fatal
};

namespace {

// Repair .bdf numeric quirks: embedded exponent sign without 'e'
// ("1.23-4" -> 1.23e-4) and leading '.' (Node.cs:40-63).
bool parse_bdf_number(const std::string& raw, double* out) {
  std::string t;
  t.reserve(raw.size() + 2);
  for (char c : raw)
    if (!isspace((unsigned char)c)) t.push_back(c);
  if (t.empty()) return false;
  if (t.find('e') == std::string::npos && t.find('E') == std::string::npos) {
    for (size_t i = 1; i < t.size(); ++i) {
      if (t[i] == '-' || t[i] == '+') {
        t.insert(i, 1, 'e');
        break;
      }
    }
  }
  if (t[0] == '.') t.insert(0, 1, '0');
  else if (t.size() > 1 && t[0] == '-' && t[1] == '.') t.insert(1, 1, '0');
  char* end = nullptr;
  *out = strtod(t.c_str(), &end);
  return end && *end == '\0';
}

struct RawNode {
  int64_t id;
  double x, y, z;
};
struct RawElem {
  int64_t id, pid;
  std::vector<int64_t> nodes;
};

// Split a small-field card line into non-blank 8-char columns, line
// right-padded to a full column (nastran.py::_grid_fields semantics).
std::vector<std::string> grid_fields(const std::string& line) {
  std::vector<std::string> out;
  size_t ncol = (line.size() + 7) / 8;
  for (size_t i = 0; i < ncol; ++i) {
    std::string f;
    for (size_t j = i * 8; j < std::min(line.size(), (i + 1) * 8); ++j)
      if (line[j] != ' ') f.push_back(line[j]);
    if (!f.empty()) out.push_back(f);
  }
  return out;
}

bool parse_int(const std::string& s, int64_t* out) {
  char* end = nullptr;
  *out = strtoll(s.c_str(), &end, 10);
  return end && *end == '\0' && !s.empty();
}

}  // namespace

// Parse a .bdf file. card_filter: 0 = CHEXA+CTETRA, 1 = CHEXA only
// (the reference release whitelist, Database.cs:44-48).
BdfMesh* stanfem_bdf_parse(const char* path, int card_filter) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  std::vector<std::string> lines;
  {
    std::string cur;
    char buf[1 << 16];
    size_t n;
    while ((n = fread(buf, 1, sizeof buf, f)) > 0) {
      for (size_t i = 0; i < n; ++i) {
        if (buf[i] == '\n') {
          if (!cur.empty() && cur.back() == '\r') cur.pop_back();
          lines.push_back(cur);
          cur.clear();
        } else {
          cur.push_back(buf[i]);
        }
      }
    }
    if (!cur.empty()) lines.push_back(cur);
  }
  fclose(f);

  std::vector<RawNode> nodes;
  std::vector<RawElem> elems;
  int64_t n_errors = 0;
  int64_t npe = 0;  // nodes per element (uniform family required)
  bool mixed = false;

  for (size_t i = 0; i < lines.size(); ++i) {
    const std::string& line = lines[i];
    if (!line.empty() && line[0] == '$') continue;
    bool is_hexa = line.find("CHEXA") != std::string::npos;
    bool is_tetra =
        card_filter == 0 && line.find("CTETRA") != std::string::npos;
    if (is_hexa || is_tetra) {
      // Concatenate continuation lines starting with '+' or ' '
      // (Database.cs:60-71).
      std::string text = line;
      size_t j = i + 1;
      while (j < lines.size() &&
             (!lines[j].empty() &&
              (lines[j][0] == '+' || lines[j][0] == ' '))) {
        text += lines[j];
        ++j;
      }
      i = j - 1;
      // Whitespace-split, strip '+', keep integer tokens
      // (Element.cs:41-56).
      std::vector<std::string> toks;
      {
        std::string cur;
        for (char c : text) {
          if (isspace((unsigned char)c)) {
            if (!cur.empty()) toks.push_back(cur), cur.clear();
          } else {
            cur.push_back(c);
          }
        }
        if (!cur.empty()) toks.push_back(cur);
      }
      int64_t want = is_hexa ? 8 : 4;
      RawElem e;
      bool ok = toks.size() >= 3 && parse_int(toks[1], &e.id) &&
                parse_int(toks[2], &e.pid);
      if (ok) {
        for (size_t k = 3; k < toks.size(); ++k) {
          std::string t = toks[k];
          t.erase(std::remove(t.begin(), t.end(), '+'), t.end());
          int64_t v;
          if (parse_int(t, &v)) e.nodes.push_back(v);
        }
        ok = (int64_t)e.nodes.size() >= want;
      }
      if (ok) {
        e.nodes.resize(want);
        if (npe == 0) npe = want;
        else if (npe != want) mixed = true;
        elems.push_back(std::move(e));
      } else {
        ++n_errors;
      }
      continue;
    }
    if (line.rfind("GRID", 0) == 0) {
      auto fields = grid_fields(line);
      RawNode nd;
      bool ok = fields.size() >= 5 && parse_int(fields[1], &nd.id) &&
                parse_bdf_number(fields[2], &nd.x) &&
                parse_bdf_number(fields[3], &nd.y) &&
                parse_bdf_number(fields[4], &nd.z);
      if (ok) nodes.push_back(nd);
      else ++n_errors;
    }
  }
  if (mixed) return nullptr;  // caller falls back / reports
  if (npe == 0) npe = 8;

  // Sort nodes by id; build id -> dense index.
  std::sort(nodes.begin(), nodes.end(),
            [](const RawNode& a, const RawNode& b) { return a.id < b.id; });

  BdfMesh* m = (BdfMesh*)calloc(1, sizeof(BdfMesh));
  m->n_nodes = (int64_t)nodes.size();
  m->nodes_per_elem = npe;
  m->node_ids = (int64_t*)malloc(sizeof(int64_t) * nodes.size());
  m->coords = (double*)malloc(sizeof(double) * nodes.size() * 3);
  for (size_t k = 0; k < nodes.size(); ++k) {
    m->node_ids[k] = nodes[k].id;
    m->coords[3 * k + 0] = nodes[k].x;
    m->coords[3 * k + 1] = nodes[k].y;
    m->coords[3 * k + 2] = nodes[k].z;
  }

  // Map element node ids -> dense; drop elements with unknown refs.
  auto lookup = [&](int64_t id) -> int64_t {
    int64_t lo = 0, hi = (int64_t)nodes.size() - 1;
    while (lo <= hi) {
      int64_t mid = (lo + hi) / 2;
      if (nodes[mid].id == id) return mid;
      if (nodes[mid].id < id) lo = mid + 1;
      else hi = mid - 1;
    }
    return -1;
  };
  std::vector<RawElem*> kept;
  std::vector<std::vector<int64_t>> dense(elems.size());
  for (size_t e = 0; e < elems.size(); ++e) {
    std::vector<int64_t> d(npe);
    bool ok = true;
    for (int64_t k = 0; k < npe; ++k) {
      d[k] = lookup(elems[e].nodes[k]);
      if (d[k] < 0) ok = false;
    }
    if (ok) {
      dense[kept.size()] = std::move(d);
      kept.push_back(&elems[e]);
    } else {
      ++n_errors;
    }
  }

  m->n_elems = (int64_t)kept.size();
  m->elem_ids = (int64_t*)malloc(sizeof(int64_t) * kept.size());
  m->elem_pids = (int64_t*)malloc(sizeof(int64_t) * kept.size());
  m->conn = (int64_t*)malloc(sizeof(int64_t) * kept.size() * npe);
  for (size_t e = 0; e < kept.size(); ++e) {
    m->elem_ids[e] = kept[e]->id;
    m->elem_pids[e] = kept[e]->pid;
    for (int64_t k = 0; k < npe; ++k) m->conn[e * npe + k] = dense[e][k];
  }
  m->n_errors = n_errors;
  return m;
}

void stanfem_bdf_free(BdfMesh* m) {
  if (!m) return;
  free(m->node_ids);
  free(m->coords);
  free(m->elem_ids);
  free(m->elem_pids);
  free(m->conn);
  free(m);
}

// ---------------------------------------------------------------------------
// Graph builder: BFS node ordering (Database.cs:140-234 algorithm)
// ---------------------------------------------------------------------------

// order[new] = old. Returns 0 on success.
int stanfem_bfs_order(const int64_t* conn, int64_t n_elems, int64_t npe,
                      int64_t n_nodes, int64_t* order_out) {
  // Node -> element-count (for the peripheral seed) and node adjacency via
  // sorted unique pair list, exactly the Python partitioner's construction
  // (parallel/partition.py::bfs_node_order).
  std::vector<int64_t> counts(n_nodes, 0);
  for (int64_t i = 0; i < n_elems * npe; ++i) ++counts[conn[i]];

  // Build adjacency pairs (a, b), a != b, within each element.
  std::vector<std::pair<int64_t, int64_t>> pairs;
  pairs.reserve((size_t)n_elems * npe * (npe - 1));
  for (int64_t e = 0; e < n_elems; ++e) {
    const int64_t* en = conn + e * npe;
    for (int64_t a = 0; a < npe; ++a)
      for (int64_t b = 0; b < npe; ++b)
        if (en[a] != en[b]) pairs.emplace_back(en[a], en[b]);
  }
  std::sort(pairs.begin(), pairs.end());
  pairs.erase(std::unique(pairs.begin(), pairs.end()), pairs.end());

  std::vector<int64_t> indptr(n_nodes + 1, 0);
  for (auto& p : pairs) ++indptr[p.first + 1];
  for (int64_t i = 0; i < n_nodes; ++i) indptr[i + 1] += indptr[i];

  std::vector<char> visited(n_nodes, 0);
  std::vector<int64_t> queue;
  queue.reserve(n_nodes);
  int64_t pos = 0;

  // Seed order: nodes sorted by incident-element count (fewest first),
  // zero-count nodes appended at the very end.
  std::vector<int64_t> seeds(n_nodes);
  for (int64_t i = 0; i < n_nodes; ++i) seeds[i] = i;
  std::sort(seeds.begin(), seeds.end(), [&](int64_t a, int64_t b) {
    int64_t ca = counts[a] > 0 ? counts[a] : INT64_MAX;
    int64_t cb = counts[b] > 0 ? counts[b] : INT64_MAX;
    if (ca != cb) return ca < cb;
    return a < b;
  });

  for (int64_t s : seeds) {
    if (visited[s] || counts[s] == 0) continue;
    // BFS from s
    size_t head = queue.size();
    queue.push_back(s);
    visited[s] = 1;
    while (head < queue.size()) {
      int64_t u = queue[head++];
      order_out[pos++] = u;
      for (int64_t k = indptr[u]; k < indptr[u + 1]; ++k) {
        int64_t v = pairs[k].second;
        if (!visited[v]) {
          visited[v] = 1;
          queue.push_back(v);
        }
      }
    }
  }
  for (int64_t i = 0; i < n_nodes; ++i)
    if (!visited[i]) order_out[pos++] = i;
  return pos == n_nodes ? 0 : 1;
}

// ---------------------------------------------------------------------------
// Protobuf wire scanning (data loader for the STdb reader, io/stdb.py)
//
// The STdb file is one protobuf message whose bulk is two maps with ~nnode /
// ~nelem entries (Database.cs:12-13). Walking those entries in Python costs
// minutes at 1M nodes; this scanner walks the wire format in C and emits a
// flat field table (body index, field number, wire type, value/offset,
// length) that numpy consumes array-at-a-time. One call scans any number of
// sibling message bodies (e.g. every Node at once), so a full read needs a
// constant number of native calls regardless of model size.
// ---------------------------------------------------------------------------

// Scan `nbody` protobuf message bodies given by [starts[i], ends[i]) into
// parallel record arrays. Per record:
//   body  = which input body the record belongs to
//   field = protobuf field number, wt = wire type (0 varint, 1 fixed64,
//           2 length-delimited, 5 fixed32)
//   a     = varint value / fixed64 bits / absolute payload offset (wt 2)
//   b     = payload length (wt 2), else 0
// Pass cap == 0 (outputs may be null) to count records. Returns the record
// count, or -1 on malformed input (truncated varint, bad wire type,
// overrun) — callers fall back to the generated-protobuf parser.
int64_t stanfem_pb_scan_many(const uint8_t* buf, int64_t buflen,
                             const int64_t* starts, const int64_t* ends,
                             int64_t nbody,
                             int32_t* body_out, int32_t* field_out,
                             int8_t* wt_out, int64_t* a_out, int64_t* b_out,
                             int64_t cap) {
  int64_t count = 0;
  for (int64_t ib = 0; ib < nbody; ++ib) {
    int64_t pos = starts[ib];
    const int64_t end = ends[ib];
    if (pos < 0 || end > buflen || pos > end) return -1;
    while (pos < end) {
      // varint: tag
      uint64_t tag = 0;
      int shift = 0;
      while (true) {
        if (pos >= end || shift > 63) return -1;
        uint8_t byte = buf[pos++];
        tag |= (uint64_t)(byte & 0x7F) << shift;
        if (!(byte & 0x80)) break;
        shift += 7;
      }
      const int64_t field = (int64_t)(tag >> 3);
      const int wt = (int)(tag & 7);
      if (field <= 0 || field > INT32_MAX) return -1;
      int64_t a = 0, b = 0;
      switch (wt) {
        case 0: {  // varint value
          uint64_t v = 0;
          shift = 0;
          while (true) {
            if (pos >= end || shift > 63) return -1;
            uint8_t byte = buf[pos++];
            v |= (uint64_t)(byte & 0x7F) << shift;
            if (!(byte & 0x80)) break;
            shift += 7;
          }
          a = (int64_t)v;
          break;
        }
        case 1: {  // fixed64 bits
          if (pos + 8 > end) return -1;
          uint64_t v;
          std::memcpy(&v, buf + pos, 8);
          pos += 8;
          a = (int64_t)v;
          break;
        }
        case 2: {  // length-delimited: absolute offset + length
          uint64_t len = 0;
          shift = 0;
          while (true) {
            if (pos >= end || shift > 63) return -1;
            uint8_t byte = buf[pos++];
            len |= (uint64_t)(byte & 0x7F) << shift;
            if (!(byte & 0x80)) break;
            shift += 7;
          }
          if (pos + (int64_t)len > end) return -1;
          a = pos;
          b = (int64_t)len;
          pos += (int64_t)len;
          break;
        }
        case 5: {  // fixed32 bits
          if (pos + 4 > end) return -1;
          uint32_t v;
          std::memcpy(&v, buf + pos, 4);
          pos += 4;
          a = (int64_t)v;
          break;
        }
        default:
          return -1;  // groups (3/4) and invalid types unsupported
      }
      if (count < cap) {
        body_out[count] = (int32_t)ib;
        field_out[count] = (int32_t)field;
        wt_out[count] = (int8_t)wt;
        a_out[count] = a;
        b_out[count] = b;
      }
      ++count;
    }
  }
  return count;
}

// ---------------------------------------------------------------------------
// Float64 assembled-stencil interior sweep (the host float64 operator)
//
// fem/stencil.apply_numpy is the host float64 action of the assembled K:
// the independent check of the card's certified answer
// (fem/hostops.masked_f64_apply). Its interior 27-point table covers the
// full volume, about 486 MFLOP at 1M DOF. This C sweep runs it with OpenMP
// over x-planes, z innermost for vectorization; the lower-dimensional
// boundary-delta corrections stay in numpy (fem/stencil.apply_numpy).
// ---------------------------------------------------------------------------

// up:  [3, nnx+2, nny+2, nnz+2] ghost-padded node grid (C order)
// tab: [27, 3, 3] interior table, offset-major with off = (ox+1)*9 +
//      (oy+1)*3 + (oz+1) indexing the first axis... (see caller)
// out: [3, nnx, nny, nnz]
void stanfem_stencil_interior_f64(const double* up, int64_t nnx, int64_t nny,
                                  int64_t nnz, const double* tab,
                                  double* out) {
  const int64_t py = nny + 2, pz = nnz + 2;
  const int64_t plane = py * pz;       // padded x-plane stride
  const int64_t comp = (nnx + 2) * plane;  // padded component stride
  const int64_t oplane = nny * nnz;
  const int64_t ocomp = nnx * oplane;
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t x = 0; x < nnx; ++x) {
    for (int c = 0; c < 3; ++c) {
      for (int64_t y = 0; y < nny; ++y) {
        double* o = out + c * ocomp + x * oplane + y * nnz;
        for (int64_t z = 0; z < nnz; ++z) o[z] = 0.0;
        for (int d = 0; d < 3; ++d) {
          for (int ox = -1; ox <= 1; ++ox) {
            for (int oy = -1; oy <= 1; ++oy) {
              const double* base = up + d * comp + (x + 1 + ox) * plane +
                                   (y + 1 + oy) * pz + 1;
              for (int oz = -1; oz <= 1; ++oz) {
                const double a =
                    tab[(((ox + 1) * 9 + (oy + 1) * 3 + (oz + 1)) * 3 + c) *
                            3 +
                        d];
                if (a == 0.0) continue;
                const double* src = base + oz;
                for (int64_t z = 0; z < nnz; ++z) o[z] += a * src[z];
              }
            }
          }
        }
      }
    }
  }
}


// ---------------------------------------------------------------------------
// Float64 element stiffnesses and their sweep (the general operator's host
// twin)
//
// fem/hostops.general_apply_np is the semantic spec: ke = sum_g B^T D B
// det(J) w per element, and f = sum over elements of ke u_e. At 1M DOF the
// numpy form holds B [E, G, 6, 24] and takes minutes; here each element's
// ke is built in registers and stored once (OpenMP over elements), and a
// sweep is one product per element into a per-corner buffer followed by a
// gather through the transposed incidence map (OpenMP over nodes): no
// atomics, so a sweep gives the same bits on every run.
// ---------------------------------------------------------------------------

namespace {

constexpr int kMaxNodes = 8;  // HEX8; TET4 uses the first four
constexpr int kMaxCols = 3 * kMaxNodes;

// Column 3 a + d of B has three nonzeros: in Voigt row kRow[d][i] it holds
// the gradient component kGrad[d][i] of node a (Voigt order xx, yy, zz, xy,
// yz, xz, engineering shear; fem/kernels.b_matrix).
constexpr int kRow[3][3] = {{0, 3, 5}, {1, 3, 4}, {2, 4, 5}};
constexpr int kGrad[3][3] = {{0, 1, 2}, {1, 0, 2}, {2, 1, 0}};

}  // namespace

// coords: [nnode, 3]; conn: [n_elems, nn] node indices in [0, nnode);
// D: [n_elems, 6, 6]; gdn: [ng, 3, nn] shape-function gradients in natural
// coordinates; gw: [ng] Gauss weights; ke: [n_elems, 3 nn, 3 nn] out.
// Returns 0, or -1 when nn is outside [1, 8].
int stanfem_element_stiffness_f64(const double* coords, const int64_t* conn,
                                  int64_t n_elems, int64_t nn,
                                  const double* D, const double* gdn,
                                  const double* gw, int64_t ng, double* ke) {
  if (nn < 1 || nn > kMaxNodes) return -1;
  const int64_t nc = 3 * nn;
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t e = 0; e < n_elems; ++e) {
    double x[kMaxNodes][3];
    for (int64_t a = 0; a < nn; ++a)
      for (int j = 0; j < 3; ++j) x[a][j] = coords[conn[e * nn + a] * 3 + j];
    const double* De = D + e * 36;
    double k[kMaxCols][kMaxCols] = {};
    for (int64_t g = 0; g < ng; ++g) {
      const double* dl = gdn + g * 3 * nn;  // [3, nn]
      double J[3][3] = {};  // J[k][j] = d x_j / d xi_k
      for (int kk = 0; kk < 3; ++kk)
        for (int64_t a = 0; a < nn; ++a)
          for (int j = 0; j < 3; ++j) J[kk][j] += dl[kk * nn + a] * x[a][j];
      const double c00 = J[1][1] * J[2][2] - J[1][2] * J[2][1];
      const double c01 = J[1][2] * J[2][0] - J[1][0] * J[2][2];
      const double c02 = J[1][0] * J[2][1] - J[1][1] * J[2][0];
      const double det = J[0][0] * c00 + J[0][1] * c01 + J[0][2] * c02;
      const double inv[3][3] = {
          {c00 / det, (J[0][2] * J[2][1] - J[0][1] * J[2][2]) / det,
           (J[0][1] * J[1][2] - J[0][2] * J[1][1]) / det},
          {c01 / det, (J[0][0] * J[2][2] - J[0][2] * J[2][0]) / det,
           (J[0][2] * J[1][0] - J[0][0] * J[1][2]) / det},
          {c02 / det, (J[0][1] * J[2][0] - J[0][0] * J[2][1]) / det,
           (J[0][0] * J[1][1] - J[0][1] * J[1][0]) / det}};
      double dn[3][kMaxNodes];  // gradients in global coordinates
      for (int j = 0; j < 3; ++j)
        for (int64_t a = 0; a < nn; ++a) {
          double v = 0.0;
          for (int kk = 0; kk < 3; ++kk) v += inv[j][kk] * dl[kk * nn + a];
          dn[j][a] = v;
        }
      const double w = det * gw[g];
      double db[6][kMaxCols];  // D B
      for (int64_t a = 0; a < nn; ++a)
        for (int d = 0; d < 3; ++d) {
          const int64_t c = 3 * a + d;
          for (int i = 0; i < 6; ++i) {
            double v = 0.0;
            for (int r = 0; r < 3; ++r)
              v += De[i * 6 + kRow[d][r]] * dn[kGrad[d][r]][a];
            db[i][c] = v;
          }
        }
      for (int64_t a = 0; a < nn; ++a)
        for (int d = 0; d < 3; ++d) {
          const int64_t c1 = 3 * a + d;
          double b[3];
          for (int r = 0; r < 3; ++r) b[r] = w * dn[kGrad[d][r]][a];
          for (int64_t c2 = c1; c2 < nc; ++c2)
            k[c1][c2] += b[0] * db[kRow[d][0]][c2] +
                         b[1] * db[kRow[d][1]][c2] + b[2] * db[kRow[d][2]][c2];
        }
    }
    double* out = ke + e * nc * nc;
    for (int64_t c1 = 0; c1 < nc; ++c1)
      for (int64_t c2 = c1; c2 < nc; ++c2)
        out[c1 * nc + c2] = out[c2 * nc + c1] = k[c1][c2];
  }
  return 0;
}

// ke: [n_elems, 3 nn, 3 nn]; conn: [n_elems, nn]; u: [nnode, 3];
// inc: [nnode, maxdeg] positions in the flattened [n_elems * nn] corner axis
// (n_elems * nn for padding, fem/operator.node_incidence); fe: scratch of
// n_elems * nn * 3 + 3 doubles; out: [nnode, 3] = K u.
void stanfem_element_apply_f64(const double* ke, const int64_t* conn,
                               int64_t n_elems, int64_t nn, const double* u,
                               const int64_t* inc, int64_t nnode,
                               int64_t maxdeg, double* fe, double* out) {
  const int64_t nc = 3 * nn;
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t e = 0; e < n_elems; ++e) {
    double ue[kMaxCols];
    for (int64_t a = 0; a < nn; ++a)
      for (int d = 0; d < 3; ++d) ue[3 * a + d] = u[conn[e * nn + a] * 3 + d];
    const double* k = ke + e * nc * nc;
    double* f = fe + e * nc;
    for (int64_t c1 = 0; c1 < nc; ++c1) {
      double v = 0.0;
      for (int64_t c2 = 0; c2 < nc; ++c2) v += k[c1 * nc + c2] * ue[c2];
      f[c1] = v;
    }
  }
  fe[n_elems * nc] = fe[n_elems * nc + 1] = fe[n_elems * nc + 2] = 0.0;
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t n = 0; n < nnode; ++n) {
    double s[3] = {0.0, 0.0, 0.0};
    for (int64_t j = 0; j < maxdeg; ++j) {
      const double* f = fe + inc[n * maxdeg + j] * 3;
      s[0] += f[0];
      s[1] += f[1];
      s[2] += f[2];
    }
    out[n * 3] = s[0];
    out[n * 3 + 1] = s[1];
    out[n * 3 + 2] = s[2];
  }
}

}  // extern "C"
