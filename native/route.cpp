// Bipartite regular edge coloring via recursive Euler splitting.
//
// Plan-time core of the routed-permutation engine (sblas/ops/route.py):
// decomposing an arbitrary device-side permutation into gather-free
// stages (per-row 128-lane shuffles + transposes) reduces, via the
// Birkhoff/Clos routing theorem, to coloring a d-regular bipartite
// multigraph with exactly d colors so that every node sees each color
// once.  For d a power of two the classical construction is Euler
// splitting: walk Eulerian circuits, alternate edges into two halves
// (every node's degree halves exactly), recurse log2(d) times.
//
// O(E log d), inherently pointer-chasing — hence C++ (the python fallback
// in route.py is only viable for test-sized inputs).  All working arrays
// are int32 and k-indexed (k = position within the current group), so the
// walk stays cache-local: endpoints are copied into group order once per
// level instead of chasing original edge ids.
//
// No analog in the reference (its gather/scatter problems are cuSPARSE's,
// e.g. spmm.h:146-149).

#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <ctime>
#include <vector>

using std::size_t;

namespace {

// Negative result (measured, do not retry): backing the chase arrays with
// 2 MiB THP pages (madvise(MADV_HUGEPAGE) on 2 MiB-aligned mmaps; grant
// confirmed via AnonHugePages=448 MB) left the interleaved walk time
// UNCHANGED (7.6 vs 7.5 s at ne=14.7M) and added seconds of first-touch
// fault cost — the chase is limited by this host's memory-level
// parallelism, not TLB page-walks.

// env-gated phase profiling (SBLAS_COLOR_PROF=1): accumulated seconds in
// incidence-list builds vs Euler walks, printed per coloring call
double g_build_s = 0, g_walk_s = 0;
inline double now_s() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec + 1e-9 * ts.tv_nsec;
}

// Split the k-indexed edge group (lsrc[k], ldst[k]), k in [0, ne), into two
// halves such that every node's degree halves exactly (all degrees even).
// Writes bit (0/1) into bit 1 of ub_k[k] (bit 0 = visited).
//
// Layout note: the walk is the plan build's irreducible pointer chase, so
// each step is packed down to TWO random cache-line touches — inc64 slots
// carry (other_endpoint << 32 | edge) so choosing the next edge needs no
// lsrc/ldst lookup, and the used flag and the half bit share one byte so
// the availability check warms the line the subsequent mark writes.
void euler_halve(const int32_t* lsrc, const int32_t* ldst, int32_t n_left,
                 int64_t n_nodes, int64_t ne, uint8_t* ub_k,
                 std::vector<int32_t>& head, std::vector<int64_t>& inc64,
                 std::vector<int32_t>& ptr) {
  const double t0 = now_s();
  head.assign(n_nodes + 1, 0);
  for (int64_t k = 0; k < ne; ++k) {
    ++head[lsrc[k] + 1];
    ++head[(int64_t)n_left + ldst[k] + 1];
  }
  for (int64_t v = 0; v < n_nodes; ++v) head[v + 1] += head[v];
  inc64.resize(2 * ne);

  ptr.assign(head.begin(), head.end() - 1);
  for (int64_t k = 0; k < ne; ++k) {
    const int64_t l = lsrc[k], r = (int64_t)n_left + ldst[k];
    inc64[ptr[l]++] = (r << 32) | k;
    inc64[ptr[r]++] = (l << 32) | k;
  }
  ptr.assign(head.begin(), head.end() - 1);  // rewind to list starts
  for (int64_t k = 0; k < ne; ++k) ub_k[k] = 0;
  const double t1 = now_s();
  g_build_s += t1 - t0;

  // walk closed circuits; alternate bit along each circuit.  In an
  // all-even-degree multigraph a greedy walk can only get stuck back at
  // the start node, closing a circuit; bipartite circuits have even
  // length so alternation is consistent and pairs each node visit's
  // in/out edges into opposite halves.
  for (int64_t k0 = 0; k0 < ne; ++k0) {
    if (ub_k[k0] & 1) continue;
    // consume k0 from its left side; the walk continues at its right side
    int64_t v = (int64_t)n_left + ldst[k0];
    uint8_t parity = 0;
    int64_t k = k0;
    for (;;) {
      ub_k[k] = (uint8_t)(1 | (parity << 1));
      parity ^= 1;
      // next unused incident edge at v
      int32_t p = ptr[v];
      const int32_t end = head[v + 1];
      while (p < end && (ub_k[(int32_t)inc64[p]] & 1)) ++p;
      ptr[v] = p;
      if (p == end) break;  // circuit closed (v is the start node)
      const int64_t entry = inc64[p];
      k = (int32_t)entry;
      v = entry >> 32;
    }
  }
  g_walk_s += now_s() - t1;
}

// ---------------------------------------------------------------------------
// Interleaved pairing-cycle halving (the large-group fast path).
//
// The serial Euler walk above is one long dependent pointer chase: ~100 ns
// per edge on this host (every step waits for a cache miss).  The same
// halving can be phrased so the chase parallelizes: pair each node's
// incident slots (2i with 2i+1) and compose, at build time, the successor
//   succ(pos) = pair-slot-of(twin(pos))
// which is a STATIC permutation of the 2*ne incidence positions.
// Alternating a bit along each succ-cycle splits every node's pairs — and
// hence its degree — exactly in half, because consecutive cycle steps are
// exactly the node pairings.  A static permutation can be chased with W
// independent lanes (list ranking with splitters).  An isolated chase
// microbenchmark promised ~8x at W=16 (19 vs 150 ns/step); IN SITU the
// win is ~1.5x (~36 ns/position vs ~100 ns/edge serial) and flat from
// W=16 to 48 — the host's memory-level parallelism, shared with the
// interleaved build/extract traffic, is the binding limit (2 MiB THP
// pages measured no help; see the note above).
//
// Mirror structure: twin conjugates succ to its inverse, so cycles come in
// mirror pairs traversing the same edges in opposite directions (each edge
// consumed once per mirror, at one of its two positions).  Assigning bits
// from exactly ONE cycle of each mirror pair covers every node pairing
// once, consistently.  A cycle equal to its own mirror would alternate
// inconsistently; it cannot be repaired by cycle choice, so the group
// falls back to the serial walk (counted in the PROF line; not observed
// on route-builder instances, which this path is shaped for).
// ---------------------------------------------------------------------------

struct Slot {
  int32_t succ;    // next incidence position along the pairing cycle
  int32_t edge;    // group-local edge id at this position
  int32_t twin;    // the edge's other incidence position
  uint32_t flags;  // bit0 visited, bit1 local parity, bit2 splitter,
                   // bits 8.. segment id + 1
};

constexpr uint32_t kVisited = 1u, kSplitter = 4u;
constexpr int kSegShift = 8;
// Below this edge count the serial walk wins (the interleaved machinery's
// segment bookkeeping costs more than the misses it overlaps).  Tests
// override via SBLAS_COLOR_FASTMIN to exercise the fast path at small
// scale; re-read per coloring call so a monkeypatched env takes effect.
constexpr int64_t kFastMinDefault = 1 << 20;
int64_t g_fast_min = kFastMinDefault;
constexpr int kLanes = 24;             // concurrent chase chains

struct Segment {
  int32_t start, boundary;  // first position; position that ended the chase
  int64_t len;
  int32_t cycle = -1;
  uint8_t offset = 0;  // global parity of the segment's first position
};

// Returns false when the group must fall back to the serial walk
// (self-mirror cycle or segment-id overflow).
bool fast_halve(const int32_t* lsrc, const int32_t* ldst, int32_t n_left,
                int64_t n_nodes, int64_t ne, uint8_t* ub_k,
                std::vector<int32_t>& head, std::vector<int32_t>& ptr,
                std::vector<Slot>& slots, std::vector<Segment>& segs) {
  const double t0 = now_s();
  const int64_t np = 2 * ne;  // incidence positions
  head.assign(n_nodes + 1, 0);
  for (int64_t k = 0; k < ne; ++k) {
    ++head[lsrc[k] + 1];
    ++head[(int64_t)n_left + ldst[k] + 1];
  }
  for (int64_t v = 0; v < n_nodes; ++v) head[v + 1] += head[v];
  if (slots.size() < (size_t)np) slots.resize(np);

  ptr.assign(head.begin(), head.end() - 1);
  for (int64_t k = 0; k < ne; ++k) {
    const int64_t l = lsrc[k], r = (int64_t)n_left + ldst[k];
    const int32_t pl = ptr[l]++, pr = ptr[r]++;
    // pair-slot of position p in node v's list: head[v] + ((p-head[v])^1)
    const int32_t qr = head[r] + ((pr - head[r]) ^ 1);
    const int32_t ql = head[l] + ((pl - head[l]) ^ 1);
    slots[pl] = Slot{qr, (int32_t)k, pr, 0};
    slots[pr] = Slot{ql, (int32_t)k, pl, 0};
  }
  g_build_s += now_s() - t0;
  const double t1 = now_s();

  // splitters: a position stride; giant cycles get ~K interior boundaries
  // so W lanes always have fresh segments to claim
  const int64_t kTargetSegs = 1 << 15;
  const int64_t stride = np > kTargetSegs ? np / kTargetSegs : 1;
  for (int64_t s = 0; s < np; s += stride) slots[s].flags |= kSplitter;

  segs.clear();
  // lane state; seg == -1 marks an idle lane
  int32_t lane_pos[kLanes];
  int64_t lane_len[kLanes];
  uint32_t lane_par[kLanes];
  int32_t lane_seg[kLanes];
  for (int i = 0; i < kLanes; ++i) lane_seg[i] = -1;

  // two claim phases share the chase loop: phase 0 claims splitter
  // positions (cuts giant cycles into parallel segments), phase 1 sweeps
  // every position for splitter-free cycles (short-cycle regime)
  for (int phase = 0; phase < 2; ++phase) {
    const int64_t cstride = phase == 0 ? stride : 1;
    int64_t cursor = 0;
    int active = 0;
    for (;;) {
      // refill idle lanes
      for (int i = 0; i < kLanes && cursor < np; ++i) {
        if (lane_seg[i] >= 0) continue;
        while (cursor < np && (slots[cursor].flags & kVisited))
          cursor += cstride;
        if (cursor >= np) break;
        if ((int64_t)segs.size() >= (1 << 24) - 1) return false;
        lane_pos[i] = (int32_t)cursor;
        lane_len[i] = 0;
        lane_par[i] = 0;
        lane_seg[i] = (int32_t)segs.size();
        segs.push_back(Segment{(int32_t)cursor, -1, 0});
        cursor += cstride;
        ++active;
      }
      if (active == 0) break;
      // one step per active lane: a single dependent load each, so the
      // misses of all active lanes overlap
      for (int i = 0; i < kLanes; ++i) {
        if (lane_seg[i] < 0) continue;
        const int32_t pos = lane_pos[i];
        Slot& s = slots[pos];
        if ((lane_len[i] > 0 && (s.flags & kSplitter)) ||
            (s.flags & kVisited)) {
          // boundary: another segment's start (or our own start again)
          Segment& sg = segs[lane_seg[i]];
          sg.boundary = pos;
          sg.len = lane_len[i];
          lane_seg[i] = -1;
          --active;
          continue;
        }
        s.flags |= kVisited | (lane_par[i] << 1) |
                   ((uint32_t)(lane_seg[i] + 1) << kSegShift);
        lane_par[i] ^= 1;
        ++lane_len[i];
        lane_pos[i] = s.succ;
      }
    }
  }

  // stitch segments into cycles; propagate global parity offsets
  const int64_t n_segs = (int64_t)segs.size();
  // start position -> segment id (starts are unique by construction)
  // resolved through the flags field the chase already wrote
  auto seg_at = [&](int32_t pos) -> int32_t {
    return (int32_t)(slots[pos].flags >> kSegShift) - 1;
  };
  int32_t n_cycles = 0;
  std::vector<int32_t> cyc_first;
  for (int64_t s0 = 0; s0 < n_segs; ++s0) {
    // len == 0: the lane's claimed start was consumed by another lane
    // before its first step (phase-1 race); the position belongs to the
    // consumer's segment and this placeholder is referenced by nothing
    if (segs[s0].cycle >= 0 || segs[s0].len == 0) continue;
    const int32_t c = n_cycles++;
    cyc_first.push_back((int32_t)s0);
    int32_t s = (int32_t)s0;
    uint8_t off = 0;
    int64_t total = 0;
    int64_t guard = 0;
    do {
      if (++guard > n_segs) return false;  // corrupt chain: serial fallback
      segs[s].cycle = c;
      segs[s].offset = off;
      off ^= (uint8_t)(segs[s].len & 1);
      total += segs[s].len;
      s = seg_at(segs[s].boundary);
    } while (s != (int32_t)s0);
    if (total & 1) return false;  // cannot happen: cycles alternate sides
  }

  // mirror pairing: the cycle holding any position's twin is the mirror;
  // keep the lower-numbered cycle of each pair
  std::vector<uint8_t> keep(n_cycles);
  for (int32_t c = 0; c < n_cycles; ++c) {
    const int32_t tw = slots[segs[cyc_first[c]].start].twin;
    const int32_t mc = segs[seg_at(tw)].cycle;
    if (mc == c) return false;  // self-mirror: serial fallback
    keep[c] = (uint8_t)(c < mc);
  }

  // extraction: one streaming pass; each edge's bit comes from whichever
  // of its two positions lies in the kept cycle of the mirror pair
  for (int64_t k = 0; k < ne; ++k) ub_k[k] = 0;
  for (int64_t p = 0; p < np; ++p) {
    const Slot& s = slots[p];
    const Segment& sg = segs[(s.flags >> kSegShift) - 1];
    if (keep[sg.cycle])
      ub_k[s.edge] = (uint8_t)(1 | ((((s.flags >> 1) ^ sg.offset) & 1) << 1));
  }
  g_walk_s += now_s() - t1;
  return true;
}

}  // namespace

namespace {

struct ColorWork {
  std::vector<int32_t> head, ptr;
  std::vector<int64_t> inc64;
  std::vector<uint8_t> ub_k;
  std::vector<Slot> slots;
  std::vector<Segment> segs;
  std::vector<int32_t> eid, lsrc, ldst, lcol;
  std::vector<int32_t> t_eid, t_src, t_dst, t_col;
};

// Color one d-regular bipartite subgraph of ne edges whose node ids are
// [0, n_left) x [0, n_right); writes colors into color_out[eid order].
int color_one(int32_t n_left, int32_t n_right, int64_t ne, int32_t d,
              const int32_t* src, const int32_t* dst, int32_t* color_out,
              ColorWork& w) {
  for (int64_t e = 0; e < ne; ++e) color_out[e] = 0;
  if (d == 1) return 0;

  // group-ordered working copies: edge id, endpoints, accumulated color
  w.ub_k.resize(ne);
  w.eid.resize(ne);
  w.lsrc.assign(src, src + ne);
  w.ldst.assign(dst, dst + ne);
  w.lcol.assign(ne, 0);
  w.t_eid.resize(ne);
  w.t_src.resize(ne);
  w.t_dst.resize(ne);
  w.t_col.resize(ne);
  for (int64_t e = 0; e < ne; ++e) w.eid[e] = (int32_t)e;

  const int64_t n_nodes = (int64_t)n_left + n_right;
  const int32_t max_depth = [] (int32_t dd) {
    int32_t b = 0; while ((1 << b) < dd) ++b; return b; } (d);

  // breadth-first over depth levels: at each level every group splits in
  // two via a stable partition of the parallel arrays.  Groups tile
  // [0, ne) contiguously, so each group partitions into the SAME global
  // range of the t_ buffers and one pointer swap per depth replaces a
  // full copy-back pass (the copy-back measured ~1.3 s per 14.7M-edge
  // coloring).
  std::vector<int64_t> offs{0, ne};
  for (int32_t depth = 0; depth < max_depth; ++depth) {
    std::vector<int64_t> next_offs{0};
    for (size_t g = 0; g + 1 < offs.size(); ++g) {
      const int64_t off = offs[g], len = offs[g + 1] - offs[g];
      if (len > 0) {
        if (len < g_fast_min || getenv("SBLAS_COLOR_SERIAL") ||
            !fast_halve(w.lsrc.data() + off, w.ldst.data() + off, n_left,
                        n_nodes, len, w.ub_k.data(), w.head, w.ptr,
                        w.slots, w.segs))
          euler_halve(w.lsrc.data() + off, w.ldst.data() + off, n_left,
                      n_nodes, len, w.ub_k.data(), w.head, w.inc64, w.ptr);
        int64_t n1 = 0;
        for (int64_t k = 0; k < len; ++k) n1 += (w.ub_k[k] >> 1) & 1;
        if (n1 * 2 != len) return 4;  // degrees were odd
        const int64_t len0 = len - n1;
        int64_t p0 = off, p1 = off + len0;
        for (int64_t k = 0; k < len; ++k) {
          const int64_t e = off + k;
          const int32_t bit = (w.ub_k[k] >> 1) & 1;
          const int64_t t = bit ? p1++ : p0++;
          w.t_eid[t] = w.eid[e];
          w.t_src[t] = w.lsrc[e];
          w.t_dst[t] = w.ldst[e];
          w.t_col[t] = w.lcol[e] | (bit << depth);
        }
        next_offs.push_back(off + len0);
      } else {
        next_offs.push_back(off);
      }
      next_offs.push_back(off + len);
    }
    w.eid.swap(w.t_eid);
    w.lsrc.swap(w.t_src);
    w.ldst.swap(w.t_dst);
    w.lcol.swap(w.t_col);
    offs = std::move(next_offs);
  }

  for (int64_t k = 0; k < ne; ++k) color_out[w.eid[k]] = w.lcol[k];
  return 0;
}

}  // namespace

extern "C" {

// Color a block-diagonal d-regular bipartite multigraph with exactly d
// colors (each node sees every color once).  The graph is n_blocks
// independent subgraphs: block b owns the contiguous edge slice
// [b*epb, (b+1)*epb) and the node ranges [b*npb, (b+1)*npb) on both
// sides.  d must be a power of two; every node must have exactly d
// incident edges within its block (pad with dummy edges first).
//
// Block-diagonality is the route recursion's gift (ops/route.py): every
// level below the first permutes within blocks whose whole coloring
// problem (incidence lists, Euler walk, partitions) fits in L2 — the
// flat global formulation instead chased pointers across the full edge
// set at every level, which on this host's ~14x random-access penalty
// dominated plan-build time.  Returns 0 on success, nonzero on bad input.
int sblas_edge_color_blocked(int32_t n_blocks, int32_t npb_left,
                             int32_t npb_right, int64_t epb, int32_t d,
                             const int32_t* src, const int32_t* dst,
                             int32_t* color_out) {
  if (d <= 0 || (d & (d - 1)) != 0) return 1;
  if (n_blocks <= 0) return 2;
  const char* fm = getenv("SBLAS_COLOR_FASTMIN");
  g_fast_min = fm ? atoll(fm) : kFastMinDefault;
  const int64_t ne = (int64_t)n_blocks * epb;
  if (epb != (int64_t)npb_left * d || epb != (int64_t)npb_right * d)
    return 2;
  // int32-indexed internals cover 2*ne incidence POSITIONS, not just
  // ne edges — the bound is 2^30 edges, not 2^31
  if (ne >= (int64_t)1 << 30) return 5;
  for (int64_t b = 0; b < n_blocks; ++b) {
    const int64_t off = b * epb;
    const int32_t lo_l = (int32_t)(b * npb_left);
    const int32_t lo_r = (int32_t)(b * npb_right);
    for (int64_t k = 0; k < epb; ++k) {
      const int32_t s = src[off + k] - lo_l, t = dst[off + k] - lo_r;
      if (s < 0 || s >= npb_left || t < 0 || t >= npb_right) return 3;
    }
  }

  ColorWork w;
  std::vector<int32_t> bsrc(epb), bdst(epb);
  for (int64_t b = 0; b < n_blocks; ++b) {
    const int64_t off = b * epb;
    const int32_t lo_l = (int32_t)(b * npb_left);
    const int32_t lo_r = (int32_t)(b * npb_right);
    for (int64_t k = 0; k < epb; ++k) {
      bsrc[k] = src[off + k] - lo_l;
      bdst[k] = dst[off + k] - lo_r;
    }
    const int rc = color_one(npb_left, npb_right, epb, d, bsrc.data(),
                             bdst.data(), color_out + off, w);
    if (rc != 0) return rc;
  }
  if (getenv("SBLAS_COLOR_PROF")) {
    fprintf(stderr, "[color] ne=%lld blocks=%d build=%.2fs walk=%.2fs\n",
            (long long)ne, n_blocks, g_build_s, g_walk_s);
    g_build_s = g_walk_s = 0;
  }
  return 0;
}

// Single-graph entry point (n_blocks == 1), kept as the stable ABI the
// ctypes bridge binds when the blocked symbol is absent.
int sblas_edge_color(int32_t n_left, int32_t n_right, int64_t ne, int32_t d,
                     const int32_t* src, const int32_t* dst,
                     int32_t* color_out) {
  if (ne != (int64_t)n_left * d || ne != (int64_t)n_right * d) return 2;
  return sblas_edge_color_blocked(1, n_left, n_right, ne, d, src, dst,
                                  color_out);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Fused route-level builder.
//
// One level of the route recursion (ops/route.py::rec) turns a block-local
// permutation p (blocks of size bs) into three tables: the edge coloring
// (emitted as the level's destination lane shuffle), the source lane
// shuffle idx1, and — for the recursion — the next level's permutation q
// (or, at the mix base case, the per-lane row table rho_local).  The
// numpy formulation costs ~6 streaming passes over N plus an arange and a
// bucketed scatter with materialized address/value temporaries (~3.6 s at
// N=14.7M top level, measured); here each table is one fused pass:
//
//   * coloring inputs (src_row = p>>7, block-local) are generated into the
//     per-block buffers directly — no global arange/dst_row arrays exist;
//   * idx1[(p[i]>>7)*128 + color[i]] = p[i]&127 computes addresses on the
//     fly inside the bucketed scatter (window <= bs, so levels below the
//     top scatter directly into cache-resident block windows);
//   * q fuses the rho scatter, the three-term src_t arithmetic and the
//     per-block (A,128)->(128,A) transpose into one row-local write pass
//     plus one 128x128-tiled transpose pass.
// ---------------------------------------------------------------------------

namespace {

// local 128x128 tile transpose: q[b*bs + c*A + a] = srcT[(b*A+a)*128 + c]
// + (b*bs + c*A), tiled so reads and writes both stream
void emit_q_block(const int32_t* srcT, int64_t b, int64_t bs, int64_t A,
                  int32_t* q) {
  static int32_t buf[128 * 128];
  const int64_t base = b * bs;
  for (int64_t a0 = 0; a0 < A; a0 += 128) {
    const int64_t ta = a0 + 128 <= A ? 128 : A - a0;
    const int32_t* in = srcT + (b * A + a0) * 128;
    for (int64_t a = 0; a < ta; ++a)
      for (int64_t c = 0; c < 128; ++c)
        buf[c * 128 + a] = in[a * 128 + c];
    for (int64_t c = 0; c < 128; ++c) {
      int32_t* out = q + base + c * A + a0;
      const int32_t add = (int32_t)(base + c * A);
      const int32_t* row = buf + c * 128;
      for (int64_t a = 0; a < ta; ++a) out[a] = row[a] + add;
    }
  }
}

}  // namespace

extern "C" {

// One route level: inputs p (n, int32; permutation within blocks of bs)
// and outputs color (n,), idx1 (n,) and qrho (n,).  When bs/128 <=
// mix_max, qrho holds rho_local (the mix table) and the recursion stops;
// otherwise qrho holds q, the next level's block-local permutation
// (blocks of bs/128).  Returns 0 on success; nonzero codes mirror
// sblas_edge_color_blocked.
int sblas_route_level(int64_t n, int64_t bs, int32_t mix_max,
                      const int32_t* p, int32_t* color, int32_t* idx1,
                      int32_t* qrho) {
  if (bs <= 128 || bs % 128 || n % bs || n >= ((int64_t)1 << 30)) return 2;
  const char* fm = getenv("SBLAS_COLOR_FASTMIN");
  g_fast_min = fm ? atoll(fm) : kFastMinDefault;
  const int64_t A = bs >> 7;
  const int64_t n_blocks = n / bs;
  const int32_t npb = (int32_t)A;  // block-local rows per side

  // ---- coloring, per block, inputs generated on the fly ----
  ColorWork w;
  std::vector<int32_t> bsrc(bs), bdst(bs);
  for (int64_t k = 0; k < bs; ++k) bdst[k] = (int32_t)(k >> 7);
  for (int64_t b = 0; b < n_blocks; ++b) {
    const int64_t off = b * bs;
    const int32_t lo = (int32_t)(b * A);
    for (int64_t k = 0; k < bs; ++k) {
      const int32_t s = (p[off + k] >> 7) - lo;
      if (s < 0 || s >= npb) return 3;  // permutation crosses blocks
      bsrc[k] = s;
    }
    const int rc = color_one(npb, npb, bs, 128, bsrc.data(), bdst.data(),
                             color + off, w);
    if (rc != 0) return rc;
  }
  if (getenv("SBLAS_COLOR_PROF")) {
    fprintf(stderr, "[color] ne=%lld blocks=%lld build=%.2fs walk=%.2fs\n",
            (long long)n, (long long)n_blocks, g_build_s, g_walk_s);
    g_build_s = g_walk_s = 0;
  }

  // ---- idx1: fused bucketed scatter (addresses stay within each
  // block's [b*bs, (b+1)*bs) window) ----
  if (bs <= ((int64_t)1 << 17)) {
    // window is cache-resident: scatter directly
    for (int64_t i = 0; i < n; ++i)
      idx1[((int64_t)(p[i] >> 7) << 7) + color[i]] = p[i] & 127;
  } else {
    const int64_t region = (128 << 10) / 4;
    int32_t rbits = 0;
    while (((int64_t)1 << rbits) < region) ++rbits;
    const int64_t n_buckets = ((n - 1) >> rbits) + 1;
    std::vector<int64_t> cnt(n_buckets + 1, 0);
    for (int64_t i = 0; i < n; ++i)
      ++cnt[(((((int64_t)(p[i] >> 7)) << 7) + color[i]) >> rbits) + 1];
    for (int64_t b = 0; b < n_buckets; ++b) cnt[b + 1] += cnt[b];
    std::vector<int32_t> t_addr(n), t_val(n);
    std::vector<int64_t> pos(cnt.begin(), cnt.end() - 1);
    for (int64_t i = 0; i < n; ++i) {
      const int64_t addr = (((int64_t)(p[i] >> 7)) << 7) + color[i];
      const int64_t t = pos[addr >> rbits]++;
      t_addr[t] = (int32_t)addr;
      t_val[t] = p[i] & 127;
    }
    for (int64_t i = 0; i < n; ++i) idx1[t_addr[i]] = t_val[i];
  }

  // ---- qrho ----
  if (A <= mix_max) {
    // rho_local[rd*128 + c] = src_row - b*A  (row-local writes: rd = i>>7)
    for (int64_t b = 0; b < n_blocks; ++b) {
      const int64_t off = b * bs;
      const int32_t lo = (int32_t)(b * A);
      for (int64_t i = off; i < off + bs; ++i)
        qrho[((i >> 7) << 7) + color[i]] = (p[i] >> 7) - lo;
    }
    return 0;
  }
  // srcT[rd*128 + c] = a_src = src_row - b*A, then tiled transpose+offset
  std::vector<int32_t> srcT(n);
  for (int64_t b = 0; b < n_blocks; ++b) {
    const int64_t off = b * bs;
    const int32_t lo = (int32_t)(b * A);
    for (int64_t i = off; i < off + bs; ++i)
      srcT[((i >> 7) << 7) + color[i]] = (p[i] >> 7) - lo;
  }
  for (int64_t b = 0; b < n_blocks; ++b)
    emit_q_block(srcT.data(), b, bs, A, qrho);
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Bucketed scatter: out[addr[k]] = val[k] with cache-resident write windows.
//
// This host pays ~14x for random memory access (CLAUDE.md): a numpy fancy
// scatter of 4.2M int32 to random addresses measured 4.9 s (1.16 us/write)
// where a structured scatter of the same size is 94 ms.  Radix-partitioning
// the (addr, val) pairs by address high bits first confines each final
// write burst to a ~128 KiB window of `out`, turning the whole operation
// into ~3 streaming passes.  Used by the route builder (ops/route.py) and
// the routed-plan layout (ops/rspmv.py), whose permutation scatters
// dominate plan-build time otherwise.  Duplicate addresses keep numpy's
// last-write-wins order (the partition is stable within buckets).
// ---------------------------------------------------------------------------

namespace {

template <typename T>
void scatter_bucketed(int64_t ne, int64_t n_out, const int32_t* addr,
                      const T* val, T* out) {
  // direct scatter for small problems: the bucketing passes cost more
  // than the misses they avoid below ~256k elements
  if (ne < (int64_t)1 << 18 || n_out < (int64_t)1 << 18) {
    for (int64_t k = 0; k < ne; ++k) out[addr[k]] = val[k];
    return;
  }
  // bucket so each out-region is ~128 KiB
  const int64_t region = (128 << 10) / (int64_t)sizeof(T);
  // bucket = addr >> rbits, each bucket spanning one ~128 KiB region
  int32_t rbits = 0;
  while (((int64_t)1 << rbits) < region) ++rbits;
  const int64_t n_buckets = ((n_out - 1) >> rbits) + 1;

  std::vector<int64_t> cnt(n_buckets + 1, 0);
  for (int64_t k = 0; k < ne; ++k) ++cnt[(addr[k] >> rbits) + 1];
  for (int64_t b = 0; b < n_buckets; ++b) cnt[b + 1] += cnt[b];
  std::vector<int32_t> t_addr(ne);
  std::vector<T> t_val(ne);
  std::vector<int64_t> pos(cnt.begin(), cnt.end() - 1);
  for (int64_t k = 0; k < ne; ++k) {
    const int64_t p = pos[addr[k] >> rbits]++;
    t_addr[p] = addr[k];
    t_val[p] = val[k];
  }
  for (int64_t k = 0; k < ne; ++k) out[t_addr[k]] = t_val[k];
}

}  // namespace

extern "C" {

int sblas_scatter_i8(int64_t ne, int64_t n_out, const int32_t* addr,
                     const int8_t* val, int8_t* out) {
  scatter_bucketed<int8_t>(ne, n_out, addr, val, out);
  return 0;
}

int sblas_scatter_i32(int64_t ne, int64_t n_out, const int32_t* addr,
                      const int32_t* val, int32_t* out) {
  scatter_bucketed<int32_t>(ne, n_out, addr, val, out);
  return 0;
}

int sblas_scatter_f32(int64_t ne, int64_t n_out, const int32_t* addr,
                      const float* val, float* out) {
  scatter_bucketed<float>(ne, n_out, addr, val, out);
  return 0;
}

int sblas_scatter_f64(int64_t ne, int64_t n_out, const int32_t* addr,
                      const double* val, double* out) {
  scatter_bucketed<double>(ne, n_out, addr, val, out);
  return 0;
}

}  // extern "C"
