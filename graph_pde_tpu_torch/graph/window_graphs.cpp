// One window of the general MGKN's multi-mesh splitter in one pass: the
// per-level radius graphs of RandomMultiMeshSplitter.splitter, emitted in
// the order and the dtypes of the padded MultiLevelGraph arrays.
//
// A window holds L levels of nodes, level l in rows [P_l, P_{l+1}) of one
// point array. Its 3L - 2 edge lists, concatenated in this order:
//
//   mid_l  (l < L):      pairs within level l at radius r_inner[l]; indices
//                        local to the level;
//   down_l (l < L - 1):  level l (senders) to level l + 1 (receivers) at
//                        radius r_inter[l]; indices global in the window;
//   up_l   (l < L - 1):  the down_l edges swapped.
//
// Every list is sorted by (receiver, sender), as graph.py's
// _pad_edge_segments sorts it. Each edge carries the float32 attributes
// [x_src, x_dst, theta_src, theta_dst], the float64 inputs rounded to
// float32 as graph.build.edge_attributes does. Placed into capacities,
// list k is padded as _pad_edge_segments pads it: sender 0, receiver
// park[k] - 1, attributes 0, mask 0.
//
// The edge set is native/graph_build.cpp's gpde_radius_graph's, bit for
// bit: the same cells (floor(p / r) per axis), the same neighbour relation
// (cells at most one apart on every axis, which does not depend on which
// side is binned), and the same float64 test, d2 += diff * diff over the
// axes, d2 <= r * r, whose squares do not depend on the sign of diff.
//
// ABI (ctypes): two-phase, as the splitter needs every window's counts
// before it knows the capacities. gpde_window_graphs builds a window into
// a numbered thread-local slot and returns its counts; gpde_place_window
// writes a slot's lists, padded to the capacities, into the caller's
// arrays. The slots keep their memory between calls, so a steady stream
// of windows of one shape allocates nothing.

#include <algorithm>
#include <array>
#include <cmath>
#include <cstdint>
#include <numeric>
#include <vector>

namespace {

using Key = std::array<int64_t, 3>;

struct Edges {
    std::vector<int32_t> senders;
    std::vector<int32_t> receivers;
    std::vector<float> attr;
    std::vector<int64_t> counts;    // edges of each list, in list order
    int64_t a_dim = 0;
};

thread_local std::vector<Edges> g_slots;

inline Key cell_of(const double* p, int64_t dim, double inv_r) {
    Key k{{0, 0, 0}};
    for (int64_t j = 0; j < dim; ++j)
        k[j] = static_cast<int64_t>(std::floor(p[j] * inv_r));
    return k;
}

// Appends the edges from the ns senders at rows s_row.. of the window's
// `pts` to the nr receivers at rows r_row.., receivers ascending and each
// receiver's senders ascending, with their attributes. Indices are
// written as s_base + i and r_base + j.
//
// The receivers are binned; the senders, in ascending order, find their
// hits, which a counting sort by receiver (stable, so senders stay
// ascending) then writes in place.
void connect(const double* pts, const double* theta, int64_t dim,
             int64_t s_row, int64_t ns, int64_t r_row, int64_t nr, double r,
             int64_t s_base, int64_t r_base, Edges& out) {
    const double inv_r = 1.0 / r;
    const double r2 = r * r;
    const double* send = pts + s_row * dim;
    const double* recv = pts + r_row * dim;

    // receivers sorted by cell: the cells that differ only in the last
    // axis form one contiguous range
    std::vector<Key> cell(nr);
    for (int64_t j = 0; j < nr; ++j)
        cell[j] = cell_of(recv + j * dim, dim, inv_r);
    std::vector<int64_t> order(nr);
    std::iota(order.begin(), order.end(), 0);
    std::sort(order.begin(), order.end(),
              [&](int64_t a, int64_t b) { return cell[a] < cell[b]; });
    std::vector<Key> keys(nr);
    for (int64_t k = 0; k < nr; ++k) keys[k] = cell[order[k]];

    std::vector<int32_t> hit_s, hit_r;
    std::vector<int64_t> offset(nr + 1, 0);
    size_t n_hits = 0;
    const int64_t last = dim - 1;
    const int64_t d0 = dim > 1 ? 1 : 0, d1 = dim > 2 ? 1 : 0;
    for (int64_t i = 0; i < ns; ++i) {
        const double* p = send + i * dim;
        const Key base = cell_of(p, dim, inv_r);
        for (int64_t o0 = -d0; o0 <= d0; ++o0)
        for (int64_t o1 = -d1; o1 <= d1; ++o1) {
            Key lo = base, hi = base;
            if (last > 0) { lo[0] += o0; hi[0] += o0; }
            if (last > 1) { lo[1] += o1; hi[1] += o1; }
            lo[last] -= 1;
            hi[last] += 1;
            const int64_t kb = std::lower_bound(keys.begin(), keys.end(),
                                                lo) - keys.begin();
            const int64_t ke = std::upper_bound(keys.begin() + kb,
                                                keys.end(), hi)
                               - keys.begin();
            // every candidate is written, and kept by advancing the end
            // only when it is a hit: no branch on the test
            if (hit_s.size() < n_hits + (ke - kb)) {
                hit_s.resize(2 * (n_hits + (ke - kb)));
                hit_r.resize(hit_s.size());
            }
            for (int64_t k = kb; k < ke; ++k) {
                const int64_t j = order[k];
                const double* q = recv + j * dim;
                double d2 = 0.0;
                for (int64_t t = 0; t < dim; ++t) {
                    double diff = p[t] - q[t];
                    d2 += diff * diff;
                }
                const bool hit = d2 <= r2;
                hit_s[n_hits] = static_cast<int32_t>(i);
                hit_r[n_hits] = static_cast<int32_t>(j);
                n_hits += hit;
                offset[j + 1] += hit;
            }
        }
    }
    for (int64_t j = 0; j < nr; ++j) offset[j + 1] += offset[j];

    const size_t first = out.senders.size();
    const int64_t a_dim = 2 * dim + 2;
    out.senders.resize(first + n_hits);
    out.receivers.resize(first + n_hits);
    out.attr.resize((first + n_hits) * a_dim);
    for (size_t k = 0; k < n_hits; ++k) {
        const int64_t i = hit_s[k], j = hit_r[k];
        const size_t e = first + offset[j]++;
        out.senders[e] = static_cast<int32_t>(s_base + i);
        out.receivers[e] = static_cast<int32_t>(r_base + j);
        float* a = out.attr.data() + e * a_dim;
        const double* p = send + i * dim;
        const double* q = recv + j * dim;
        for (int64_t t = 0; t < dim; ++t) {
            a[t] = static_cast<float>(p[t]);
            a[dim + t] = static_cast<float>(q[t]);
        }
        a[2 * dim] = static_cast<float>(theta[s_row + i]);
        a[2 * dim + 1] = static_cast<float>(theta[r_row + j]);
    }
}

}  // namespace

extern "C" {

// Builds one window's 3L - 2 edge lists into slot `slot`. pts: [n_tot,
// dim] float64 node coordinates, n_tot = sum(sizes); theta: [n_tot]
// float64 edge-attribute field; r_inner: [L]; r_inter: [L - 1]. Writes
// each list's edge count to counts[3L - 2]. Returns the total count, or
// -1 on invalid input.
int64_t gpde_window_graphs(const double* pts, int64_t dim,
                           const int64_t* sizes, int64_t levels,
                           const double* r_inner, const double* r_inter,
                           const double* theta, int64_t slot,
                           int64_t* counts) {
    if (dim < 1 || dim > 3 || levels < 1 || slot < 0) return -1;
    std::vector<int64_t> start(levels + 1, 0);
    for (int64_t l = 0; l < levels; ++l) {
        if (sizes[l] <= 0 || r_inner[l] <= 0.0) return -1;
        if (l + 1 < levels && r_inter[l] <= 0.0) return -1;
        start[l + 1] = start[l] + sizes[l];
    }
    const int64_t n_tot = start[levels];
    if (n_tot > INT32_MAX) return -1;

    if (static_cast<int64_t>(g_slots.size()) <= slot) g_slots.resize(slot + 1);
    Edges& out = g_slots[slot];
    out.senders.clear();
    out.receivers.clear();
    out.attr.clear();
    out.counts.clear();
    out.a_dim = 2 * dim + 2;
    auto add = [&](int64_t s_row, int64_t ns, int64_t r_row, int64_t nr,
                   double r, int64_t s_base, int64_t r_base) {
        const size_t first = out.senders.size();
        connect(pts, theta, dim, s_row, ns, r_row, nr, r, s_base, r_base,
                out);
        out.counts.push_back(
            static_cast<int64_t>(out.senders.size() - first));
    };
    for (int64_t l = 0; l < levels; ++l)              // mid: local indices
        add(start[l], sizes[l], start[l], sizes[l], r_inner[l], 0, 0);
    for (int64_t l = 0; l + 1 < levels; ++l)          // down: fine -> coarse
        add(start[l], sizes[l], start[l + 1], sizes[l + 1], r_inter[l],
            start[l], start[l + 1]);
    for (int64_t l = 0; l + 1 < levels; ++l)          // up: coarse -> fine
        add(start[l + 1], sizes[l + 1], start[l], sizes[l], r_inter[l],
            start[l + 1], start[l]);
    std::copy(out.counts.begin(), out.counts.end(), counts);
    return static_cast<int64_t>(out.senders.size());
}

// Writes slot `slot`'s n_lists lists into the caller's arrays of
// sum(caps) entries, list k at offset caps[0] + ... + caps[k - 1] and
// padded to caps[k]: senders and receivers int32, attr float32 [sum(caps),
// a_dim], mask one byte an edge. Returns 0, or -1 when the slot holds no
// window of n_lists lists and a_dim attributes, or a list exceeds its
// capacity.
int64_t gpde_place_window(int64_t slot, int64_t n_lists, const int64_t* caps,
                          const int64_t* parks, int64_t a_dim,
                          int32_t* senders, int32_t* receivers, float* attr,
                          uint8_t* mask) {
    if (slot < 0 || slot >= static_cast<int64_t>(g_slots.size())) return -1;
    const Edges& in = g_slots[slot];
    if (static_cast<int64_t>(in.counts.size()) != n_lists
        || in.a_dim != a_dim) return -1;
    for (int64_t k = 0; k < n_lists; ++k)
        if (caps[k] < in.counts[k]) return -1;
    int64_t src = 0, dst = 0;
    for (int64_t k = 0; k < n_lists; ++k) {
        const int64_t e = in.counts[k], cap = caps[k];
        std::copy_n(in.senders.data() + src, e, senders + dst);
        std::fill_n(senders + dst + e, cap - e, 0);
        std::copy_n(in.receivers.data() + src, e, receivers + dst);
        std::fill_n(receivers + dst + e, cap - e,
                    static_cast<int32_t>(parks[k] - 1));
        std::copy_n(in.attr.data() + src * a_dim, e * a_dim,
                    attr + dst * a_dim);
        std::fill_n(attr + (dst + e) * a_dim, (cap - e) * a_dim, 0.0f);
        std::fill_n(mask + dst, e, uint8_t{1});
        std::fill_n(mask + dst + e, cap - e, uint8_t{0});
        src += e;
        dst += cap;
    }
    return 0;
}

}  // extern "C"
