// Native host kernels for empanada_tpu.
//
// These replace the reference's numba nopython kernels
// (empanada/array_utils.py, empanada/zarr_utils.py,
//  empanada/inference/watershed.py) with C++ implementations exposed via a
// plain C ABI and loaded through ctypes (no pybind11 in this environment).
//
// Everything here is host-side stitching/IO work: connected components over
// RLE runs, two-pointer RLE set ops, k-of-n pixel voting, instance filling,
// and the inherently sequential heap watershed.

#include <algorithm>
#include <cstdint>
#include <limits>
#include <cstring>
#include <queue>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Union-find connected components over horizontal runs.
// Runs must be sorted row-major (guaranteed by extract_runs).
// Two runs connect iff |row diff| == 1, same value, and column intervals
// touch (8-connectivity pads by 1 for diagonal adjacency).
// Output comp ids are numbered 1..k in order of first appearance.
// ---------------------------------------------------------------------------

static int64_t uf_find(std::vector<int64_t>& parent, int64_t x) {
    int64_t root = x;
    while (parent[root] != root) root = parent[root];
    while (parent[x] != root) {
        int64_t next = parent[x];
        parent[x] = root;
        x = next;
    }
    return root;
}

static void uf_union(std::vector<int64_t>& parent, int64_t a, int64_t b) {
    int64_t ra = uf_find(parent, a);
    int64_t rb = uf_find(parent, b);
    if (ra == rb) return;
    if (ra < rb) parent[rb] = ra; else parent[ra] = rb;
}

void cc_runs(const int64_t* values, const int64_t* rows, const int64_t* col_starts,
             const int64_t* col_ends, int64_t n, int connectivity, int64_t* out_comp) {
    if (n == 0) return;
    std::vector<int64_t> parent(n);
    for (int64_t i = 0; i < n; ++i) parent[i] = i;
    const int64_t pad = (connectivity == 8) ? 1 : 0;

    // index of the first run of each row segment
    int64_t prev_begin = 0, prev_end = 0;  // runs of row r-1 in [prev_begin, prev_end)
    int64_t cur_begin = 0;
    while (cur_begin < n) {
        int64_t cur_row = rows[cur_begin];
        int64_t cur_end = cur_begin;
        while (cur_end < n && rows[cur_end] == cur_row) ++cur_end;

        if (prev_end > prev_begin && rows[prev_begin] == cur_row - 1) {
            int64_t i = prev_begin, j = cur_begin;
            while (i < prev_end && j < cur_end) {
                if (col_ends[i] + pad <= col_starts[j]) { ++i; }
                else if (col_ends[j] + pad <= col_starts[i]) { ++j; }
                else {
                    if (values[i] == values[j]) uf_union(parent, i, j);
                    if (col_ends[i] < col_ends[j]) ++i; else ++j;
                }
            }
        }
        prev_begin = cur_begin;
        prev_end = cur_end;
        cur_begin = cur_end;
    }

    // renumber roots by first appearance
    std::vector<int64_t> remap(n, 0);
    int64_t next_id = 1;
    for (int64_t i = 0; i < n; ++i) {
        int64_t r = uf_find(parent, i);
        if (remap[r] == 0) remap[r] = next_id++;
        out_comp[i] = remap[r];
    }
}

// ---------------------------------------------------------------------------
// Two-pointer intersection between two sorted disjoint range sets.
// ---------------------------------------------------------------------------

int64_t range_intersection(const int64_t* a, int64_t na, const int64_t* b, int64_t nb) {
    int64_t total = 0;
    int64_t i = 0, j = 0;
    while (i < na && j < nb) {
        int64_t lo = std::max(a[2 * i], b[2 * j]);
        int64_t hi = std::min(a[2 * i + 1], b[2 * j + 1]);
        if (hi > lo) total += hi - lo;
        if (a[2 * i + 1] < b[2 * j + 1]) ++i; else ++j;
    }
    return total;
}

// ---------------------------------------------------------------------------
// Two-pointer union of two sorted disjoint range sets into a sorted
// disjoint output (adjacent/overlapping ranges coalesce).  The cross-slice
// matcher merges instance RLEs on every false-split absorption
// (reference matcher.py:14 merge_attrs) — a concat+sort there costs ~50 us
// per merge in numpy; this is linear.  Returns the output count (<= na+nb).
// ---------------------------------------------------------------------------

int64_t range_union(const int64_t* a, int64_t na, const int64_t* b, int64_t nb,
                    int64_t* out) {
    int64_t i = 0, j = 0, n_out = 0;
    int64_t cur_s = 0, cur_e = -1;
    bool open = false;
    while (i < na || j < nb) {
        int64_t s, e;
        if (j >= nb || (i < na && a[2 * i] <= b[2 * j])) {
            s = a[2 * i]; e = a[2 * i + 1]; ++i;
        } else {
            s = b[2 * j]; e = b[2 * j + 1]; ++j;
        }
        if (!open) {
            cur_s = s; cur_e = e; open = true;
        } else if (s <= cur_e) {
            if (e > cur_e) cur_e = e;
        } else {
            out[2 * n_out] = cur_s;
            out[2 * n_out + 1] = cur_e;
            ++n_out;
            cur_s = s; cur_e = e;
        }
    }
    if (open) {
        out[2 * n_out] = cur_s;
        out[2 * n_out + 1] = cur_e;
        ++n_out;
    }
    return n_out;
}

// ---------------------------------------------------------------------------
// Batched grouped range union: members of group g occupy
// ranges[group_offsets[g] : group_offsets[g+1]); each group's ranges are
// sorted by start and coalesced (overlap or adjacency) into the output.
// out has capacity n_ranges; out_offsets (n_groups+1) receives group
// extents.  One call replaces thousands of per-group numpy unions in the
// cross-slice matcher's false-split merging.
// ---------------------------------------------------------------------------

int64_t batch_range_union(const int64_t* ranges, const int64_t* group_offsets,
                          int64_t n_groups, int64_t* out, int64_t* out_offsets) {
    int64_t n_out = 0;
    out_offsets[0] = 0;
    std::vector<std::pair<int64_t, int64_t>> buf;
    for (int64_t g = 0; g < n_groups; ++g) {
        int64_t lo = group_offsets[g], hi = group_offsets[g + 1];
        buf.clear();
        buf.reserve(hi - lo);
        for (int64_t i = lo; i < hi; ++i)
            buf.emplace_back(ranges[2 * i], ranges[2 * i + 1]);
        std::sort(buf.begin(), buf.end());
        bool open = false;
        int64_t cs = 0, ce = -1;
        for (const auto& r : buf) {
            if (!open) { cs = r.first; ce = r.second; open = true; }
            else if (r.first <= ce) { if (r.second > ce) ce = r.second; }
            else {
                out[2 * n_out] = cs; out[2 * n_out + 1] = ce; ++n_out;
                cs = r.first; ce = r.second;
            }
        }
        if (open) { out[2 * n_out] = cs; out[2 * n_out + 1] = ce; ++n_out; }
        out_offsets[g + 1] = n_out;
    }
    return n_out;
}

// ---------------------------------------------------------------------------
// Collision-group merge straight from a FlatInstances buffer: group g's
// members are member_order[member_bounds[g] : member_bounds[g+1]]; each
// member's runs are gathered, sorted, coalesced (union), and the members'
// boxes reduced to the enclosing box — one call per slice instead of the
// ~10-op numpy chain in stitch/matcher._merge_collisions.  Boxes are
// (n, 4) [lo_y, lo_x, hi_y, hi_x].  Returns total output runs.
// ---------------------------------------------------------------------------

int64_t merge_groups_flat(
    const int64_t* starts, const int64_t* runs, const int64_t* offsets,
    const int64_t* boxes, const int64_t* member_order,
    const int64_t* member_bounds, int64_t n_groups,
    int64_t* out_starts, int64_t* out_runs, int64_t* out_offsets,
    int64_t* out_boxes) {
    int64_t n_out = 0;
    out_offsets[0] = 0;
    std::vector<std::pair<int64_t, int64_t>> buf;
    for (int64_t g = 0; g < n_groups; ++g) {
        buf.clear();
        int64_t b0 = 0, b1 = 0, b2 = 0, b3 = 0;
        for (int64_t m = member_bounds[g]; m < member_bounds[g + 1]; ++m) {
            const int64_t k = member_order[m];
            const int64_t* bx = boxes + 4 * k;
            if (m == member_bounds[g]) {
                b0 = bx[0]; b1 = bx[1]; b2 = bx[2]; b3 = bx[3];
            } else {
                if (bx[0] < b0) b0 = bx[0];
                if (bx[1] < b1) b1 = bx[1];
                if (bx[2] > b2) b2 = bx[2];
                if (bx[3] > b3) b3 = bx[3];
            }
            for (int64_t i = offsets[k]; i < offsets[k + 1]; ++i)
                buf.emplace_back(starts[i], starts[i] + runs[i]);
        }
        std::sort(buf.begin(), buf.end());
        bool open = false;
        int64_t cs = 0, ce = -1;
        for (const auto& r : buf) {
            if (!open) { cs = r.first; ce = r.second; open = true; }
            else if (r.first <= ce) { if (r.second > ce) ce = r.second; }
            else {
                out_starts[n_out] = cs;
                out_runs[n_out] = ce - cs;
                ++n_out;
                cs = r.first; ce = r.second;
            }
        }
        if (open) {
            out_starts[n_out] = cs;
            out_runs[n_out] = ce - cs;
            ++n_out;
        }
        out_offsets[g + 1] = n_out;
        out_boxes[4 * g] = b0; out_boxes[4 * g + 1] = b1;
        out_boxes[4 * g + 2] = b2; out_boxes[4 * g + 3] = b3;
    }
    return n_out;
}

// ---------------------------------------------------------------------------
// Batched pairwise intersection: all instances' ranges live in one flat
// buffer with per-instance [row_offsets[i], row_offsets[i+1]) extents;
// for each (a, b) pair, two-pointer intersection.  Replaces a per-pair
// Python loop in the Hungarian matcher.
// ---------------------------------------------------------------------------

void batch_pair_intersection(const int64_t* ranges, const int64_t* row_offsets,
                             const int64_t* pairs, int64_t n_pairs,
                             int64_t max_threads, int64_t* out) {
    auto work = [&](int64_t begin, int64_t end) {
        for (int64_t k = begin; k < end; ++k) {
            int64_t a = pairs[2 * k], b = pairs[2 * k + 1];
            const int64_t* ra = ranges + 2 * row_offsets[a];
            const int64_t* rb = ranges + 2 * row_offsets[b];
            out[k] = range_intersection(ra, row_offsets[a + 1] - row_offsets[a],
                                        rb, row_offsets[b + 1] - row_offsets[b]);
        }
    };
    // pairs are independent and outputs disjoint — thread the scan for the
    // consensus workload (3D instances carry tens of thousands of runs).
    // max_threads <= 0 means auto; callers already inside a thread pool
    // pass 1 to avoid oversubscription.
    const int64_t kMinPairsPerThread = 64;
    int64_t n_threads = max_threads > 0
        ? max_threads
        : static_cast<int64_t>(std::thread::hardware_concurrency());
    if (n_threads > 8) n_threads = 8;
    if (n_threads > n_pairs / kMinPairsPerThread)
        n_threads = n_pairs / kMinPairsPerThread;
    if (n_threads < 2) {
        work(0, n_pairs);
        return;
    }
    std::vector<std::thread> threads;
    threads.reserve(n_threads);
    int64_t chunk = (n_pairs + n_threads - 1) / n_threads;
    for (int64_t t = 0; t < n_threads; ++t) {
        int64_t begin = t * chunk;
        int64_t end = std::min(n_pairs, begin + chunk);
        if (begin >= end) break;
        threads.emplace_back(work, begin, end);
    }
    for (auto& th : threads) th.join();
}

// ---------------------------------------------------------------------------
// k-of-n coverage voting over sorted (by start) ranges.
// Writes at most `n` output ranges; returns the count.
// ---------------------------------------------------------------------------

int64_t vote_ranges(const int64_t* ranges, int64_t n, int64_t vote_thr, int64_t* out) {
    if (n == 0) return 0;
    // event sweep
    std::vector<std::pair<int64_t, int64_t>> events;
    events.reserve(2 * n);
    for (int64_t i = 0; i < n; ++i) {
        events.emplace_back(ranges[2 * i], 1);
        events.emplace_back(ranges[2 * i + 1], -1);
    }
    std::sort(events.begin(), events.end());

    int64_t count = 0, coverage = 0, run_start = 0, n_out = 0;
    bool in_run = false;
    size_t k = 0;
    while (k < events.size()) {
        int64_t pos = events[k].first;
        while (k < events.size() && events[k].first == pos) {
            coverage += events[k].second;
            ++k;
        }
        if (!in_run && coverage >= vote_thr) {
            run_start = pos;
            in_run = true;
        } else if (in_run && coverage < vote_thr) {
            out[2 * n_out] = run_start;
            out[2 * n_out + 1] = pos;
            ++n_out;
            in_run = false;
        }
        (void)count;
    }
    return n_out;
}

// ---------------------------------------------------------------------------
// k-of-n coverage voting over k individually SORTED DISJOINT range sets
// (valid RLEs).  Each set's event stream (s0, e0, s1, e1, ...) is already
// non-decreasing, so a k-way merge replaces the O(n log n) event sort of
// vote_ranges — the consensus hot spot at ortho-plane scale where clusters
// carry tens of thousands of 3D runs.  Set g occupies
// ranges[set_offsets[g] : set_offsets[g+1]).  Returns the output count.
// vote_thr == 1 computes the plain union (adjacent ranges coalesce).
// ---------------------------------------------------------------------------

int64_t vote_sorted_sets(const int64_t* ranges, const int64_t* set_offsets,
                         int64_t n_sets, int64_t vote_thr, int64_t* out) {
    // per-set cursor: next event index (2*i = start of range i, 2*i+1 = end)
    std::vector<int64_t> cur(n_sets), lim(n_sets);
    for (int64_t g = 0; g < n_sets; ++g) {
        cur[g] = 2 * set_offsets[g];
        lim[g] = 2 * set_offsets[g + 1];
    }
    auto event_pos = [&](int64_t g) {
        // flat ranges buffer: event k of the stream is ranges[k] with
        // starts at even k, ends at odd k (pairs are (start, end))
        return ranges[cur[g]];
    };

    int64_t coverage = 0, run_start = 0, n_out = 0;
    bool in_run = false;
    while (true) {
        // find the minimum next event position across sets
        int64_t pos = INT64_MAX;
        for (int64_t g = 0; g < n_sets; ++g)
            if (cur[g] < lim[g]) pos = std::min(pos, event_pos(g));
        if (pos == INT64_MAX) break;
        // consume ALL events at this position before evaluating coverage
        for (int64_t g = 0; g < n_sets; ++g) {
            while (cur[g] < lim[g] && event_pos(g) == pos) {
                coverage += (cur[g] & 1) ? -1 : 1;
                ++cur[g];
            }
        }
        if (!in_run && coverage >= vote_thr) {
            run_start = pos;
            in_run = true;
        } else if (in_run && coverage < vote_thr) {
            out[2 * n_out] = run_start;
            out[2 * n_out + 1] = pos;
            ++n_out;
            in_run = false;
        }
    }
    return n_out;
}

// ---------------------------------------------------------------------------
// Fill a flat int array with instance_id over the given (start, end) ranges.
// ---------------------------------------------------------------------------

void fill_ranges_i32(int32_t* flat, const int64_t* ranges, int64_t n, int32_t value) {
    for (int64_t i = 0; i < n; ++i) {
        int64_t s = ranges[2 * i], e = ranges[2 * i + 1];
        std::fill(flat + s, flat + e, value);
    }
}

void fill_ranges_i64(int64_t* flat, const int64_t* ranges, int64_t n, int64_t value) {
    for (int64_t i = 0; i < n; ++i) {
        int64_t s = ranges[2 * i], e = ranges[2 * i + 1];
        std::fill(flat + s, flat + e, value);
    }
}

void fill_ranges_u32(uint32_t* flat, const int64_t* ranges, int64_t n, uint32_t value) {
    for (int64_t i = 0; i < n; ++i) {
        int64_t s = ranges[2 * i], e = ranges[2 * i + 1];
        std::fill(flat + s, flat + e, value);
    }
}

// ---------------------------------------------------------------------------
// Heap ("age"-priority) watershed on a binary mask, seeded by markers.
// Matches the reference's simplified watershed semantics
// (empanada/inference/watershed.py:52): BFS flood in heap-pop order where
// priority is insertion age.  Inherently sequential -> host C++.
// flat arrays are padded by the caller; neighborhood offsets are precomputed.
// ---------------------------------------------------------------------------

void mask_watershed(const uint8_t* mask, int64_t size,
                    const int64_t* marker_locations, int64_t n_markers,
                    const int64_t* neighborhood, int64_t n_neigh,
                    int64_t* output) {
    typedef std::pair<int64_t, int64_t> Elem;  // (age, index)
    std::priority_queue<Elem, std::vector<Elem>, std::greater<Elem>> heap;
    int64_t age = 0;
    for (int64_t m = 0; m < n_markers; ++m) heap.emplace(0, marker_locations[m]);

    while (!heap.empty()) {
        Elem elem = heap.top();
        heap.pop();
        ++age;
        for (int64_t k = 0; k < n_neigh; ++k) {
            int64_t nb = elem.second + neighborhood[k];
            if (nb < 0 || nb >= size) continue;
            if (!mask[nb]) continue;
            if (output[nb]) continue;
            output[nb] = output[elem.second];
            heap.emplace(age, nb);
        }
    }
}

// ---------------------------------------------------------------------------
// Grayscale heap watershed: flood from markers in order of (image value,
// insertion age) — the classic priority-flood used by skimage.watershed.
// `image` is the flooding priority (pass -semantic to flood bright first).
// ---------------------------------------------------------------------------

void gray_watershed(const float* image, const uint8_t* mask, int64_t size,
                    const int64_t* marker_locations, int64_t n_markers,
                    const int64_t* neighborhood, int64_t n_neigh,
                    int64_t* output) {
    struct Elem {
        float value;
        int64_t age;
        int64_t index;
        bool operator>(const Elem& o) const {
            if (value != o.value) return value > o.value;
            return age > o.age;
        }
    };
    std::priority_queue<Elem, std::vector<Elem>, std::greater<Elem>> heap;
    int64_t age = 0;
    for (int64_t m = 0; m < n_markers; ++m) {
        int64_t idx = marker_locations[m];
        heap.push({image[idx], age++, idx});
    }
    while (!heap.empty()) {
        Elem elem = heap.top();
        heap.pop();
        for (int64_t k = 0; k < n_neigh; ++k) {
            int64_t nb = elem.index + neighborhood[k];
            if (nb < 0 || nb >= size) continue;
            if (!mask[nb]) continue;
            if (output[nb]) continue;
            output[nb] = output[elem.index];
            heap.push({image[nb], age++, nb});
        }
    }
}

// ---------------------------------------------------------------------------
// Sweep-line box overlap pairs.
//
// Emits (i, j) index pairs of boxes with strictly positive intersection in
// every dimension (the reference screened candidates with a dense numba
// pairwise box IoU, empanada/array_utils.py:178; the numpy replacement is a
// chunked O(n*m) boolean pass).  This sweep over axis 0 is output-sensitive:
// work = #axis0-overlapping pairs, which on real EM instance sets is
// near-linear in n.
//
// Boxes are (n, 2*nd) int64 [lo_0..lo_{nd-1}, hi_0..hi_{nd-1}].  The two
// sets may alias (self-join): every ordered pair, including the diagonal,
// is then emitted exactly once, matching box_iou(boxes).nonzero().
// Returns the pair count, or -1 if `cap` pairs would be exceeded.
// ---------------------------------------------------------------------------

int64_t box_overlap_pairs(const int64_t* boxes1, int64_t n1,
                          const int64_t* boxes2, int64_t n2,
                          int64_t nd, int64_t* out, int64_t cap) {
    struct Event {
        int64_t coord;
        int32_t kind;   // 0 = end (processed first at equal coord), 1 = start
        int32_t set;    // 0 = boxes1, 1 = boxes2
        int64_t idx;
    };
    std::vector<Event> events;
    events.reserve(2 * (n1 + n2));
    const int64_t* boxes[2] = {boxes1, boxes2};
    const int64_t counts[2] = {n1, n2};
    for (int s = 0; s < 2; ++s) {
        for (int64_t i = 0; i < counts[s]; ++i) {
            const int64_t* b = boxes[s] + 2 * nd * i;
            bool degenerate = false;
            for (int64_t d = 0; d < nd; ++d)
                if (b[nd + d] <= b[d]) { degenerate = true; break; }
            if (degenerate) continue;  // hi > lo required in every dim
            events.push_back({b[0], 1, (int32_t)s, i});
            events.push_back({b[nd], 0, (int32_t)s, i});
        }
    }
    std::sort(events.begin(), events.end(), [](const Event& a, const Event& b) {
        if (a.coord != b.coord) return a.coord < b.coord;
        if (a.kind != b.kind) return a.kind < b.kind;
        if (a.set != b.set) return a.set < b.set;
        return a.idx < b.idx;
    });

    // active lists with O(1) swap-removal
    std::vector<int64_t> active[2];
    std::vector<int64_t> pos[2];
    pos[0].assign(n1, -1);
    pos[1].assign(n2, -1);

    int64_t n_out = 0;
    for (const Event& ev : events) {
        std::vector<int64_t>& own = active[ev.set];
        std::vector<int64_t>& own_pos = pos[ev.set];
        if (ev.kind == 0) {  // end: remove
            int64_t p = own_pos[ev.idx];
            own_pos[own.back()] = p;
            std::swap(own[p], own.back());
            own.pop_back();
            own_pos[ev.idx] = -1;
            continue;
        }
        // start: scan the OTHER set's active list for full-dim overlap
        int other = 1 - ev.set;
        const int64_t* bi = boxes[ev.set] + 2 * nd * ev.idx;
        for (int64_t j : active[other]) {
            const int64_t* bj = boxes[other] + 2 * nd * j;
            bool hit = true;
            for (int64_t d = 1; d < nd; ++d) {
                int64_t lo = std::max(bi[d], bj[d]);
                int64_t hi = std::min(bi[nd + d], bj[nd + d]);
                if (hi <= lo) { hit = false; break; }
            }
            if (!hit) continue;
            if (n_out >= cap) return -1;
            if (ev.set == 0) {
                out[2 * n_out] = ev.idx;
                out[2 * n_out + 1] = j;
            } else {
                out[2 * n_out] = j;
                out[2 * n_out + 1] = ev.idx;
            }
            ++n_out;
        }
        own_pos[ev.idx] = (int64_t)own.size();
        own.push_back(ev.idx);
    }
    return n_out;
}

// ---------------------------------------------------------------------------
// Split sorted ranges at chunk boundaries: a position p belongs to chunk
// (p % modulo) / divisor; ranges crossing a boundary are split so each output
// range lies in exactly one chunk along this axis.
// Worst case output size: n + total_boundaries_crossed; caller passes a
// buffer of capacity `cap` range pairs; returns count or -1 if overflow.
// ---------------------------------------------------------------------------

int64_t chunk_split_ranges(const int64_t* ranges, int64_t n, int64_t modulo,
                           int64_t divisor, int64_t* out, int64_t cap) {
    int64_t n_out = 0;
    for (int64_t i = 0; i < n; ++i) {
        int64_t s = ranges[2 * i], e = ranges[2 * i + 1];
        while (s < e) {
            // end of the current chunk-aligned region containing s:
            // next position where (p % modulo) % divisor == 0 or p % modulo == 0
            int64_t rem = s % modulo;
            int64_t chunk_off = rem % divisor;
            int64_t next_boundary = s + (divisor - chunk_off);
            // boundary can't pass the modulo wrap
            int64_t mod_boundary = s + (modulo - rem);
            if (mod_boundary < next_boundary) next_boundary = mod_boundary;
            int64_t piece_end = std::min(e, next_boundary);
            if (n_out >= cap) return -1;
            out[2 * n_out] = s;
            out[2 * n_out + 1] = piece_end;
            ++n_out;
            s = piece_end;
        }
    }
    return n_out;
}

}  // extern "C" (template helper below needs C++ linkage)

// ---------------------------------------------------------------------------
// Single-pass extraction of maximal horizontal runs of constant nonzero
// value from a dense (h, w) label map (the hot edge of pan_seg -> RLE;
// replaces the numpy not_equal/flatnonzero formulation in
// core/labeling.py:extract_runs).  Output arrays hold `cap` entries;
// returns the run count, -2 when cap is exceeded (caller retries with a
// bigger buffer), and — for the i32 entry point only — -1 when a negative
// value is seen (either a genuinely negative int32 map or a uint32 map
// reinterpreted as int32 with values >= 2^31; the caller retries via
// int64, preserving numpy-path semantics either way).
// ---------------------------------------------------------------------------

template <typename T, bool kFlagNegative>
static int64_t extract_runs_impl(const T* seg, int64_t h, int64_t w,
                                 int64_t cap, int64_t* values, int64_t* rows,
                                 int64_t* col_starts, int64_t* col_ends) {
    int64_t n = 0;
    for (int64_t r = 0; r < h; ++r) {
        const T* row = seg + r * w;
        int64_t c = 0;
        while (c < w) {
            const T v = row[c];
            if (v == 0) { ++c; continue; }
            if (kFlagNegative && v < 0) return -1;
            int64_t start = c;
            do { ++c; } while (c < w && row[c] == v);
            if (n >= cap) return -2;
            values[n] = static_cast<int64_t>(v);
            rows[n] = r;
            col_starts[n] = start;
            col_ends[n] = c;
            ++n;
        }
    }
    return n;
}

// ---------------------------------------------------------------------------
// Fused per-slice instance construction (the host 3D pipeline's hot build
// stage, stitch/rle_seg.py runs_to_rle_seg): class-window filter ->
// optional run-based connected components -> group runs by instance ->
// canonicalize (merge row-wrap-touching runs) -> FlatInstances arrays.
// One GIL-released call replaces an argsort + 6 reduceats + mask chain of
// numpy ops, so the MatcherWorker's seg-build pool scales across cores
// instead of serializing on the interpreter lock.
//
// Semantics mirror labeling.py runs_to_flat exactly (stable grouping by
// ascending value; boxes from pre-merge run extents; starts are raveled
// row * width + col); CC relabels to min_id + component with components
// numbered by first appearance, matching connected_components_runs.
// ---------------------------------------------------------------------------

static int64_t build_flat_impl(
    const int64_t* values, const int64_t* rows, const int64_t* cs,
    const int64_t* ce, int64_t n, int64_t width,
    int64_t min_id, int64_t max_id, int force_connected, int connectivity,
    int64_t* out_labels, int64_t* out_boxes, int64_t* out_offsets,
    int64_t* out_starts, int64_t* out_runs, int64_t* out_n_inst) {
    // 1) filter to the class window
    std::vector<int64_t> idx;
    idx.reserve(n);
    for (int64_t i = 0; i < n; ++i)
        if (values[i] >= min_id && values[i] < max_id) idx.push_back(i);
    const int64_t m = static_cast<int64_t>(idx.size());
    *out_n_inst = 0;
    out_offsets[0] = 0;
    if (m == 0) return 0;

    // 2) effective per-run value: CC component (+ min_id) or the raw value
    std::vector<int64_t> val(m), row(m), c0(m), c1(m);
    for (int64_t k = 0; k < m; ++k) {
        int64_t i = idx[k];
        val[k] = values[i];
        row[k] = rows[i];
        c0[k] = cs[i];
        c1[k] = ce[i];
    }
    if (force_connected && m > 0) {
        std::vector<int64_t> comp(m);
        cc_runs(val.data(), row.data(), c0.data(), c1.data(), m,
                connectivity, comp.data());
        for (int64_t k = 0; k < m; ++k) val[k] = comp[k] + min_id;
    }

    // 3) stable order by ascending value (runs stay row-major per value)
    std::vector<int64_t> order(m);
    for (int64_t k = 0; k < m; ++k) order[k] = k;
    std::stable_sort(order.begin(), order.end(),
                     [&](int64_t a, int64_t b) { return val[a] < val[b]; });

    // 4) walk groups: box from original extents; canonicalized RLE
    int64_t n_inst = 0;
    int64_t n_out = 0;
    int64_t g = 0;
    while (g < m) {
        const int64_t v = val[order[g]];
        int64_t y1 = INT64_MAX, y2 = INT64_MIN, x1 = INT64_MAX, x2 = INT64_MIN;
        int64_t group_first_out = n_out;
        while (g < m && val[order[g]] == v) {
            const int64_t k = order[g];
            if (row[k] < y1) y1 = row[k];
            if (row[k] > y2) y2 = row[k];
            if (c0[k] < x1) x1 = c0[k];
            if (c1[k] > x2) x2 = c1[k];
            const int64_t start = row[k] * width + c0[k];
            const int64_t len = c1[k] - c0[k];
            if (n_out > group_first_out &&
                out_starts[n_out - 1] + out_runs[n_out - 1] == start) {
                out_runs[n_out - 1] += len;  // touches across the row wrap
            } else {
                out_starts[n_out] = start;
                out_runs[n_out] = len;
                ++n_out;
            }
            ++g;
        }
        out_labels[n_inst] = v;
        out_boxes[4 * n_inst] = y1;
        out_boxes[4 * n_inst + 1] = x1;
        out_boxes[4 * n_inst + 2] = y2 + 1;
        out_boxes[4 * n_inst + 3] = x2;
        out_offsets[n_inst + 1] = n_out;
        ++n_inst;
    }
    *out_n_inst = n_inst;
    return n_out;
}

extern "C" {

int64_t extract_runs_i32(const int32_t* seg, int64_t h, int64_t w, int64_t cap,
                         int64_t* values, int64_t* rows,
                         int64_t* col_starts, int64_t* col_ends) {
    return extract_runs_impl<int32_t, true>(seg, h, w, cap, values, rows,
                                            col_starts, col_ends);
}

int64_t extract_runs_i64(const int64_t* seg, int64_t h, int64_t w, int64_t cap,
                         int64_t* values, int64_t* rows,
                         int64_t* col_starts, int64_t* col_ends) {
    return extract_runs_impl<int64_t, false>(seg, h, w, cap, values, rows,
                                             col_starts, col_ends);
}

int64_t runs_build_flat(
    const int64_t* values, const int64_t* rows, const int64_t* cs,
    const int64_t* ce, int64_t n, int64_t width,
    int64_t min_id, int64_t max_id, int force_connected, int connectivity,
    int64_t* out_labels, int64_t* out_boxes, int64_t* out_offsets,
    int64_t* out_starts, int64_t* out_runs, int64_t* out_n_inst) {
    return build_flat_impl(values, rows, cs, ce, n, width, min_id, max_id,
                           force_connected, connectivity, out_labels,
                           out_boxes, out_offsets, out_starts, out_runs,
                           out_n_inst);
}

// ---------------------------------------------------------------------------
// Cross-slice matcher core (stitch/matcher.py::match_flat hot path).
//
// One call replaces the per-slice-pair Python/numpy chain (box screen ->
// pairwise RLE intersections -> IoU/IoA edges -> union-find components ->
// single-candidate assignment -> per-column IoA max) whose ~0.7 ms/pair
// interpreter overhead dominates small-slice (ortho) sweeps on a 1-core
// host.  Components where BOTH sides have > 1 member are spilled back as
// (comp, row, col, iou) edges for the exact scipy Hungarian solve — the
// rare case; everything else is decided here with semantics identical to
// the numpy path (last-max-edge tie-break == lexsort-last, smallest-row
// IoA argmax ties, float64 arithmetic in the same order).
//
// Box screen is the quadratic row-major test (same edge ORDER as
// np.nonzero on the dense overlap mask); callers gate on n1*n2 so this
// stays cheap.  Boxes are [lo_y, lo_x, hi_y, hi_x) half-open like the
// numpy path's hi > lo test.  Returns the spill edge count, or -1 if
// spill_cap would be exceeded (caller retries with a bigger buffer).
// ---------------------------------------------------------------------------

static inline int64_t rle_inter_sr(const int64_t* sa, const int64_t* ra,
                                   int64_t na, const int64_t* sb,
                                   const int64_t* rb, int64_t nb) {
    int64_t i = 0, j = 0, total = 0;
    while (i < na && j < nb) {
        const int64_t a0 = sa[i], a1 = sa[i] + ra[i];
        const int64_t b0 = sb[j], b1 = sb[j] + rb[j];
        const int64_t lo = a0 > b0 ? a0 : b0;
        const int64_t hi = a1 < b1 ? a1 : b1;
        if (hi > lo) total += hi - lo;
        if (a1 <= b1) ++i; else ++j;
    }
    return total;
}

int64_t match_flat_core(
    const int64_t* boxes1, const int64_t* offs1, const int64_t* starts1,
    const int64_t* runs1, const int64_t* areas1, int64_t n1,
    const int64_t* boxes2, const int64_t* offs2, const int64_t* starts2,
    const int64_t* runs2, const int64_t* areas2, int64_t n2,
    double iou_thr,
    int64_t* matched_row,                    // (n2) -1 = no single-comp match
    double* col_max, int64_t* col_arg,       // (n2) IoA column stats
    int64_t* spill, double* spill_vals, int64_t spill_cap) {
    for (int64_t c = 0; c < n2; ++c) {
        matched_row[c] = -1;
        col_max[c] = 0.0;
        col_arg[c] = 0;
    }
    std::vector<char> col_has(n2, 0);

    // box-screened edges in row-major order; kept (iou > 0) edges feed the
    // assignment, ALL screened edges feed the IoA column stats (numpy
    // passes the unfiltered edge list to _col_max_arg)
    std::vector<int64_t> er, ec;
    std::vector<double> ev;
    for (int64_t r = 0; r < n1; ++r) {
        const int64_t* b1 = boxes1 + 4 * r;
        for (int64_t c = 0; c < n2; ++c) {
            const int64_t* b2 = boxes2 + 4 * c;
            const int64_t lo0 = b1[0] > b2[0] ? b1[0] : b2[0];
            const int64_t hi0 = b1[2] < b2[2] ? b1[2] : b2[2];
            if (hi0 <= lo0) continue;
            const int64_t lo1 = b1[1] > b2[1] ? b1[1] : b2[1];
            const int64_t hi1 = b1[3] < b2[3] ? b1[3] : b2[3];
            if (hi1 <= lo1) continue;
            const int64_t inter = rle_inter_sr(
                starts1 + offs1[r], runs1 + offs1[r], offs1[r + 1] - offs1[r],
                starts2 + offs2[c], runs2 + offs2[c], offs2[c + 1] - offs2[c]);
            const int64_t uni = areas1[r] + areas2[c] - inter;
            const double iou =
                uni > 0 ? (double)inter / (double)(uni < 1 ? 1 : uni) : 0.0;
            const double ioa = areas2[c] > 0
                ? (double)inter / (double)(areas2[c] < 1 ? 1 : areas2[c])
                : 0.0;
            // per-column IoA max; ties keep the SMALLEST row (dense argmax)
            if (!col_has[c] || ioa > col_max[c] ||
                (ioa == col_max[c] && r < col_arg[c])) {
                col_has[c] = 1;
                col_max[c] = ioa;
                col_arg[c] = r;
            }
            if (iou > 0) {
                er.push_back(r);
                ec.push_back(c);
                ev.push_back(iou);
            }
        }
    }
    const int64_t ne = (int64_t)er.size();
    if (ne == 0) return 0;

    // union-find over n1 + n2 nodes, union toward the smaller index so the
    // root is each component's minimum node (numpy _uf_components)
    std::vector<int64_t> parent(n1 + n2);
    for (int64_t i = 0; i < n1 + n2; ++i) parent[i] = i;
    auto find = [&parent](int64_t x) {
        int64_t root = x;
        while (parent[root] != root) root = parent[root];
        while (parent[x] != root) {
            int64_t nxt = parent[x];
            parent[x] = root;
            x = nxt;
        }
        return root;
    };
    for (int64_t k = 0; k < ne; ++k) {
        int64_t ra = find(er[k]), rb = find(ec[k] + n1);
        if (ra != rb) {
            if (ra < rb) parent[rb] = ra; else parent[ra] = rb;
        }
    }
    // component ids in ascending-root order == np.unique(roots) ranks
    // (the root is the component's min node, seen first in node order)
    std::vector<int64_t> comp_of(n1 + n2, -1);
    std::vector<int64_t> rows_per, cols_per;
    int64_t n_comp = 0;
    for (int64_t i = 0; i < n1 + n2; ++i) {
        int64_t root = find(i);
        if (comp_of[root] == -1) {
            comp_of[root] = n_comp++;
            rows_per.push_back(0);
            cols_per.push_back(0);
        }
        comp_of[i] = comp_of[root];
        if (i < n1) rows_per[comp_of[i]] += 1;
        else cols_per[comp_of[i]] += 1;
    }

    // best edge per component: max value, ties -> LAST edge in order
    // (numpy lexsort((evals, comp)) takes the final entry per group)
    std::vector<int64_t> best(n_comp, -1);
    for (int64_t k = 0; k < ne; ++k) {
        const int64_t c = comp_of[er[k]];
        if (best[c] < 0 || ev[k] >= ev[best[c]]) best[c] = k;
    }

    int64_t n_spill = 0;
    for (int64_t k = 0; k < ne; ++k) {
        const int64_t c = comp_of[er[k]];
        const int64_t rp = rows_per[c], cp = cols_per[c];
        if (rp > 1 && cp > 1) {
            if (n_spill >= spill_cap) return -1;
            spill[3 * n_spill] = c;
            spill[3 * n_spill + 1] = er[k];
            spill[3 * n_spill + 2] = ec[k];
            spill_vals[n_spill] = ev[k];
            ++n_spill;
        }
    }
    for (int64_t c = 0; c < n_comp; ++c) {
        if (best[c] < 0) continue;
        const int64_t rp = rows_per[c], cp = cols_per[c];
        if ((rp <= 1 || cp <= 1) && ev[best[c]] >= iou_thr)
            matched_row[ec[best[c]]] = er[best[c]];
    }
    return n_spill;
}

// ---------------------------------------------------------------------------
// Small exact rectangular assignment (maximize), shortest-augmenting-path /
// Jonker-Volgenant — the same algorithm family as scipy's
// linear_sum_assignment.  Solves the matcher core's spilled components
// (typically 2-6 nodes per side) without the per-component numpy/scipy
// call overhead.  cost is row-major (nr, nc) with nr <= nc (caller
// transposes); outputs col4row[r] = assigned column per row.
// ---------------------------------------------------------------------------

static void lsa_max_small(const double* value, int64_t nr, int64_t nc,
                          int64_t* col4row) {
    // minimize cost = -value (shortest augmenting path with potentials)
    std::vector<double> u(nr, 0.0), v(nc, 0.0);
    std::vector<int64_t> row4col(nc, -1);
    for (int64_t r = 0; r < nr; ++r) col4row[r] = -1;
    const double INF = std::numeric_limits<double>::infinity();
    std::vector<double> shortest(nc);
    std::vector<char> visited(nc);
    std::vector<int64_t> pred(nc);
    for (int64_t cur_row = 0; cur_row < nr; ++cur_row) {
        std::fill(shortest.begin(), shortest.end(), INF);
        std::fill(visited.begin(), visited.end(), 0);
        int64_t sink = -1, i = cur_row;
        double min_val = 0.0;
        while (sink == -1) {
            double lowest = INF;
            int64_t lowest_c = -1;
            for (int64_t c = 0; c < nc; ++c) {
                if (visited[c]) continue;
                const double cost = -value[i * nc + c];
                const double path = min_val + cost - u[i] - v[c];
                if (path < shortest[c]) {
                    shortest[c] = path;
                    pred[c] = i;
                }
                // strictly-lower keeps the FIRST minimal column on ties,
                // matching scipy's scan order
                if (shortest[c] < lowest) {
                    lowest = shortest[c];
                    lowest_c = c;
                }
            }
            min_val = lowest;
            int64_t j = lowest_c;
            visited[j] = 1;
            if (row4col[j] == -1) sink = j;
            else i = row4col[j];
        }
        u[cur_row] += min_val;
        for (int64_t r = 0; r < nr; ++r) {
            if (r == cur_row) continue;
            if (col4row[r] >= 0 && visited[col4row[r]])
                u[r] += min_val - shortest[col4row[r]];
        }
        for (int64_t c = 0; c < nc; ++c)
            if (visited[c]) v[c] -= min_val - shortest[c];
        int64_t j = sink;
        while (true) {
            const int64_t r = pred[j];
            row4col[j] = r;
            const int64_t tmp = col4row[r];
            col4row[r] = j;
            if (r == cur_row) break;
            j = tmp;
        }
    }
}

// Solve all spilled components in one call.  spill is (n_spill, 3) int64
// [comp, row, col] SORTED BY COMP (match_flat_core emits edges in comp-
// interleaved order; the caller sorts — or this sorts internally).  Keeps
// assignments with value >= iou_thr.  Outputs matched (row, col) pairs;
// returns the pair count (bounded by n_spill).
// ---------------------------------------------------------------------------

int64_t solve_spill(const int64_t* spill, const double* spill_vals,
                    int64_t n_spill, double iou_thr,
                    int64_t* out_rows, int64_t* out_cols) {
    int64_t n_out = 0;
    int64_t k = 0;
    std::vector<int64_t> rs, cs;
    std::vector<double> vals;
    std::vector<int64_t> col4row;
    std::vector<double> dense;
    while (k < n_spill) {
        const int64_t comp = spill[3 * k];
        int64_t k1 = k;
        while (k1 < n_spill && spill[3 * k1] == comp) ++k1;
        // unique sorted member ids (edge endpoints cover every member)
        rs.clear(); cs.clear();
        for (int64_t e = k; e < k1; ++e) {
            rs.push_back(spill[3 * e + 1]);
            cs.push_back(spill[3 * e + 2]);
        }
        std::sort(rs.begin(), rs.end());
        rs.erase(std::unique(rs.begin(), rs.end()), rs.end());
        std::sort(cs.begin(), cs.end());
        cs.erase(std::unique(cs.begin(), cs.end()), cs.end());
        const int64_t nr = (int64_t)rs.size(), nc = (int64_t)cs.size();
        dense.assign(nr * nc, 0.0);
        for (int64_t e = k; e < k1; ++e) {
            const int64_t ri = std::lower_bound(rs.begin(), rs.end(),
                                                spill[3 * e + 1]) - rs.begin();
            const int64_t ci = std::lower_bound(cs.begin(), cs.end(),
                                                spill[3 * e + 2]) - cs.begin();
            dense[ri * nc + ci] = spill_vals[e];
        }
        if (nr <= nc) {
            col4row.assign(nr, -1);
            lsa_max_small(dense.data(), nr, nc, col4row.data());
            for (int64_t r = 0; r < nr; ++r) {
                const int64_t c = col4row[r];
                if (c >= 0 && dense[r * nc + c] >= iou_thr) {
                    out_rows[n_out] = rs[r];
                    out_cols[n_out] = cs[c];
                    ++n_out;
                }
            }
        } else {
            // transpose so rows <= cols for the solver
            std::vector<double> t(nc * nr);
            for (int64_t r = 0; r < nr; ++r)
                for (int64_t c = 0; c < nc; ++c)
                    t[c * nr + r] = dense[r * nc + c];
            col4row.assign(nc, -1);
            lsa_max_small(t.data(), nc, nr, col4row.data());
            for (int64_t c = 0; c < nc; ++c) {
                const int64_t r = col4row[c];
                if (r >= 0 && t[c * nr + r] >= iou_thr) {
                    out_rows[n_out] = rs[r];
                    out_cols[n_out] = cs[c];
                    ++n_out;
                }
            }
        }
        k = k1;
    }
    return n_out;
}

// ---------------------------------------------------------------------------
// Whole-sweep matcher: per-slice seg build + forward matching + backward
// matching for ONE class over a packed sweep buffer, no Python between
// slices.  Semantics replicate stitch/matcher.py::RLEMatcher.match_flat +
// stitch/patterns.py::forward_matching/backward_matching byte-for-byte
// (same edge order, tie-breaks, float division order, first-appearance
// collision-group order); gated by a byte-identical fuzz test.
// ---------------------------------------------------------------------------

int64_t packed_build_flat(
    const int16_t* packed, int64_t h, int64_t rcap, int64_t width,
    int64_t min_id, int64_t max_id, int force_connected, int connectivity,
    int64_t* out_labels, int64_t* out_boxes, int64_t* out_offsets,
    int64_t* out_starts, int64_t* out_runs, int64_t* out_n_inst);

namespace {

struct FlatV {
    std::vector<int64_t> labels, boxes, offs, starts, runs, areas;
    int64_t size() const { return (int64_t)labels.size(); }
    void compute_areas() {
        areas.assign(labels.size(), 0);
        for (size_t k = 0; k < labels.size(); ++k)
            for (int64_t i = offs[k]; i < offs[k + 1]; ++i)
                areas[k] += runs[i];
    }
};

// one matcher step: match mf against tf, producing out (the new target).
// Mirrors RLEMatcher.match_flat exactly.
void match_pair(const FlatV& tf, const FlatV& mf, double iou_thr,
                double ioa_thr, bool assign_new, int64_t& next_label,
                FlatV& out) {
    const int64_t n1 = tf.size(), n2 = mf.size();
    std::vector<int64_t> matched_row(n2, -1);
    std::vector<double> col_max(n2, 0.0);
    std::vector<int64_t> col_arg(n2, 0);

    if (n1 > 0 && n2 > 0) {
        std::vector<char> col_has(n2, 0);
        std::vector<int64_t> er, ec;
        std::vector<double> ev;
        for (int64_t r = 0; r < n1; ++r) {
            const int64_t* b1 = tf.boxes.data() + 4 * r;
            for (int64_t c = 0; c < n2; ++c) {
                const int64_t* b2 = mf.boxes.data() + 4 * c;
                const int64_t lo0 = b1[0] > b2[0] ? b1[0] : b2[0];
                const int64_t hi0 = b1[2] < b2[2] ? b1[2] : b2[2];
                if (hi0 <= lo0) continue;
                const int64_t lo1 = b1[1] > b2[1] ? b1[1] : b2[1];
                const int64_t hi1 = b1[3] < b2[3] ? b1[3] : b2[3];
                if (hi1 <= lo1) continue;
                const int64_t inter = rle_inter_sr(
                    tf.starts.data() + tf.offs[r], tf.runs.data() + tf.offs[r],
                    tf.offs[r + 1] - tf.offs[r],
                    mf.starts.data() + mf.offs[c], mf.runs.data() + mf.offs[c],
                    mf.offs[c + 1] - mf.offs[c]);
                const int64_t uni = tf.areas[r] + mf.areas[c] - inter;
                const double iou = uni > 0
                    ? (double)inter / (double)(uni < 1 ? 1 : uni) : 0.0;
                const double ioa = mf.areas[c] > 0
                    ? (double)inter / (double)(mf.areas[c] < 1 ? 1 : mf.areas[c])
                    : 0.0;
                if (!col_has[c] || ioa > col_max[c] ||
                    (ioa == col_max[c] && r < col_arg[c])) {
                    col_has[c] = 1;
                    col_max[c] = ioa;
                    col_arg[c] = r;
                }
                if (iou > 0) {
                    er.push_back(r); ec.push_back(c); ev.push_back(iou);
                }
            }
        }
        const int64_t ne = (int64_t)er.size();
        if (ne > 0) {
            std::vector<int64_t> parent(n1 + n2);
            for (int64_t i = 0; i < n1 + n2; ++i) parent[i] = i;
            for (int64_t k = 0; k < ne; ++k)
                uf_union(parent, er[k], ec[k] + n1);
            std::vector<int64_t> comp_of(n1 + n2, -1);
            std::vector<int64_t> rows_per, cols_per;
            int64_t n_comp = 0;
            for (int64_t i = 0; i < n1 + n2; ++i) {
                int64_t root = uf_find(parent, i);
                if (comp_of[root] == -1) {
                    comp_of[root] = n_comp++;
                    rows_per.push_back(0);
                    cols_per.push_back(0);
                }
                comp_of[i] = comp_of[root];
                if (i < n1) rows_per[comp_of[i]] += 1;
                else cols_per[comp_of[i]] += 1;
            }
            std::vector<int64_t> best(n_comp, -1);
            for (int64_t k = 0; k < ne; ++k) {
                const int64_t c = comp_of[er[k]];
                if (best[c] < 0 || ev[k] >= ev[best[c]]) best[c] = k;
            }
            std::vector<int64_t> spill;
            std::vector<double> spill_vals;
            for (int64_t k = 0; k < ne; ++k) {
                const int64_t c = comp_of[er[k]];
                if (rows_per[c] > 1 && cols_per[c] > 1) {
                    spill.push_back(c);
                    spill.push_back(er[k]);
                    spill.push_back(ec[k]);
                    spill_vals.push_back(ev[k]);
                }
            }
            for (int64_t c = 0; c < n_comp; ++c) {
                if (best[c] < 0) continue;
                if ((rows_per[c] <= 1 || cols_per[c] <= 1) &&
                    ev[best[c]] >= iou_thr)
                    matched_row[ec[best[c]]] = er[best[c]];
            }
            if (!spill.empty()) {
                // comp ids already grouped? edges are comp-interleaved;
                // stable sort by comp like the python wrapper
                const int64_t ns = (int64_t)spill_vals.size();
                std::vector<int64_t> ord(ns);
                for (int64_t i = 0; i < ns; ++i) ord[i] = i;
                std::stable_sort(ord.begin(), ord.end(),
                                 [&](int64_t a, int64_t b) {
                                     return spill[3 * a] < spill[3 * b];
                                 });
                std::vector<int64_t> sp(3 * ns);
                std::vector<double> sv(ns);
                for (int64_t i = 0; i < ns; ++i) {
                    sp[3 * i] = spill[3 * ord[i]];
                    sp[3 * i + 1] = spill[3 * ord[i] + 1];
                    sp[3 * i + 2] = spill[3 * ord[i] + 2];
                    sv[i] = spill_vals[ord[i]];
                }
                std::vector<int64_t> orow(ns), ocol(ns);
                const int64_t nm = solve_spill(sp.data(), sv.data(), ns,
                                               iou_thr, orow.data(),
                                               ocol.data());
                for (int64_t i = 0; i < nm; ++i)
                    matched_row[ocol[i]] = orow[i];
            }
        }
    }

    // label assignment (match_flat: matched -> target label; unmatched
    // absorb on IoA; fresh -> next_label counter or kept labels)
    std::vector<int64_t> new_labels(n2);
    for (int64_t c = 0; c < n2; ++c) {
        if (matched_row[c] >= 0) new_labels[c] = tf.labels[matched_row[c]];
        else if (col_max[c] >= ioa_thr) new_labels[c] = tf.labels[col_arg[c]];
        else if (assign_new) new_labels[c] = next_label++;
        else new_labels[c] = mf.labels[c];
    }

    // collision merge (matcher._merge_collisions): groups in first-
    // appearance order, members in original order, runs unioned, boxes
    // reduced; no collisions -> arrays pass through with new labels
    std::vector<int64_t> first_of;        // group -> first member
    std::vector<int64_t> group_of(n2);
    {
        // first-seen group ids
        std::vector<std::pair<int64_t, int64_t>> seen;  // (label, group)
        for (int64_t c = 0; c < n2; ++c) {
            int64_t g = -1;
            for (const auto& p : seen)
                if (p.first == new_labels[c]) { g = p.second; break; }
            if (g == -1) {
                g = (int64_t)first_of.size();
                seen.emplace_back(new_labels[c], g);
                first_of.push_back(c);
            }
            group_of[c] = g;
        }
    }
    const int64_t n_groups = (int64_t)first_of.size();
    out.labels.clear(); out.boxes.clear(); out.offs.clear();
    out.starts.clear(); out.runs.clear();
    out.offs.push_back(0);
    if (n_groups == n2) {
        out.labels = new_labels;
        out.boxes = mf.boxes;
        out.offs = mf.offs;
        out.starts = mf.starts;
        out.runs = mf.runs;
        out.areas = mf.areas;
        return;
    }
    std::vector<std::pair<int64_t, int64_t>> buf;
    for (int64_t g = 0; g < n_groups; ++g) {
        out.labels.push_back(new_labels[first_of[g]]);
        buf.clear();
        int64_t b0 = 0, b1 = 0, b2 = 0, b3 = 0;
        bool first = true;
        for (int64_t c = 0; c < n2; ++c) {
            if (group_of[c] != g) continue;
            const int64_t* bx = mf.boxes.data() + 4 * c;
            if (first) { b0 = bx[0]; b1 = bx[1]; b2 = bx[2]; b3 = bx[3];
                         first = false; }
            else {
                if (bx[0] < b0) b0 = bx[0];
                if (bx[1] < b1) b1 = bx[1];
                if (bx[2] > b2) b2 = bx[2];
                if (bx[3] > b3) b3 = bx[3];
            }
            for (int64_t i = mf.offs[c]; i < mf.offs[c + 1]; ++i)
                buf.emplace_back(mf.starts[i], mf.starts[i] + mf.runs[i]);
        }
        std::sort(buf.begin(), buf.end());
        bool open = false;
        int64_t cs = 0, ce = -1;
        for (const auto& r : buf) {
            if (!open) { cs = r.first; ce = r.second; open = true; }
            else if (r.first <= ce) { if (r.second > ce) ce = r.second; }
            else {
                out.starts.push_back(cs);
                out.runs.push_back(ce - cs);
                cs = r.first; ce = r.second;
            }
        }
        if (open) { out.starts.push_back(cs); out.runs.push_back(ce - cs); }
        out.offs.push_back((int64_t)out.starts.size());
        out.boxes.push_back(b0); out.boxes.push_back(b1);
        out.boxes.push_back(b2); out.boxes.push_back(b3);
    }
    out.compute_areas();
}

}  // namespace

// Full forward+backward matching over a packed sweep for one class.
// With match == 0 the slices are only built, as the streamed path builds
// a class that has no matcher (not in thing_list): no id crosses slices.
// Returns total output runs of the BACKWARD pass, -1 on packed-capacity
// overflow of any slice, -2 on per-slice CC-label overflow (caller falls
// back to the Python path, which raises the proper error).
// out_slice_off (n_slices+1): per-slice instance-count offsets;
// out_run_off (inst+1): per-instance run offsets (global).
int64_t match_sweep(
    const int16_t* packed, int64_t n_slices, int64_t slice_stride,
    int64_t h, int64_t rcap, int64_t width,
    int64_t min_id, int64_t max_id, int force_connected, int connectivity,
    int match, double iou_thr, double ioa_thr, int64_t next_label_start,
    int64_t* out_slice_off, int64_t* out_labels, int64_t* out_boxes,
    int64_t* out_run_off, int64_t* out_starts, int64_t* out_runs) {
    const int64_t cap = h * rcap;
    std::vector<int64_t> tl(cap), tb(4 * cap), to(cap + 1), ts(cap), tr(cap);
    std::vector<FlatV> fstack(n_slices);
    int64_t next_label = next_label_start;

    for (int64_t s = 0; s < n_slices; ++s) {
        int64_t n_inst = 0;
        const int64_t n_out = packed_build_flat(
            packed + s * slice_stride, h, rcap, width, min_id, max_id,
            force_connected, connectivity, tl.data(), tb.data(), to.data(),
            ts.data(), tr.data(), &n_inst);
        if (n_out < 0) return -1;
        if (force_connected && n_inst >= max_id - min_id) return -2;
        FlatV built;
        built.labels.assign(tl.begin(), tl.begin() + n_inst);
        built.boxes.assign(tb.begin(), tb.begin() + 4 * n_inst);
        built.offs.assign(to.begin(), to.begin() + n_inst + 1);
        built.starts.assign(ts.begin(), ts.begin() + n_out);
        built.runs.assign(tr.begin(), tr.begin() + n_out);
        built.compute_areas();
        if (!match) {
            fstack[s] = std::move(built);
        } else if (s == 0) {
            // initialize_target_flat: first slice passes through
            if (built.size() > 0) {
                int64_t mx = built.labels[0];
                for (int64_t l : built.labels) if (l > mx) mx = l;
                next_label = mx + 1;
            }
            fstack[0] = std::move(built);
        } else {
            match_pair(fstack[s - 1], built, iou_thr, ioa_thr,
                       /*assign_new=*/true, next_label, fstack[s]);
        }
    }

    // backward pass: reversed, assign_new=False, last slice passes through
    std::vector<FlatV> bstack(n_slices);
    for (int64_t s = n_slices - 1; s >= 0; --s) {
        if (!match || s == n_slices - 1) bstack[s] = fstack[s];
        else
            match_pair(bstack[s + 1], fstack[s], iou_thr, ioa_thr,
                       /*assign_new=*/false, next_label, bstack[s]);
    }

    int64_t inst_total = 0, run_total = 0;
    out_slice_off[0] = 0;
    out_run_off[0] = 0;
    for (int64_t s = 0; s < n_slices; ++s) {
        const FlatV& f = bstack[s];
        for (int64_t k = 0; k < f.size(); ++k) {
            out_labels[inst_total] = f.labels[k];
            for (int64_t d = 0; d < 4; ++d)
                out_boxes[4 * inst_total + d] = f.boxes[4 * k + d];
            for (int64_t i = f.offs[k]; i < f.offs[k + 1]; ++i) {
                out_starts[run_total] = f.starts[i];
                out_runs[run_total] = f.runs[i];
                ++run_total;
            }
            ++inst_total;
            out_run_off[inst_total] = run_total;
        }
        out_slice_off[s + 1] = inst_total;
    }
    return run_total;
}

// Packed variant: decodes ops.postprocess.encode_runs_packed rows
// ([starts(R) | values(R) | count] int16 per image row, values stored
// unsigned) straight into build_flat_impl — the drainer hands the raw
// device buffer to the seg-build pool and Python never touches the runs.
// Returns -1 when any row overflowed its R-run capacity (caller falls
// back to the dense map path, same contract as decode_runs_packed).
int64_t packed_build_flat(
    const int16_t* packed, int64_t h, int64_t rcap, int64_t width,
    int64_t min_id, int64_t max_id, int force_connected, int connectivity,
    int64_t* out_labels, int64_t* out_boxes, int64_t* out_offsets,
    int64_t* out_starts, int64_t* out_runs, int64_t* out_n_inst) {
    std::vector<int64_t> val, row, c0, c1;
    val.reserve(h * 8);
    row.reserve(h * 8);
    c0.reserve(h * 8);
    c1.reserve(h * 8);
    const int64_t stride = 2 * rcap + 1;
    for (int64_t y = 0; y < h; ++y) {
        const int16_t* buf = packed + y * stride;
        const int64_t count = buf[2 * rcap];
        if (count > rcap) return -1;
        for (int64_t k = 0; k < count; ++k) {
            const int64_t v =
                static_cast<int64_t>(static_cast<uint16_t>(buf[rcap + k]));
            if (v == 0) continue;  // background run (still delimits ends)
            const int64_t start = buf[k];
            const int64_t end = (k + 1 < count) ? buf[k + 1] : width;
            val.push_back(v);
            row.push_back(y);
            c0.push_back(start);
            c1.push_back(end);
        }
    }
    return build_flat_impl(val.data(), row.data(), c0.data(), c1.data(),
                           static_cast<int64_t>(val.size()), width, min_id,
                           max_id, force_connected, connectivity, out_labels,
                           out_boxes, out_offsets, out_starts, out_runs,
                           out_n_inst);
}

}  // extern "C"
