// Circuit event loop over all cores, compiled for the host.
//
// The loop of the reference's repro/core/engine.py::_event_loop in one
// call, with its semantics bit for bit: the same establishment times, and
// the events and flows its numpy twin in
// tests/test_torch_event_loop_compiled.py counts. Plain C++17 with a C entry
// point, built by kernels/_build.py with -ffp-contract=off and never
// -ffast-math, so each double operation rounds as numpy's does: a
// completion time is (t + delta) + srv, with t copied from the event time
// it was popped as, and every comparison is the exact == or <= of the
// numpy loop.
//
// What differs is only how an event finds its work. The numpy loop scans
// every resource for a free time equal to t. Here each heap entry carries
// what it came from (a started flow, a seeded horizon, a release group),
// and the resources freed at t are those named by the entries popped at t
// whose free time still equals t: a resource's free time is the value of
// its last write, and every write above t0 pushes an entry. The one value
// no entry can name is +inf (a failed core's horizon is never seeded), so
// an event at t = +inf scans as the numpy loop does. A work-conserving
// event merges the flow lists of the resources it freed by index and stops
// reading each list at the row that takes its resource
// (Loop::work_conserving).
//
// Inputs outside the loop's domain (an id out of range, a NaN, t0 < 0,
// where +0 and -0 may tie in the heap) return kInvalid, which the caller
// raises as a ValueError.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <queue>
#include <vector>

namespace {

enum : int { kOk = 0, kDeadlock = 1, kInvalid = 2, kFailed = 3 };
enum : int32_t { kFlow = 0, kSeedIn = 1, kSeedOut = 2, kRelease = 3 };

struct Entry {
  double t;
  int64_t id;    // a flow, a resource or a release group, by kind
  int32_t kind;
};

struct Later {
  bool operator()(const Entry& a, const Entry& b) const { return a.t > b.t; }
};

// Marks that are cleared by moving to a new epoch.
struct Marks {
  std::vector<int64_t> at;
  int64_t epoch = 0;
  explicit Marks(int64_t n) : at(static_cast<size_t>(n), 0) {}
  void next() { ++epoch; }
  // True the first time i is marked in this epoch.
  bool mark(int64_t i) {
    if (at[i] == epoch) return false;
    at[i] = epoch;
    return true;
  }
  bool marked(int64_t i) const { return at[i] == epoch; }
};

struct Loop {
  int64_t F, n_res, n_ports;
  const int64_t *rin, *rout, *core;
  const double *srv, *delta_f, *release;
  double delta;
  double* t_est;

  std::vector<double> free_in, free_out;
  std::vector<uint8_t> done;
  std::priority_queue<Entry, std::vector<Entry>, Later> heap;
  // flows grouped by release value, in priority order within a group:
  // group g is rel_flows[rel_start[g] .. rel_start[g + 1])
  std::vector<int64_t> rel_flows, rel_start;
  // what the last event freed: resources (ingress, egress), release groups
  std::vector<int64_t> freed_in, freed_out, groups;
  Marks freed_mark_in, freed_mark_out;
  Marks first_in, first_out;  // first occurrence on each resource

  double t;
  int64_t remaining, n_events = 1, n_tested = 0;
  int64_t n_visited = 0;  // flow rows read, finished ones included
  int64_t n_unread = 0;   // rows an event left unread behind its cursors
  int64_t n_unreleased = 0;  // pending rows read and passed as not released

  Loop(int64_t F_, int64_t n_res_)
      : F(F_), n_res(n_res_), free_in(n_res_), free_out(n_res_),
        done(static_cast<size_t>(F_), 0), freed_mark_in(n_res_),
        freed_mark_out(n_res_), first_in(n_res_), first_out(n_res_) {}

  void start(int64_t f) {
    const double tc = (t + (delta_f ? delta_f[f] : delta)) + srv[f];
    free_in[rin[f]] = tc;
    free_out[rout[f]] = tc;
    t_est[f] = t;
    done[f] = 1;
    --remaining;
    heap.push({tc, f, kFlow});
  }

  void freed(int64_t r, bool in) {
    if (in) {
      if (free_in[r] == t && freed_mark_in.mark(r)) freed_in.push_back(r);
    } else {
      if (free_out[r] == t && freed_mark_out.mark(r)) freed_out.push_back(r);
    }
  }

  // Moves t to the earliest entry strictly after it and gathers what that
  // time freed; false when no entry is left (the deadlock).
  bool next_event() {
    while (!heap.empty() && heap.top().t <= t) heap.pop();
    if (heap.empty()) return false;
    t = heap.top().t;
    ++n_events;
    freed_in.clear();
    freed_out.clear();
    groups.clear();
    freed_mark_in.next();
    freed_mark_out.next();
    const bool scan = std::isinf(t);
    while (!heap.empty() && heap.top().t == t) {
      const Entry e = heap.top();
      heap.pop();
      if (e.kind == kRelease) {
        groups.push_back(e.id);
      } else if (!scan) {
        if (e.kind == kFlow) {
          freed(rin[e.id], true);
          freed(rout[e.id], false);
        } else {
          freed(e.id, e.kind == kSeedIn);
        }
      }
    }
    if (scan) {
      for (int64_t r = 0; r < n_res; ++r) {
        freed(r, true);
        freed(r, false);
      }
    }
    return true;
  }

  template <typename Fn>
  void for_released_at_t(Fn&& fn) const {
    for (int64_t g : groups)
      for (int64_t k = rel_start[g]; k < rel_start[g + 1]; ++k)
        fn(rel_flows[k]);
  }

  bool free_at_t(int64_t f) const {
    return free_in[rin[f]] <= t && free_out[rout[f]] <= t;
  }

  int work_conserving();
  int priority_guard();
};

// Every pending flow has a busy resource or an unreached release after an
// event's fixed point, so the flows that can start at the next event are on
// the lists of the resources it frees or in the groups it releases. The
// numpy loop's fixed point (start each free candidate that is first on both
// its resources, and repeat) starts what a pass in priority order starts: a
// flow starts if both its resources are still free once every earlier
// candidate on them has started or been dropped. So an event merges its
// lists by index. A cursor a list stops at the list's first row that can
// start (its head), the smallest head starts, and its cursor reads on. A
// row a cursor passes stays blocked for the rest of the event, as resources
// only get busier within it, and a resource's cursor closes once the
// resource is busy, leaving the rest of its list unread. A head is checked
// again when it is the smallest, as another start may have taken its
// resource since it was read.
//
// A row on two of an event's lists is tested on one: its ingress list if
// that resource was freed, else its egress list, else its release group.
// The other list's cursor passes it untested, as the row can start only
// through the list that tests it, which reads on to it unless its resource
// is taken first. So tested counts each row an event checks once, and a
// resource's cursor compares one free time a row.
int Loop::work_conserving() {
  // flows by resource, in priority (index) order; the pending flows of
  // resource r are flows[beg[r] .. end[r]), among finished ones that no
  // cursor has read past since they started
  std::vector<int64_t> in_beg(n_res + 1, 0), out_beg(n_res + 1, 0);
  for (int64_t f = 0; f < F; ++f) {
    ++in_beg[rin[f] + 1];
    ++out_beg[rout[f] + 1];
  }
  for (int64_t r = 0; r < n_res; ++r) {
    in_beg[r + 1] += in_beg[r];
    out_beg[r + 1] += out_beg[r];
  }
  std::vector<int64_t> in_flows(F), out_flows(F);
  std::vector<int64_t> in_end(in_beg.begin(), in_beg.end() - 1);
  std::vector<int64_t> out_end(out_beg.begin(), out_beg.end() - 1);
  for (int64_t f = 0; f < F; ++f) {
    in_flows[in_end[rin[f]]++] = f;
    out_flows[out_end[rout[f]]++] = f;
  }

  // at t0 every flow is read, in priority order
  n_visited += F;
  for (int64_t f = 0; f < F; ++f) {
    if (release && release[f] > t) {
      ++n_unreleased;
      continue;
    }
    ++n_tested;
    if (free_at_t(f)) start(f);
  }

  enum Side : int { kIn, kOut, kGroup };
  struct Cursor {
    Side side;
    int64_t* flows;        // the list's rows
    int64_t* beg;          // its first pending row (null: a release group)
    const double* free;    // its resource's free time (null: a group)
    int64_t from, p, end;  // read [from, p) in this event, [p, end) unread
    int64_t head;          // the last row read, if it could start; else -1
  };
  std::vector<Cursor> cursors;
  // reads on to the cursor's next row that can start at t
  auto advance = [&](Cursor& c) {
    c.head = -1;
    if (c.free && *c.free > t) return;  // every later row is blocked
    const int64_t* flows = c.flows;
    int64_t p = c.p, n = 0, head = -1;
    while (p < c.end) {
      const int64_t f = flows[p++];
      if (done[f]) continue;
      if (release && release[f] > t) {
        ++n_unreleased;
        continue;
      }
      bool free;
      if (c.side == kIn) {
        free = free_out[rout[f]] <= t;
      } else if (c.side == kOut) {
        if (freed_mark_in.marked(rin[f])) continue;
        free = free_in[rin[f]] <= t;
      } else {
        if (freed_mark_in.marked(rin[f]) || freed_mark_out.marked(rout[f]))
          continue;
        free = free_at_t(f);
      }
      ++n;
      if (free) {
        head = f;
        break;
      }
    }
    c.p = p;
    c.head = head;
    n_tested += n;
  };
  auto open = [&](Side side, const std::vector<int64_t>& freed_r,
                  std::vector<int64_t>& flows, std::vector<int64_t>& beg,
                  const std::vector<int64_t>& end,
                  const std::vector<double>& free) {
    for (int64_t r : freed_r)
      if (beg[r] < end[r])
        cursors.push_back({side, flows.data(), &beg[r], &free[r], beg[r],
                           beg[r], end[r], -1});
  };

  for (;;) {
    if (remaining == 0) break;
    if (!next_event()) return kDeadlock;
    cursors.clear();
    open(kIn, freed_in, in_flows, in_beg, in_end, free_in);
    open(kOut, freed_out, out_flows, out_beg, out_end, free_out);
    for (int64_t g : groups)
      cursors.push_back({kGroup, rel_flows.data(), nullptr, nullptr,
                         rel_start[g], rel_start[g], rel_start[g + 1], -1});
    for (Cursor& c : cursors) advance(c);
    for (;;) {
      Cursor* low = nullptr;
      for (Cursor& c : cursors)
        if (c.head >= 0 && (!low || c.head < low->head)) low = &c;
      if (!low) break;
      const int64_t f = low->head;
      if (!done[f] && free_at_t(f)) start(f);
      advance(*low);
    }
    // each list keeps the pending rows of the part read, moved up against
    // its unread rest
    for (Cursor& c : cursors) {
      n_visited += c.p - c.from;
      n_unread += c.end - c.p;
      if (!c.beg) continue;
      int64_t w = c.p;
      for (int64_t k = c.p; k-- > c.from;)
        if (!done[c.flows[k]]) c.flows[--w] = c.flows[k];
      *c.beg = w;
    }
  }
  return kOk;
}

// One pass an event over the released pending rows of the cores active at
// t: a row starts if its resources are free and it is the first of those
// rows on both, so a pending row holds its resources whether or not it
// starts.
int Loop::priority_guard() {
  const int64_t n_cores = n_res / n_ports;
  std::vector<std::vector<int64_t>> pending(n_cores);
  for (int64_t f = 0; f < F; ++f) pending[core[f]].push_back(f);
  Marks act(n_cores);
  std::vector<int64_t> active, pend;
  pend.reserve(F);
  bool first_event = true;
  for (;;) {
    pend.clear();
    active.clear();
    if (first_event) {
      first_event = false;
      for (int64_t c = 0; c < n_cores; ++c) active.push_back(c);
      for (int64_t f = 0; f < F; ++f) pend.push_back(f);
    } else {
      act.next();
      for (int64_t r : freed_in)
        if (act.mark(r / n_ports)) active.push_back(r / n_ports);
      for (int64_t r : freed_out)
        if (act.mark(r / n_ports)) active.push_back(r / n_ports);
      for_released_at_t([&](int64_t f) {
        if (!done[f] && act.mark(core[f])) active.push_back(core[f]);
      });
      for (int64_t c : active)
        pend.insert(pend.end(), pending[c].begin(), pending[c].end());
      if (active.size() > 1) std::sort(pend.begin(), pend.end());
    }
    n_visited += static_cast<int64_t>(pend.size());
    if (release) {
      size_t n = 0;
      for (int64_t f : pend)
        if (release[f] <= t) pend[n++] = f;
      n_unreleased += static_cast<int64_t>(pend.size() - n);
      pend.resize(n);
    }
    n_tested += static_cast<int64_t>(pend.size());
    if (!pend.empty()) {
      first_in.next();
      first_out.next();
      bool started = false;
      for (int64_t f : pend) {
        const bool a = first_in.mark(rin[f]);
        const bool b = first_out.mark(rout[f]);
        if (a && b && free_at_t(f)) {
          start(f);
          started = true;
        }
      }
      if (started) {
        for (int64_t c : active) {
          auto& p = pending[c];
          p.erase(std::remove_if(p.begin(), p.end(),
                                 [&](int64_t f) { return done[f] != 0; }),
                  p.end());
        }
        if (remaining == 0) break;
      }
    }
    if (!next_event()) return kDeadlock;
  }
  return kOk;
}

bool in_range(const int64_t* v, int64_t n, int64_t hi) {
  for (int64_t k = 0; k < n; ++k)
    if (v[k] < 0 || v[k] >= hi) return false;
  return true;
}

bool any_nan(const double* v, int64_t n) {
  for (int64_t k = 0; k < n; ++k)
    if (std::isnan(v[k])) return true;
  return false;
}

}  // namespace

// Establishment times t_est (F,) and counts {events, tested, flows,
// visited, unread, unreleased} of the merged event loop over flows in
// priority order; tested is the rows whose two resources an event checked,
// visited the flow rows the loop read, finished ones included, unread the
// rows an event left unread behind its cursors (0 under the guard), and
// unreleased the pending rows it read and passed because their release
// was still ahead (0 without release; of the last three, the numpy twin
// counts only this one, under the guard). rin/rout are resource ids
// (core * n_ports + port); core is read only when guard is set.
// delta_f (per flow) replaces delta when not null; release (per flow) and
// the seeded horizons free_in0/free_out0 (per resource, both or neither)
// may be null. Returns kOk, kDeadlock (pending flows but no event left),
// kInvalid (an input outside the domain above) or kFailed (no memory).
extern "C" int event_loop_host(
    int64_t n_flows, const int64_t* rin, const int64_t* rout,
    const double* srv, const int64_t* core, double delta,
    const double* delta_f, int64_t n_res, int64_t n_ports, double t0,
    int guard, const double* release, const double* free_in0,
    const double* free_out0, double* t_est, int64_t* counts) {
  std::fill(counts, counts + 6, 0);
  if (n_flows == 0) return kOk;
  if (n_flows < 0 || n_res <= 0 || std::isnan(t0) || t0 < 0.0 ||
      (free_in0 == nullptr) != (free_out0 == nullptr))
    return kInvalid;
  if (!in_range(rin, n_flows, n_res) || !in_range(rout, n_flows, n_res) ||
      any_nan(srv, n_flows) ||
      (delta_f ? any_nan(delta_f, n_flows) : std::isnan(delta)) ||
      (release && any_nan(release, n_flows)) ||
      (free_in0 && (any_nan(free_in0, n_res) || any_nan(free_out0, n_res))))
    return kInvalid;
  if (guard && (n_ports <= 0 || n_res % n_ports != 0 ||
                !in_range(core, n_flows, n_res / n_ports)))
    return kInvalid;
  try {
    Loop L(n_flows, n_res);
    L.rin = rin;
    L.rout = rout;
    L.core = core;
    L.srv = srv;
    L.delta = delta;
    L.delta_f = delta_f;
    L.release = release;
    L.n_ports = n_ports;
    L.t_est = t_est;
    L.t = t0;
    L.remaining = n_flows;
    for (int64_t f = 0; f < n_flows; ++f) t_est[f] = -1.0;
    if (free_in0) {
      std::copy(free_in0, free_in0 + n_res, L.free_in.begin());
      std::copy(free_out0, free_out0 + n_res, L.free_out.begin());
      for (int64_t r = 0; r < n_res; ++r) {
        if (L.free_in[r] > t0 && std::isfinite(L.free_in[r]))
          L.heap.push({L.free_in[r], r, kSeedIn});
        if (L.free_out[r] > t0 && std::isfinite(L.free_out[r]))
          L.heap.push({L.free_out[r], r, kSeedOut});
      }
    } else {
      std::fill(L.free_in.begin(), L.free_in.end(), t0);
      std::fill(L.free_out.begin(), L.free_out.end(), t0);
    }
    if (release) {
      std::vector<int64_t>& order = L.rel_flows;
      order.resize(n_flows);
      for (int64_t f = 0; f < n_flows; ++f) order[f] = f;
      std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
        return release[a] < release[b];
      });
      for (int64_t k = 0; k < n_flows; ++k) {
        if (k == 0 || release[order[k]] != release[order[k - 1]]) {
          L.heap.push({release[order[k]],
                       static_cast<int64_t>(L.rel_start.size()), kRelease});
          L.rel_start.push_back(k);
        }
      }
      L.rel_start.push_back(n_flows);
    }
    const int rc = guard ? L.priority_guard() : L.work_conserving();
    if (rc != kOk) return rc;
    counts[0] = L.n_events;
    counts[1] = L.n_tested;
    counts[2] = n_flows;
    counts[3] = L.n_visited;
    counts[4] = L.n_unread;
    counts[5] = L.n_unreleased;
    return kOk;
  } catch (...) {
    return kFailed;
  }
}
