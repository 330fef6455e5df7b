// Native max-flow scheduler core for mode 3 (the scheduling hot path).
//
// The reference computes its dissemination plan with Edmonds-Karp over an
// adjacency matrix inside an exponential+binary search on the completion
// time (distributor/flow.go:146-353).  At pod scale
// (32+ nodes x 80+ layers) that search dominates leader latency, so this
// library runs the whole loop natively: Dinic's algorithm (O(V^2 E), far
// better than Edmonds-Karp's O(V E^2) on these dense layered graphs) over
// an edge list whose capacities are affine in the candidate time t:
//
//     cap_i(t) = clamp(cap_const_i + cap_per_t_i * t / t_scale, 0, INF)
//
// which covers every edge class in the flow model: NIC edges (0 + bw*t),
// source-class edges (0 + rate*t), class->layer edges (INF + 0*t), and
// layer->receiver edges (size + 0*t).  t_scale decouples the time
// granularity from the rate units: rates stay bytes/second while t counts
// milliseconds (t_scale=1000) — the reference's integer-second search
// (flow.go:155-187) pads every sub-second plan to 1 s.  Floor division
// keeps caps integral and monotone in t, so the search is unchanged.
//
// Exposed as a plain C ABI for ctypes; no Python.h dependency.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int64_t kInf = int64_t{1} << 62;

// Saturating a + b*t/scale in 128-bit, clamped to [0, kInf].
inline int64_t affine_cap(int64_t c, int64_t per_t, int64_t t,
                          int64_t t_scale) {
  __int128 v =
      (__int128)c + (__int128)per_t * (__int128)t / (t_scale > 0 ? t_scale : 1);
  if (v < 0) return 0;
  if (v > (__int128)kInf) return kInf;
  return (int64_t)v;
}

struct Dinic {
  struct Edge {
    int32_t to;
    int64_t cap;
    int32_t rev;   // index of reverse edge in graph[to]
    int32_t orig;  // original edge index, -1 for reverse edges
  };

  int32_t n;
  std::vector<std::vector<Edge>> graph;
  std::vector<int32_t> level, iter;

  explicit Dinic(int32_t n_) : n(n_), graph(n_), level(n_), iter(n_) {}

  void add_edge(int32_t u, int32_t v, int64_t cap, int32_t orig) {
    graph[u].push_back({v, cap, (int32_t)graph[v].size(), orig});
    graph[v].push_back({u, 0, (int32_t)graph[u].size() - 1, -1});
  }

  bool bfs(int32_t s, int32_t t) {
    std::fill(level.begin(), level.end(), -1);
    std::vector<int32_t> q;
    q.reserve(n);
    level[s] = 0;
    q.push_back(s);
    for (size_t h = 0; h < q.size(); ++h) {
      int32_t u = q[h];
      for (const Edge& e : graph[u]) {
        // No early exit on reaching t: the full level graph is needed for
        // each phase to compute a true blocking flow (the O(V^2 E) bound).
        if (e.cap > 0 && level[e.to] < 0) {
          level[e.to] = level[u] + 1;
          q.push_back(e.to);
        }
      }
    }
    return level[t] >= 0;
  }

  int64_t dfs(int32_t u, int32_t t, int64_t f) {
    if (u == t) return f;
    for (int32_t& i = iter[u]; i < (int32_t)graph[u].size(); ++i) {
      Edge& e = graph[u][i];
      if (e.cap > 0 && level[u] < level[e.to]) {
        int64_t d = dfs(e.to, t, f < e.cap ? f : e.cap);
        if (d > 0) {
          e.cap -= d;
          graph[e.to][e.rev].cap += d;
          return d;
        }
      }
    }
    return 0;
  }

  int64_t max_flow(int32_t s, int32_t t) {
    int64_t flow = 0;
    while (bfs(s, t)) {
      std::fill(iter.begin(), iter.end(), 0);
      int64_t f;
      while ((f = dfs(s, t, kInf)) > 0) flow += f;
    }
    return flow;
  }
};

// Build the graph for candidate time t and run max flow.  When out_flows is
// non-null it receives, per original edge, the flow pushed through it.
int64_t solve_at(int32_t n, int32_t m, const int32_t* eu, const int32_t* ev,
                 const int64_t* cap_const, const int64_t* cap_per_t,
                 int32_t s, int32_t t_sink, int64_t t, int64_t t_scale,
                 int64_t* out_flows) {
  Dinic d(n);
  std::vector<int64_t> caps(m);
  for (int32_t i = 0; i < m; ++i) {
    caps[i] = affine_cap(cap_const[i], cap_per_t[i], t, t_scale);
    d.add_edge(eu[i], ev[i], caps[i], i);
  }
  int64_t flow = d.max_flow(s, t_sink);
  if (out_flows != nullptr) {
    std::memset(out_flows, 0, sizeof(int64_t) * (size_t)m);
    for (int32_t u = 0; u < n; ++u) {
      for (const Dinic::Edge& e : d.graph[u]) {
        if (e.orig >= 0) out_flows[e.orig] = caps[e.orig] - e.cap;
      }
    }
  }
  return flow;
}

}  // namespace

extern "C" {

// Single max-flow evaluation at a fixed time t (building block / testing).
int64_t flow_max_flow_at(int32_t n, int32_t m, const int32_t* eu,
                         const int32_t* ev, const int64_t* cap_const,
                         const int64_t* cap_per_t, int32_t s, int32_t t_sink,
                         int64_t t, int64_t t_scale, int64_t* out_flows) {
  return solve_at(n, m, eu, ev, cap_const, cap_per_t, s, t_sink, t, t_scale,
                  out_flows);
}

// Full scheduler search (flow.go:146-218 equivalent): exponential search for
// a feasible completion time, binary search for the minimum, then one final
// solve whose per-edge flows are written to out_flows.  Returns the chosen
// time; *out_achieved reports the flow actually routed at that time (it can
// fall short of `required` only when the instance is infeasible, mirroring
// the reference's t_upper bail-out at flow.go:158-166).
int64_t flow_min_time_schedule(int32_t n, int32_t m, const int32_t* eu,
                               const int32_t* ev, const int64_t* cap_const,
                               const int64_t* cap_per_t, int32_t s,
                               int32_t t_sink, int64_t required,
                               int64_t t_scale, int64_t* out_flows,
                               int64_t* out_achieved) {
  int64_t t_upper = 1;
  while (solve_at(n, m, eu, ev, cap_const, cap_per_t, s, t_sink, t_upper,
                  t_scale, nullptr) < required) {
    if (t_upper > kInf / 2) break;  // infeasible: no t can satisfy required
    t_upper *= 2;
  }

  int64_t lo = 1, hi = t_upper, best = t_upper;
  while (lo <= hi) {
    int64_t mid = lo + (hi - lo) / 2;
    if (solve_at(n, m, eu, ev, cap_const, cap_per_t, s, t_sink, mid, t_scale,
                 nullptr) < required) {
      lo = mid + 1;
    } else {
      best = best < mid ? best : mid;
      hi = mid - 1;
    }
  }

  int64_t achieved = solve_at(n, m, eu, ev, cap_const, cap_per_t, s, t_sink,
                              best, t_scale, out_flows);
  if (out_achieved != nullptr) *out_achieved = achieved;
  return best;
}

}  // extern "C"
