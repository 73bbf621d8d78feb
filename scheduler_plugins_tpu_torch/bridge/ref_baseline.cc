// Compiled reference-shaped sequential baselines for bench configs 1-5
// (the PyTorch port's copy of the JAX package's bridge/ref_baseline.cc):
// the compiled denominator beside the card's solve. The reference is
// compiled Go, so a pure-Python loop would flatter every speedup.
//
// Each function mirrors the ALGORITHMIC SHAPE of the reference's hot loop
// (kubernetes-sigs/scheduler-plugins) -- a per-pod x per-node sequential
// scan with plugin-specific filter/score math and post-placement commits --
// not the tensor formulation:
//   cfg1  NodeResourcesAllocatable score + fit
//         (pkg/noderesources/resource_allocation.go:49-76,
//          allocatable.go:117-168)
//   cfg2  Trimaran TargetLoadPacking piecewise curve + LoadVariationRisk
//         (pkg/trimaran/targetloadpacking/targetloadpacking.go:170-205,
//          loadvariationriskbalancing/analysis.go:34-60)
//   cfg3  NUMA single-numa zone bitmask fit + LeastAllocated min-over-zones
//         (pkg/noderesourcetopology/filter.go:90-160,
//          least_allocated.go:25-55, score.go:110-124) with the OverReserve
//          pessimistic all-zone deduction (cache/store.go:129-160)
//   cfg4  ElasticQuota own-Max / aggregate-Min admission + allocatable score
//         (pkg/capacityscheduling/capacity_scheduling.go:208-282,
//          elasticquota.go:189-221)
//   cfg5  NetworkOverhead dependency satisfied/violated tallies + cost
//         accumulation (pkg/networkaware/networkoverhead/
//          networkoverhead.go:500-638)
//
// Host C++: built with g++ into build/native/ on first use
// (scheduler_plugins_tpu_torch/_build.py build_host) and driven through
// ctypes by scheduler_plugins_tpu_torch/bridge/ref_baseline.py.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// Go integer division truncates toward zero (the reference's score math is
// int64 end to end — allocatable.go:126).
inline int64_t godiv(int64_t a, int64_t b) { return b == 0 ? 0 : a / b; }

// Shared min-max normalize + argmax + commit tail: pick the best feasible
// node (max normalized score, lowest index tie-break) and subtract the
// request from its free row. raw scores follow Least mode (negated weighted
// sum), normalized to [0,100] over the feasible set (allocatable.go:143-168).
inline int32_t pick_and_commit(
    int64_t n_nodes, int64_t n_res, const int64_t* req_row,
    std::vector<int64_t>& free_flat, const std::vector<char>& feasible,
    const std::vector<int64_t>& raw) {
  int64_t lo = 0, hi = 0;
  bool any = false;
  for (int64_t n = 0; n < n_nodes; ++n) {
    if (!feasible[n]) continue;
    if (!any) { lo = hi = raw[n]; any = true; }
    else { if (raw[n] < lo) lo = raw[n]; if (raw[n] > hi) hi = raw[n]; }
  }
  if (!any) return -1;
  int32_t best = -1;
  int64_t best_score = -1;
  for (int64_t n = 0; n < n_nodes; ++n) {
    if (!feasible[n]) continue;
    int64_t score = hi == lo ? 0 : godiv((raw[n] - lo) * 100, hi - lo);
    if (score > best_score) { best_score = score; best = (int32_t)n; }
  }
  int64_t* f = &free_flat[(int64_t)best * n_res];
  for (int64_t r = 0; r < n_res; ++r) f[r] -= req_row[r];
  return best;
}

}  // namespace

extern "C" {

// -- config 1: allocatable-scored placement ---------------------------------
// free0 (N,R) initial free capacity; req (P,R) effective requests with the
// "pods" column already set to 1; weights (R,). Returns placed count.
int64_t ref_seq_alloc(int64_t N, int64_t P, int64_t R,
                      const int64_t* alloc, const int64_t* free0,
                      const int64_t* req, const int64_t* weights,
                      int32_t* out_assign) {
  std::vector<int64_t> free_flat(free0, free0 + N * R);
  int64_t wsum = 0;
  for (int64_t r = 0; r < R; ++r) wsum += weights[r];
  std::vector<char> feasible(N);
  std::vector<int64_t> raw(N);
  int64_t placed = 0;
  for (int64_t p = 0; p < P; ++p) {
    const int64_t* rq = &req[p * R];
    for (int64_t n = 0; n < N; ++n) {
      const int64_t* f = &free_flat[n * R];
      char ok = 1;
      for (int64_t r = 0; r < R; ++r) ok &= (char)(f[r] >= rq[r]);
      feasible[n] = ok;
      // the reference recomputes the weighted allocatable sum per (pod,
      // node) Score invocation (resource_allocation.go:49-76)
      int64_t s = 0;
      for (int64_t r = 0; r < R; ++r) s += weights[r] * alloc[n * R + r];
      raw[n] = -godiv(s, wsum);  // Least mode
    }
    int32_t choice = pick_and_commit(N, R, rq, free_flat, feasible, raw);
    out_assign[p] = choice;
    placed += choice >= 0;
  }
  return placed;
}

// -- config 2: trimaran TLP + LVRB ------------------------------------------
// cpu metrics in percent of capacity; pred_millis (P,) the TLP per-pod CPU
// prediction; missing (N,) ScheduledPodsCache compensation millis.
int64_t ref_seq_trimaran(int64_t N, int64_t P, int64_t R,
                         const int64_t* free0, const int64_t* req,
                         const int64_t* cpu_cap, const double* cpu_tlp,
                         const unsigned char* cpu_valid,
                         const double* cpu_avg, const double* cpu_std,
                         const double* mem_avg, const double* mem_std,
                         const int64_t* missing, const int64_t* pred_millis,
                         double target, double margin, double sensitivity,
                         int32_t* out_assign) {
  std::vector<int64_t> free_flat(free0, free0 + N * R);
  std::vector<char> feasible(N);
  std::vector<int64_t> raw(N);
  std::vector<int64_t> missing_live(missing, missing + N);
  int64_t placed = 0;
  for (int64_t p = 0; p < P; ++p) {
    const int64_t* rq = &req[p * R];
    for (int64_t n = 0; n < N; ++n) {
      const int64_t* f = &free_flat[n * R];
      char ok = 1;
      for (int64_t r = 0; r < R; ++r) ok &= (char)(f[r] >= rq[r]);
      feasible[n] = ok;
      // TargetLoadPacking piecewise curve (targetloadpacking.go:147-196)
      double tlp = 0;
      if (cpu_valid[n] && cpu_cap[n] > 0) {
        double measured = cpu_tlp[n] * (double)cpu_cap[n] / 100.0;
        double predicted =
            measured + (double)missing_live[n] + (double)pred_millis[p];
        double U = 100.0 * predicted / (double)cpu_cap[n];
        if (U <= target)
          tlp = (100.0 - target) * U / target + target;
        else if (U <= 100.0)
          tlp = target * (100.0 - U) / (100.0 - target);
      }
      // LoadVariationRiskBalancing (analysis.go:34-60): per-resource risk =
      // (mu + sigma^(1/sensitivity) * margin) / 2 clamped, score = min
      double mu_c = cpu_avg[n] / 100.0, sg_c = cpu_std[n] / 100.0;
      double mu_m = mem_avg[n] / 100.0, sg_m = mem_std[n] / 100.0;
      auto risk = [&](double mu, double sg) {
        // Go analysis.go:48-50: the root applies for sensitivity >= 0
        // (1/0 = +Inf, pow(x, inf) = 0 for x < 1); negative skips it
        double s = sensitivity >= 0 ? __builtin_pow(sg, 1.0 / sensitivity) : sg;
        double v = (mu + s * margin) / 2.0;
        return v < 0 ? 0.0 : (v > 1 ? 1.0 : v);
      };
      double lvrb_c = (1.0 - risk(mu_c, sg_c)) * 100.0;
      double lvrb_m = (1.0 - risk(mu_m, sg_m)) * 100.0;
      double lvrb = lvrb_c < lvrb_m ? lvrb_c : lvrb_m;
      raw[n] = (int64_t)(tlp + lvrb);
    }
    int32_t choice = pick_and_commit(N, R, rq, free_flat, feasible, raw);
    out_assign[p] = choice;
    placed += choice >= 0;
    if (choice >= 0) missing_live[choice] += pred_millis[p];
  }
  return placed;
}

// -- config 3: NUMA single-numa fit + LeastAllocated ------------------------
// zavail (N,Z,R) zone available; zalloc (N,Z,R) zone allocatable;
// zone_mask (N,Z); reported (N,Z,R). Pessimistic all-zone deduction on
// commit (cache/store.go:129-160).
int64_t ref_seq_numa(int64_t N, int64_t P, int64_t R, int64_t Z,
                     const int64_t* free0, const int64_t* req,
                     const int64_t* zavail0, const int64_t* zalloc,
                     const unsigned char* zone_mask,
                     const unsigned char* reported,
                     int32_t* out_assign) {
  std::vector<int64_t> free_flat(free0, free0 + N * R);
  std::vector<int64_t> zavail(zavail0, zavail0 + N * Z * R);
  std::vector<char> feasible(N);
  std::vector<int64_t> raw(N);
  int64_t placed = 0;
  for (int64_t p = 0; p < P; ++p) {
    const int64_t* rq = &req[p * R];
    for (int64_t n = 0; n < N; ++n) {
      const int64_t* f = &free_flat[n * R];
      char fit = 1;
      for (int64_t r = 0; r < R; ++r) fit &= (char)(f[r] >= rq[r]);
      // zone bitmask AND over per-resource feasibility (filter.go:90-160)
      uint64_t bitmask = 0;
      int64_t worst_zone_score = -1;  // min over zones (score.go:110-124)
      bool any_zone = false;
      for (int64_t z = 0; z < Z; ++z) {
        if (!zone_mask[n * Z + z]) continue;
        const int64_t* za = &zavail[(n * Z + z) * R];
        const int64_t* zl = &zalloc[(n * Z + z) * R];
        const unsigned char* rep = &reported[(n * Z + z) * R];
        char zok = 1;
        int64_t zscore_sum = 0, zscore_cnt = 0;
        for (int64_t r = 0; r < R; ++r) {
          if (rq[r] <= 0 || !rep[r]) continue;
          zok &= (char)(za[r] >= rq[r]);
          // LeastAllocated per resource: (alloc - used') * 100 / alloc
          int64_t used_after = zl[r] - za[r] + rq[r];
          zscore_sum += godiv((zl[r] - used_after) * 100, zl[r]);
          zscore_cnt += 1;
        }
        if (zok) {
          bitmask |= (uint64_t)1 << z;
          any_zone = true;
        }
        int64_t zscore = zscore_cnt ? godiv(zscore_sum, zscore_cnt) : 100;
        if (worst_zone_score < 0 || zscore < worst_zone_score)
          worst_zone_score = zscore;
      }
      feasible[n] = fit && any_zone;
      raw[n] = worst_zone_score < 0 ? 0 : worst_zone_score;
    }
    // argmax over feasible (scores already 0..100; no re-normalize in the
    // NUMA score path — score.go returns strategy output directly)
    int32_t best = -1;
    int64_t best_score = -1;
    for (int64_t n = 0; n < N; ++n) {
      if (!feasible[n]) continue;
      if (raw[n] > best_score) { best_score = raw[n]; best = (int32_t)n; }
    }
    out_assign[p] = best;
    if (best >= 0) {
      placed += 1;
      int64_t* f = &free_flat[(int64_t)best * R];
      for (int64_t r = 0; r < R; ++r) f[r] -= rq[r];
      for (int64_t z = 0; z < Z; ++z) {
        if (!zone_mask[(int64_t)best * Z + z]) continue;
        int64_t* za = &zavail[((int64_t)best * Z + z) * R];
        const unsigned char* rep = &reported[((int64_t)best * Z + z) * R];
        for (int64_t r = 0; r < R; ++r)
          if (rep[r]) za[r] -= rq[r];  // pessimistic all-zone deduction
      }
    }
  }
  return placed;
}

// -- config 4: gang + elastic quota + allocatable ---------------------------
// ns_of_pod (P,) quota-namespace row (-1 none); q_min/q_max/q_used (M,R);
// gang_of_pod (P,), gang_min (G,), gang_assigned (G,) pre-assigned counts.
// Quota admission: used+req <= Max(own) AND agg_used+req <= agg_min
// (capacity_scheduling.go:273-279); gang quorum evaluated per placement
// tally like Permit (core.go:308-345) — pods failing quorum at the end
// still count as placed-this-cycle (they Wait, they are not rejected).
int64_t ref_seq_gang_quota(int64_t N, int64_t P, int64_t R,
                           const int64_t* alloc, const int64_t* free0,
                           const int64_t* req, const int64_t* quota_req,
                           const int64_t* weights,
                           const int64_t* ns_of_pod, int64_t M,
                           const int64_t* q_min, const int64_t* q_max,
                           const unsigned char* has_quota,
                           const int64_t* q_used0,
                           const int64_t* gang_of_pod, int64_t G,
                           const int64_t* gang_min,
                           const int64_t* gang_assigned,
                           int32_t* out_assign, int32_t* out_wait) {
  std::vector<int64_t> free_flat(free0, free0 + N * R);
  std::vector<int64_t> used(q_used0, q_used0 + M * R);
  std::vector<int64_t> agg_min(R, 0), agg_used(R, 0);
  for (int64_t m = 0; m < M; ++m) {
    if (!has_quota[m]) continue;
    for (int64_t r = 0; r < R; ++r) {
      agg_min[r] += q_min[m * R + r];
      agg_used[r] += q_used0[m * R + r];
    }
  }
  int64_t wsum = 0;
  for (int64_t r = 0; r < R; ++r) wsum += weights[r];
  std::vector<int64_t> gang_sched(G, 0);
  std::vector<char> feasible(N);
  std::vector<int64_t> raw(N);
  int64_t placed = 0;
  for (int64_t p = 0; p < P; ++p) {
    const int64_t* rq = &req[p * R];
    const int64_t* qrq = &quota_req[p * R];  // raw request: pods slot 0
    int64_t ns = ns_of_pod[p];
    // PreFilter: elastic quota admission (absent Max entries arrive as
    // int64 max, absent Min as 0 — the snapshot builder's encoding)
    if (ns >= 0 && has_quota[ns]) {
      char ok = 1;
      for (int64_t r = 0; r < R; ++r) {
        ok &= (char)(used[ns * R + r] + qrq[r] <= q_max[ns * R + r]);
        ok &= (char)(agg_used[r] + qrq[r] <= agg_min[r]);
      }
      if (!ok) { out_assign[p] = -1; out_wait[p] = 0; continue; }
    }
    for (int64_t n = 0; n < N; ++n) {
      const int64_t* f = &free_flat[n * R];
      char ok = 1;
      for (int64_t r = 0; r < R; ++r) ok &= (char)(f[r] >= rq[r]);
      feasible[n] = ok;
      int64_t s = 0;
      for (int64_t r = 0; r < R; ++r) s += weights[r] * alloc[n * R + r];
      raw[n] = -godiv(s, wsum);
    }
    int32_t choice = pick_and_commit(N, R, rq, free_flat, feasible, raw);
    out_assign[p] = choice;
    out_wait[p] = 0;
    if (choice >= 0) {
      placed += 1;
      if (ns >= 0 && has_quota[ns])
        for (int64_t r = 0; r < R; ++r) {
          used[ns * R + r] += qrq[r];
          agg_used[r] += qrq[r];
        }
      int64_t g = gang_of_pod[p];
      if (g >= 0) gang_sched[g] += 1;
    }
  }
  // Permit: gang quorum
  for (int64_t p = 0; p < P; ++p) {
    int64_t g = gang_of_pod[p];
    if (out_assign[p] >= 0 && g >= 0)
      out_wait[p] = gang_assigned[g] + gang_sched[g] < gang_min[g];
  }
  return placed;
}

// -- config 5: network overhead ---------------------------------------------
// Costs (networkoverhead.go:576-638): same node 0; same zone 1; same region
// different zone -> zone_cost lookup (missing: cost MaxCost, no count);
// different region -> region_cost lookup; unlocated placed pod -> violated +
// MaxCost. Filter drops a node when violated > satisfied (:326-359); score
// is accumulated cost, lowest wins (inverted normalize).
int64_t ref_seq_network(int64_t N, int64_t P, int64_t R,
                        const int64_t* free0, const int64_t* req,
                        const int32_t* node_zone, const int32_t* node_region,
                        int64_t ZC, int64_t RC, const int32_t* zone_region,
                        const int64_t* zone_cost, const int64_t* region_cost,
                        int64_t W, const int64_t* placed0,
                        const int32_t* pod_wl, int64_t D,
                        const int32_t* dep_wl, const int64_t* dep_cost,
                        const unsigned char* dep_mask,
                        int32_t* out_assign) {
  const int64_t MAX_COST = 100;
  std::vector<int64_t> free_flat(free0, free0 + N * R);
  std::vector<int64_t> placed_wn(placed0, placed0 + W * N);
  std::vector<char> feasible(N);
  std::vector<int64_t> cost_acc(N), sat(N), vio(N);
  std::vector<int64_t> dep_zone_cnt(ZC), dep_region_noz(RC);
  int64_t placed = 0;
  for (int64_t p = 0; p < P; ++p) {
    const int64_t* rq = &req[p * R];
    for (int64_t n = 0; n < N; ++n) {
      const int64_t* f = &free_flat[n * R];
      char ok = 1;
      for (int64_t r = 0; r < R; ++r) ok &= (char)(f[r] >= rq[r]);
      feasible[n] = ok;
      cost_acc[n] = 0; sat[n] = 0; vio[n] = 0;
    }
    for (int64_t d = 0; d < D; ++d) {
      if (!dep_mask[p * D + d]) continue;
      int64_t w = dep_wl[p * D + d];
      int64_t maxc = dep_cost[p * D + d];
      const int64_t* pw = &placed_wn[w * N];
      // aggregate this dependency's placed pods by location
      std::fill(dep_zone_cnt.begin(), dep_zone_cnt.end(), 0);
      std::fill(dep_region_noz.begin(), dep_region_noz.end(), 0);
      int64_t unloc = 0;
      for (int64_t m = 0; m < N; ++m) {
        if (pw[m] == 0) continue;
        if (node_zone[m] >= 0) dep_zone_cnt[node_zone[m]] += pw[m];
        else if (node_region[m] >= 0) dep_region_noz[node_region[m]] += pw[m];
        else unloc += pw[m];
      }
      for (int64_t n = 0; n < N; ++n) {
        int64_t same_node = pw[n];
        int32_t nz = node_zone[n], nr = node_region[n];
        sat[n] += same_node;  // cost 0
        for (int64_t z = 0; z < ZC; ++z) {
          int64_t cnt = dep_zone_cnt[z] - (nz == (int32_t)z ? same_node : 0);
          if (cnt == 0) continue;
          int64_t c;
          if (nz == (int32_t)z) {
            c = 1;  // same zone
            sat[n] += cnt;
          } else if (nz >= 0 && nr >= 0 && zone_region[z] == nr) {
            c = zone_cost[(int64_t)nz * ZC + z];
            if (c < 0) c = MAX_COST;  // missing pair: cost only
            else { if (c <= maxc) sat[n] += cnt; else vio[n] += cnt; }
          } else if (nr >= 0 && zone_region[z] >= 0) {
            c = region_cost[(int64_t)nr * RC + zone_region[z]];
            if (c < 0) c = MAX_COST;
            else { if (c <= maxc) sat[n] += cnt; else vio[n] += cnt; }
          } else {
            c = MAX_COST;
            vio[n] += cnt;
          }
          cost_acc[n] += c * cnt;
        }
        for (int64_t rg = 0; rg < RC; ++rg) {
          int64_t cnt = dep_region_noz[rg];
          if (cnt == 0) continue;
          int64_t c;
          if (nr >= 0) {
            if (nr == (int32_t)rg) c = 1;
            else c = region_cost[(int64_t)nr * RC + rg];
            if (c < 0) { c = MAX_COST; vio[n] += cnt; }
            else { if (c <= maxc) sat[n] += cnt; else vio[n] += cnt; }
          } else { c = MAX_COST; vio[n] += cnt; }
          cost_acc[n] += c * cnt;
        }
        if (unloc) { vio[n] += unloc; cost_acc[n] += MAX_COST * unloc; }
      }
    }
    int32_t best = -1;
    int64_t best_cost = 0;
    for (int64_t n = 0; n < N; ++n) {
      if (!feasible[n] || vio[n] > sat[n]) continue;
      if (best < 0 || cost_acc[n] < best_cost) {
        best = (int32_t)n;
        best_cost = cost_acc[n];
      }
    }
    out_assign[p] = best;
    if (best >= 0) {
      placed += 1;
      int64_t* f = &free_flat[(int64_t)best * R];
      for (int64_t r = 0; r < R; ++r) f[r] -= rq[r];
      if (pod_wl[p] >= 0) placed_wn[(int64_t)pod_wl[p] * N + best] += 1;
    }
  }
  return placed;
}

}  // extern "C"
