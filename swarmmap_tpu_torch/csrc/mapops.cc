// Host-side map bookkeeping hot loops in C++.
//
// Copy of swarmmap_tpu/native/src/mapops.cc, built with g++ by _build.py
// (load_host) and bound by swarmmap_tpu_torch/native.py.
//
// Reference counterpart: the pointer-graph maintenance the reference does
// inline in C++ (KeyFrame::UpdateConnections, Mapit::Aggregate).  The
// python MapStore keeps dict-based indices for flexibility; these batch
// kernels replace its hottest loops.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

extern "C" {

// Covisibility rebuild: given per-keyframe map-point tables
// kf_mp [n_kf * n_kp] (int32 slot or -1), emit for each ordered pair of
// keyframes sharing >= min_shared points one (i, j, count) triple.
// Returns the number of pairs written (capped at max_pairs).
int covisibility_from_observations(const int32_t* kf_mp, int n_kf, int n_kp,
                                   const uint8_t* kf_alive, int min_shared,
                                   int32_t* out_i, int32_t* out_j,
                                   int32_t* out_count, int max_pairs) {
  // invert: map point -> observing keyframes
  std::unordered_map<int32_t, std::vector<int32_t>> observers;
  observers.reserve(n_kf * 64);
  for (int k = 0; k < n_kf; k++) {
    if (!kf_alive[k]) continue;
    const int32_t* row = kf_mp + (size_t)k * n_kp;
    for (int p = 0; p < n_kp; p++)
      if (row[p] >= 0) observers[row[p]].push_back(k);
  }
  // accumulate pair counts
  std::unordered_map<int64_t, int32_t> counts;
  counts.reserve(n_kf * 32);
  for (auto& [mp, obs] : observers) {
    for (size_t a = 0; a < obs.size(); a++)
      for (size_t b = a + 1; b < obs.size(); b++) {
        int64_t key = ((int64_t)obs[a] << 32) | (uint32_t)obs[b];
        counts[key]++;
      }
  }
  int n_out = 0;
  for (auto& [key, c] : counts) {
    if (c < min_shared || n_out >= max_pairs) continue;
    out_i[n_out] = (int32_t)(key >> 32);
    out_j[n_out] = (int32_t)(key & 0xffffffff);
    out_count[n_out] = c;
    n_out++;
  }
  return n_out;
}

// Op-log compaction (reference: Mapit::Aggregate, Mapit.cc:50-143).
// Records come as parallel arrays; func ids are small ints; targets are
// 64-bit gids. last_writer[f]=1 marks last-writer-wins funcs;
// is_badflag[f]=1 marks SetBadFlag. out_keep[i]=1 for surviving records.
// Returns number kept.  Semantics: per (kind,func,target) keep only the
// LAST record for last-writer funcs; drop all records on targets with a
// SetBadFlag of the same kind except the badflag itself.
int aggregate_oplog(const int32_t* kind, const int32_t* func,
                    const int64_t* target, int n,
                    const uint8_t* last_writer, const uint8_t* is_badflag,
                    uint8_t* out_keep) {
  std::fill(out_keep, out_keep + n, 1);
  // dead targets per kind
  std::unordered_map<int64_t, uint8_t> dead;  // key: target*4 + kind
  for (int i = 0; i < n; i++)
    if (is_badflag[func[i]]) dead[target[i] * 4 + kind[i]] = 1;
  // last-writer survivor index per (kind,func,target)
  std::unordered_map<int64_t, int32_t> last;
  last.reserve(n);
  for (int i = 0; i < n; i++) {
    if (dead.count(target[i] * 4 + kind[i]) && !is_badflag[func[i]]) {
      out_keep[i] = 0;
      continue;
    }
    if (last_writer[func[i]]) {
      // key mixes func and kind into the target id space
      int64_t key = target[i] * 1024 + kind[i] * 256 + func[i];
      auto it = last.find(key);
      if (it != last.end()) {
        out_keep[it->second] = 0;
        it->second = i;
      } else {
        last.emplace(key, i);
      }
    }
  }
  int kept = 0;
  for (int i = 0; i < n; i++) kept += out_keep[i];
  return kept;
}

// Redundancy check for keyframe culling (reference:
// LocalMapping::KeyFrameCulling / MapManager::KeyFrameCulling):
// for each candidate keyframe, count points observed by >= 3 other
// keyframes at the same-or-finer scale.
void redundancy_counts(const int32_t* kf_mp, const int32_t* kf_oct,
                       int n_kf, int n_kp, const uint8_t* kf_alive,
                       const int32_t* cand, int n_cand,
                       int32_t* out_total, int32_t* out_redundant) {
  // invert observations with octaves
  std::unordered_map<int32_t, std::vector<std::pair<int32_t, int32_t>>> obs;
  for (int k = 0; k < n_kf; k++) {
    if (!kf_alive[k]) continue;
    const int32_t* row = kf_mp + (size_t)k * n_kp;
    const int32_t* oct = kf_oct + (size_t)k * n_kp;
    for (int p = 0; p < n_kp; p++)
      if (row[p] >= 0) obs[row[p]].emplace_back(k, oct[p]);
  }
  for (int c = 0; c < n_cand; c++) {
    const int k = cand[c];
    const int32_t* row = kf_mp + (size_t)k * n_kp;
    const int32_t* oct = kf_oct + (size_t)k * n_kp;
    int total = 0, redundant = 0;
    for (int p = 0; p < n_kp; p++) {
      if (row[p] < 0) continue;
      auto it = obs.find(row[p]);
      if (it == obs.end()) continue;
      total++;
      int better = 0;
      for (auto& [ok, ooct] : it->second) {
        if (ok != k && ooct <= oct[p] + 1) {
          if (++better >= 3) break;
        }
      }
      if (better >= 3) redundant++;
    }
    out_total[c] = total;
    out_redundant[c] = redundant;
  }
}

}  // extern "C"
