// Quadtree keypoint distribution — exact-semantics host implementation.
//
// Copy of swarmmap_tpu/native/src/octree.cc, built with g++ by _build.py
// (load_host) and bound by swarmmap_tpu_torch/native.py.
//
// Reference spec: ORBextractor::DistributeOctTree
// (code/src/ORBextractor.cc:465 of the C++ SwarmMap): recursively split the
// image extent into quadrants until the number of occupied nodes reaches
// the budget (nodes with one keypoint stop splitting), then keep the
// best-response keypoint per node.
//
// The TPU path approximates this with per-cell-max bonuses + top-k
// (ops/fast.py); this native version provides bit-exact reference
// semantics for parity runs and host-side pipelines.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <list>
#include <vector>

namespace {

struct Node {
  float x0, y0, x1, y1;
  std::vector<int> idx;   // keypoint indices inside this node
  bool no_more = false;   // single keypoint: stop splitting
};

}  // namespace

extern "C" {

// xs, ys, responses: [n] keypoint data. out_keep: [n] byte mask set to 1
// for kept keypoints. Returns number kept (<= budget).
int distribute_octree(const float* xs, const float* ys,
                      const float* responses, int n,
                      float min_x, float min_y, float max_x, float max_y,
                      int budget, uint8_t* out_keep) {
  std::fill(out_keep, out_keep + n, 0);
  if (n == 0 || budget <= 0) return 0;

  std::list<Node> nodes;
  // initial nodes: square-ish split of the horizontal extent
  const float w = max_x - min_x, h = max_y - min_y;
  const int n_init = std::max(1, (int)std::lround(w / std::max(h, 1.0f)));
  const float hx = w / n_init;
  for (int i = 0; i < n_init; i++) {
    Node nd;
    nd.x0 = min_x + i * hx;
    nd.x1 = min_x + (i + 1) * hx;
    nd.y0 = min_y;
    nd.y1 = max_y;
    nodes.push_back(std::move(nd));
  }
  {
    auto it = nodes.begin();
    std::vector<Node*> init(n_init);
    for (int i = 0; i < n_init; i++, ++it) init[i] = &*it;
    for (int k = 0; k < n; k++) {
      int b = std::min((int)((xs[k] - min_x) / hx), n_init - 1);
      if (b < 0) b = 0;
      init[b]->idx.push_back(k);
    }
  }
  for (auto it = nodes.begin(); it != nodes.end();) {
    if (it->idx.empty()) it = nodes.erase(it);
    else {
      if (it->idx.size() == 1) it->no_more = true;
      ++it;
    }
  }

  bool finished = false;
  while (!finished) {
    if ((int)nodes.size() >= budget) break;
    // expandable nodes, largest occupancy first (reference splits the
    // densest nodes when close to the budget; we follow the same rule)
    std::vector<std::pair<int, std::list<Node>::iterator>> expandable;
    for (auto it = nodes.begin(); it != nodes.end(); ++it)
      if (!it->no_more) expandable.emplace_back((int)it->idx.size(), it);
    if (expandable.empty()) break;
    std::sort(expandable.begin(), expandable.end(),
              [](auto& a, auto& b) { return a.first > b.first; });

    bool split_any = false;
    for (auto& [cnt, it] : expandable) {
      if ((int)nodes.size() >= budget) { finished = true; break; }
      Node& nd = *it;
      const float mx = 0.5f * (nd.x0 + nd.x1);
      const float my = 0.5f * (nd.y0 + nd.y1);
      Node q[4];
      q[0] = {nd.x0, nd.y0, mx, my};
      q[1] = {mx, nd.y0, nd.x1, my};
      q[2] = {nd.x0, my, mx, nd.y1};
      q[3] = {mx, my, nd.x1, nd.y1};
      for (int k : nd.idx) {
        int qi = (xs[k] >= mx ? 1 : 0) + (ys[k] >= my ? 2 : 0);
        q[qi].idx.push_back(k);
      }
      for (int j = 0; j < 4; j++) {
        if (q[j].idx.empty()) continue;
        if (q[j].idx.size() == 1) q[j].no_more = true;
        nodes.push_back(std::move(q[j]));
      }
      nodes.erase(it);
      split_any = true;
    }
    if (!split_any) break;
  }

  int kept = 0;
  for (auto& nd : nodes) {
    int best = -1;
    float best_r = -1e30f;
    for (int k : nd.idx)
      if (responses[k] > best_r) { best_r = responses[k]; best = k; }
    if (best >= 0) { out_keep[best] = 1; kept++; }
  }
  return kept;
}

}  // extern "C"
