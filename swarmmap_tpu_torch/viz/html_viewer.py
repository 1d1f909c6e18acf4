"""Interactive 3-D map viewer as a single self-contained HTML file.

The reference's Pangolin window (src/Viewer.cc) is an interactive 3-D
view of map points, keyframe frusta, the spanning tree and loop edges.
This headless analogue embeds the same scene as JSON inside one HTML
file with a dependency-free canvas renderer (drag = orbit, wheel = zoom,
shift-drag = pan) — open it in any browser, no server or CDN needed.

Copy of swarmmap_tpu/viz/html_viewer.py (numpy and json).
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from ..core.map_store import MapStore

_COLORS = ["#4488ff", "#ff8844", "#44cc66", "#cc44cc", "#cccc44", "#44cccc"]

_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>swarmmap_tpu map viewer</title>
<style>
 body {{ margin:0; background:#111; color:#ddd; font:12px monospace; }}
 #hud {{ position:fixed; top:8px; left:8px; user-select:none; }}
 canvas {{ display:block; }}
</style></head>
<body>
<div id="hud">{title}<br>drag: orbit &nbsp; wheel: zoom &nbsp; shift-drag: pan</div>
<canvas id="cv"></canvas>
<script>
const SCENE = {scene_json};
const cv = document.getElementById('cv'), ctx = cv.getContext('2d');
let yaw = -0.6, pitch = 0.4, dist = SCENE.radius * 2.5;
let cx = SCENE.center[0], cy = SCENE.center[1], cz = SCENE.center[2];
let panX = 0, panY = 0;
function resize() {{ cv.width = innerWidth; cv.height = innerHeight; draw(); }}
addEventListener('resize', resize);
function proj(p) {{
  let x = p[0]-cx, y = p[1]-cy, z = p[2]-cz;
  let x1 =  Math.cos(yaw)*x + Math.sin(yaw)*z;
  let z1 = -Math.sin(yaw)*x + Math.cos(yaw)*z;
  let y2 =  Math.cos(pitch)*y - Math.sin(pitch)*z1;
  let z2 =  Math.sin(pitch)*y + Math.cos(pitch)*z1 + dist;
  if (z2 < 0.05) return null;
  const f = 0.9 * Math.min(cv.width, cv.height);
  return [cv.width/2 + panX + f*x1/z2, cv.height/2 + panY + f*y2/z2, z2];
}}
function seg(a, b, color, w) {{
  const pa = proj(a), pb = proj(b);
  if (!pa || !pb) return;
  ctx.strokeStyle = color; ctx.lineWidth = w;
  ctx.beginPath(); ctx.moveTo(pa[0], pa[1]); ctx.lineTo(pb[0], pb[1]); ctx.stroke();
}}
function draw() {{
  ctx.fillStyle = '#111'; ctx.fillRect(0, 0, cv.width, cv.height);
  for (const m of SCENE.maps) {{
    ctx.fillStyle = m.color + '99';
    for (const p of m.points) {{
      const q = proj(p);
      if (q) ctx.fillRect(q[0], q[1], 1.6, 1.6);
    }}
    for (let i = 1; i < m.traj.length; i++)
      seg(m.traj[i-1], m.traj[i], m.color, 1.4);
    for (const e of m.tree) seg(m.traj[e[0]], m.traj[e[1]], '#44cc44', 0.7);
    for (const e of m.loops) seg(m.traj[e[0]], m.traj[e[1]], '#ff3333', 1.8);
  }}
}}
let drag = null;
cv.addEventListener('mousedown', e => drag = [e.clientX, e.clientY, e.shiftKey]);
addEventListener('mouseup', () => drag = null);
addEventListener('mousemove', e => {{
  if (!drag) return;
  const dx = e.clientX - drag[0], dy = e.clientY - drag[1];
  if (drag[2]) {{ panX += dx; panY += dy; }}
  else {{ yaw += dx * 0.008; pitch += dy * 0.008; }}
  drag = [e.clientX, e.clientY, drag[2]];
  draw();
}});
cv.addEventListener('wheel', e => {{
  dist *= Math.exp(e.deltaY * 0.001); e.preventDefault(); draw();
}}, {{passive: false}});
resize();
</script></body></html>
"""


def export_html(stores: list[MapStore] | MapStore, path: str | Path,
                title: str = "swarmmap_tpu", max_points: int = 20000) -> None:
    """Write one standalone HTML viewer for one or more map stores
    (global coordinates, so merged groups line up)."""
    if isinstance(stores, MapStore):
        stores = [stores]
    maps = []
    all_pts = []
    for si, st in enumerate(stores):
        mps = st.alive_mp_slots()
        pts = st.mp_global_pos(mps) if len(mps) else np.zeros((0, 3))
        if len(pts) > max_points:
            pts = pts[np.random.RandomState(0).choice(len(pts), max_points,
                                                      replace=False)]
        kfs = st.alive_kf_slots()
        traj = np.array([np.linalg.inv(st.kf_global_pose(k))[:3, 3]
                         for k in kfs]) if len(kfs) else np.zeros((0, 3))
        slot_row = {int(k): i for i, k in enumerate(kfs)}
        tree, loops = [], []
        for i, k in enumerate(kfs):
            p = int(st.kf_parent[k])
            if p in slot_row:
                tree.append([i, slot_row[p]])
            for l in st.kf_loop_edges.get(int(k), ()):
                if int(l) in slot_row:
                    loops.append([i, slot_row[int(l)]])
        maps.append(dict(
            color=_COLORS[si % len(_COLORS)],
            points=np.round(pts, 4).tolist(),
            traj=np.round(traj, 4).tolist(),
            tree=tree, loops=loops,
        ))
        all_pts.extend([pts, traj])
    cloud = np.concatenate([p for p in all_pts if len(p)], 0) \
        if any(len(p) for p in all_pts) else np.zeros((1, 3))
    center = cloud.mean(0)
    radius = float(np.percentile(np.linalg.norm(cloud - center, axis=1), 90) + 1e-3)
    scene = dict(maps=maps, center=np.round(center, 4).tolist(), radius=radius)
    html = _TEMPLATE.format(title=title, scene_json=json.dumps(scene))
    Path(path).write_text(html)
