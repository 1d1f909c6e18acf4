"""Live map view of a RUNNING swarm (reference: src/Viewer.cc renders a
Pangolin window during the run).

Headless-appropriate equivalent: the swarm appends one JSON line per
snapshot to `scene.jsonl`, and `live.html` (written once next to it)
polls that file and redraws a top-down trajectory/landmark view about
once a second — open it with any browser pointed at the output
directory (`python -m http.server` in the directory works).

Enable in combined mode with  SWARMMAP_LIVE_DIR=<dir>  (cli/swarm_map).

Copy of swarmmap_tpu/viz/live.py (numpy and json).
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

_COLORS = ["#4488ff", "#ff8844", "#44cc66", "#cc44cc", "#cccc44", "#44cccc"]

_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>swarmmap_tpu live</title>
<style>
 body { margin:0; background:#111; color:#ddd; font:12px monospace; }
 #hud { position:fixed; top:8px; left:8px; }
 canvas { display:block; }
</style></head>
<body>
<div id="hud">swarmmap_tpu live view — polling scene.jsonl</div>
<canvas id="cv"></canvas>
<script>
const cv = document.getElementById('cv'), ctx = cv.getContext('2d');
function resize(){ cv.width = innerWidth; cv.height = innerHeight; }
addEventListener('resize', resize); resize();
let scene = null;
async function poll(){
  try {
    const r = await fetch('scene.jsonl', {cache: 'no-store'});
    const text = await r.text();
    const lines = text.trim().split('\\n');
    if (lines.length) scene = JSON.parse(lines[lines.length-1]);
  } catch (e) {}
  draw();
}
setInterval(poll, 1000); poll();
function draw(){
  ctx.fillStyle = '#111'; ctx.fillRect(0,0,cv.width,cv.height);
  if (!scene) return;
  // fit all trajectory points (top-down: x right, z up)
  let xs=[], zs=[];
  for (const a of scene.agents) for (const p of a.traj){ xs.push(p[0]); zs.push(p[2]); }
  if (!xs.length) return;
  const minx=Math.min(...xs), maxx=Math.max(...xs);
  const minz=Math.min(...zs), maxz=Math.max(...zs);
  const s = 0.9*Math.min(cv.width/Math.max(maxx-minx,1e-3),
                         cv.height/Math.max(maxz-minz,1e-3));
  const ox = cv.width/2 - s*(minx+maxx)/2, oz = cv.height/2 + s*(minz+maxz)/2;
  const X = p => ox + s*p[0], Z = p => oz - s*p[2];
  for (const [i,a] of scene.agents.entries()){
    ctx.strokeStyle = a.color; ctx.lineWidth = 1.5; ctx.beginPath();
    for (const [j,p] of a.traj.entries())
      j ? ctx.lineTo(X(p),Z(p)) : ctx.moveTo(X(p),Z(p));
    ctx.stroke();
    const last = a.traj[a.traj.length-1];
    ctx.fillStyle = a.color;
    ctx.beginPath(); ctx.arc(X(last),Z(last),4,0,7); ctx.fill();
    ctx.fillText(`agent ${a.id}  kf=${a.n_kf} mp=${a.n_mp} ${a.state}`,
                 10, 30 + 14*i);
  }
  ctx.fillStyle = '#888';
  ctx.fillText(`frame ${scene.frame}  groups ${JSON.stringify(scene.groups)}`,
               10, cv.height - 10);
}
</script></body></html>
"""


class LiveStream:
    """Append-only JSONL scene stream + one-time HTML shell."""

    def __init__(self, out_dir, traj_tail: int = 400):
        self.dir = Path(out_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.path = self.dir / "scene.jsonl"
        self.path.write_text("")
        (self.dir / "live.html").write_text(_HTML)
        self.traj_tail = traj_tail

    def emit(self, swarm) -> None:
        """Append one snapshot of the swarm (call on the report cadence)."""
        agents = []
        for i, a in enumerate(swarm.agents):
            tr = a.system.tracking
            traj = [t[1][:3, 3] for t in tr.trajectory[-self.traj_tail:]]
            st = a.system.store
            agents.append({
                "id": a.agent_id,
                "color": _COLORS[i % len(_COLORS)],
                "state": tr.state.name,
                "n_kf": int(st.kf_alive[: st.n_kf].sum()),
                "n_mp": int(st.mp_alive[: st.n_mp].sum()),
                "traj": np.round(np.asarray(traj, np.float32), 3).tolist()
                        if traj else [],
            })
        rec = {
            "frame": swarm.frame_count,
            "agents": agents,
            "groups": [sorted(g) for g in swarm.merged_groups()],
        }
        with self.path.open("a") as f:
            f.write(json.dumps(rec) + "\n")
