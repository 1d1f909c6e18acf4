"""Combined-mode entry point: N clients + N mediators + scheduler in one
process (reference: code/Examples/Monocular/swarm_map.cc).

Port of swarmmap_tpu/cli/swarm_map.py, on the card by default:

    python -m swarmmap_tpu_torch.cli.swarm_map -d config/mh123.yaml -c 3
    python -m swarmmap_tpu_torch.cli.swarm_map --synthetic -c 3 --frames 120
    python -m swarmmap_tpu_torch.cli.swarm_map --synthetic -c 1 --device cpu
"""
from __future__ import annotations

import time
from pathlib import Path

from ..swarm import Swarm, SwarmConfig
from ..utils.logging import get_logger
from ..utils.profiling import maybe_trace, named_range
from .common import apply_wire, base_parser, device_of, load_vocab, load_world

_log = get_logger("swarm_map")


def main(argv=None):
    p = base_parser("swarmmap combined multi-agent SLAM (PyTorch)")
    p.add_argument("-c", "--clients", type=int, default=1)
    args = p.parse_args(argv)
    apply_wire(args)

    device = device_of(args)
    settings, seqs = load_world(args, args.clients)
    vocab = load_vocab(args.voc)
    fps = settings.camera.fps
    swarm = Swarm(
        args.clients, settings, vocab=vocab,
        config=SwarmConfig(push_every=max(int(2 * fps), 1),
                           report_every=max(int(0.5 * fps), 1)),
        device=device,
    )

    # SWARMMAP_LIVE_DIR=<dir>: stream JSONL snapshots + an auto-
    # refreshing live.html so the run can be watched in a browser
    # (reference: the Pangolin Viewer thread, src/Viewer.cc)
    import os

    live = None
    if os.environ.get("SWARMMAP_LIVE_DIR"):
        from ..viz.live import LiveStream

        live = LiveStream(os.environ["SWARMMAP_LIVE_DIR"])
        _log.info("live view: open %s/live.html", os.environ["SWARMMAP_LIVE_DIR"])

    n_frames = min(len(s) for s in seqs)
    t0 = time.time()
    lat = []
    # SWARMMAP_TRACE_DIR=<dir> captures a torch.profiler trace
    with maybe_trace() as trace_path:
        for i in range(n_frames):
            ts = time.time()
            with named_range(f"swarm.step[{i}]"):
                swarm.step([s.read(i) for s in seqs],
                           float(seqs[0].timestamps[i]))
            lat.append(time.time() - ts)
            if live is not None and i % swarm.config.report_every == 0:
                live.emit(swarm)
            if i % 50 == 0:
                _log.info(
                    "frame %d/%d | %s", i, n_frames,
                    " ".join(
                        f"a{a.agent_id}:kf={a.system.n_keyframes()},mp={a.system.n_map_points()}"
                        for a in swarm.agents
                    ),
                )
        swarm.finish()
    wall = time.time() - t0
    if trace_path is not None:
        _log.info("trace: %s", trace_path)

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    swarm.save_outputs(out)
    if args.mapviewer or args.viewer:
        from ..viz.html_viewer import export_html
        from ..viz.viewer import draw_map

        for med in swarm.mediators:
            draw_map(med.store, out / f"map-server-{med.map_id}.png")
        export_html([m.store for m in swarm.mediators], out / "map.html",
                    title=f"{args.clients}-agent server maps")
    lat_sorted = sorted(lat)
    p50 = lat_sorted[len(lat) // 2] * 1e3
    p95 = lat_sorted[int(len(lat) * 0.95)] * 1e3
    fps_per_agent = n_frames / wall
    _log.info(
        "done: %d frames x %d agents in %.1fs — %.1f fps/agent, "
        "step p50=%.1fms p95=%.1fms, groups=%s",
        n_frames, args.clients, wall, fps_per_agent, p50, p95,
        swarm.merged_groups(),
    )
    for a in swarm.agents:
        _log.info("agent %d: tracked %d/%d, pushed %.2f MB",
                  a.agent_id, a.frames_tracked, n_frames, a.bytes_pushed / 1e6)
    return swarm


if __name__ == "__main__":
    main()
