"""Drive and profile the per-agent tracker on the GPU.

    python -m swarmmap_tpu_torch.profile_tracker [--out DIR]

Tracks the tracker cells of `cells.py` (make_world(seed=4), 480x752, 1000
features, 8 levels, 1500 landmarks): 12 RGB-D frames (the staged path) and
a depth frame then 12 monocular frames (the fused path), and profiles one
late frame of each path under torch.profiler.  Then runs the monocular
client (`cells.mono_sequence()`, `System.track_monocular`) for 12 frames,
holds back the next keyframe from local mapping, and profiles its
`LocalMapping.process_keyframe` (triangulate + fuse, local BA, culling).
Prints one JSON line per path: the wall time, its summed device time, the
wall time not covered by device work, the device's idle share, kernel
launches, `pose_lm` launches and fetches; writes each profiler table,
sorted by device time, to DIR/profile_tracker_<path>.txt.  Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from .cells import (timed_record, mono_sequence, new_system, new_tracker, render_frames, track_frame,
                    track_mono, track_sequence, tracker_world)
from .utils.stats import STATS


def _profile(run, name: str, out: Path) -> dict:
    """Profile run(), which returns a FrameRecord of its work."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    fetches = STATS.counts["rpc_fetch"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        rec = run()
    dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    kernels = [e for e in dev_events if "memcpy" not in e.name.lower()
               and "memset" not in e.name.lower()]
    device_ms = sum(e.time_range.elapsed_us() for e in dev_events) / 1e3
    (out / f"profile_tracker_{name}.txt").write_text(prof.key_averages().table(
        sort_by="device_time_total", row_limit=40))
    return {"path": name, "state": rec.state, "inliers": rec.inliers,
            "wall_ms_profiled": rec.ms, "device_ms": device_ms,
            "wall_minus_device_ms": rec.ms - device_ms,
            "idle_share": max(0.0, 1.0 - device_ms / rec.ms),
            "kernel_launches": len(kernels), "device_events": len(dev_events),
            "pose_lm_launches": rec.counts["pose_lm"],
            "fetches": STATS.counts["rpc_fetch"] - fetches}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="outputs")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_tracker needs a CUDA device")
    import swarmmap_tpu_torch  # noqa: F401  (precision pins)

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda", 0)
    world = tracker_world()
    frames = render_frames(world, 13)
    for name, depth_frames in (("staged", range(13)), ("fused", {0})):
        tracker = new_tracker(world, dev)
        track_sequence(tracker, frames[:12], depth_frames)
        img, d = frames[12]
        depth = d if 12 in depth_frames else None
        res = _profile(lambda: track_frame(tracker, img, depth, 0.6), name, out)
        res["device"] = torch.cuda.get_device_name(0)
        print(json.dumps(res))

    # a mapped keyframe: the first keyframe after frame 12, held back from
    # local mapping and then mapped under the profiler
    seq = mono_sequence()
    system = new_system(seq, dev)
    mapper = system.local_mapping
    track_mono(system, seq, 12)
    held = []
    mapper.insert_keyframe = held.append
    i = 12
    while not held and i < len(seq):
        system.track_monocular(seq.read(i), seq.timestamps[i])
        i += 1
    if not held:
        sys.exit("profile_tracker: no keyframe inserted after frame 12")
    res = _profile(lambda: timed_record(lambda: mapper.process_keyframe(held[0]), system.tracking),
                   "mapped_keyframe", out)
    res.update(device=torch.cuda.get_device_name(0), keyframe=held[0], frame=i - 1)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
