"""Headless map / frame visualization.

Reference counterpart: Viewer + MapDrawer + FrameDrawer (Pangolin + HighGUI,
code/src/{Viewer,MapDrawer,FrameDrawer}.cc).  This environment is
headless, so the equivalents render to PNG: a top-down (or 3-axis) map
view with keyframe frusta, covisibility edges, and map points, and a
frame overlay with tracked keypoints.

Copy of swarmmap_tpu/viz/viewer.py (numpy; matplotlib is imported only
inside `_require_mpl`).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from ..core.map_store import NO_MP, MapStore


def _require_mpl():
    try:
        import matplotlib
    except ModuleNotFoundError:
        raise ModuleNotFoundError(
            "the PNG map and frame views need matplotlib, which is not installed; "
            "viz.html_viewer.export_html writes the map view without it") from None

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def draw_map(store: MapStore, path: str | Path, title: str = "",
             gt_traj: np.ndarray | None = None) -> None:
    """Top-down (x-z) map view: points, keyframe positions, spanning tree
    + loop edges (MapDrawer equivalent)."""
    plt = _require_mpl()
    fig, ax = plt.subplots(figsize=(8, 8))
    mps = store.alive_mp_slots()
    if len(mps):
        p = store.mp_global_pos(mps)
        ax.scatter(p[:, 0], p[:, 2], s=1, c="#777777", alpha=0.5, label="map points")
    kfs = store.alive_kf_slots()
    centers = np.array([
        np.linalg.inv(store.kf_global_pose(k))[:3, 3] for k in kfs
    ]) if len(kfs) else np.zeros((0, 3))
    if len(centers):
        genuine = store.kf_genuine[kfs]
        ax.plot(centers[:, 0], centers[:, 2], "b.-", lw=0.8, ms=4, label="keyframes")
        if (~genuine).any():
            ax.scatter(centers[~genuine, 0], centers[~genuine, 2], marker="x",
                       c="m", s=36, label="virtual KFs")
        for i, k in enumerate(kfs):
            p = store.kf_parent[k]
            if p >= 0 and store.kf_alive[p]:
                j = np.where(kfs == p)[0]
                if len(j):
                    ax.plot([centers[i, 0], centers[j[0], 0]],
                            [centers[i, 2], centers[j[0], 2]], "g-", lw=0.4, alpha=0.6)
            for l in store.kf_loop_edges.get(int(k), ()):
                j = np.where(kfs == l)[0]
                if len(j):
                    ax.plot([centers[i, 0], centers[j[0], 0]],
                            [centers[i, 2], centers[j[0], 2]], "r-", lw=1.2)
    if gt_traj is not None:
        ax.plot(gt_traj[:, 0], gt_traj[:, 2], "k--", lw=0.8, alpha=0.7,
                label="ground truth")
    ax.set_aspect("equal")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.legend(loc="upper right", fontsize=8)
    ax.set_title(title or f"map {store.map_id}: "
                 f"{len(kfs)} KFs, {len(mps)} points")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def draw_frame(image: np.ndarray, frame, path: str | Path) -> None:
    """Frame overlay: green = tracked (has map point), blue = detected
    (FrameDrawer equivalent)."""
    plt = _require_mpl()
    fig, ax = plt.subplots(figsize=(8, 6))
    ax.imshow(image, cmap="gray", vmin=0, vmax=255)
    v = frame.valid
    tracked = v & (frame.mp != NO_MP)
    ax.scatter(frame.xy[v & ~tracked, 0], frame.xy[v & ~tracked, 1],
               s=6, facecolors="none", edgecolors="#4488ff", lw=0.6)
    ax.scatter(frame.xy[tracked, 0], frame.xy[tracked, 1],
               s=10, facecolors="none", edgecolors="#22cc44", lw=0.9)
    ax.set_title(f"frame {frame.frame_id}: {int(tracked.sum())} tracked / "
                 f"{int(v.sum())} detected")
    ax.axis("off")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
