"""Per-image container (reference: code/src/Frame.cc).

Port of swarmmap_tpu/core/frame.py.  Holds the extractor output (padded
numpy arrays on the host), undistorted keypoints, pose, and the
per-keypoint map-point association.  `build_frame` runs the port's
front end on a device and brings the features back in one fetch.
Descriptor words are uint32 on the host, as in the JAX package (the
tensors hold the same bits as int32).
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

from .. import native
from ..ops import extractor as ex
from ..utils.config import CameraConfig, OrbConfig
from ..utils.device import default_device, fetch

_frame_ids = itertools.count()


@dataclasses.dataclass
class Frame:
    frame_id: int
    timestamp: float
    K: np.ndarray                 # [3,3]
    xy: np.ndarray                # [N,2] undistorted level-0 coords
    xy_raw: np.ndarray            # [N,2] distorted (as detected)
    octave: np.ndarray            # [N] i32
    angle: np.ndarray             # [N] f32 deg
    response: np.ndarray          # [N]
    desc: np.ndarray              # [N,8] u32
    valid: np.ndarray             # [N] bool
    hw: tuple[int, int]
    pose_cw: np.ndarray | None = None      # [4,4]
    mp: np.ndarray | None = None           # [N] i32 map-point slot or -1
    words: np.ndarray | None = None        # [N] BoW word ids
    nodes: np.ndarray | None = None        # [N] BoW grouping node ids
    sigma2: np.ndarray | None = None       # [N] per-kp scale sigma^2
    kp_depth: np.ndarray | None = None     # [N] metric depth (<=0 invalid)
    # deferred device->host feature transfer: steady-state fused frames
    # only need (pose, match_mp) on host — the feature arrays stay on
    # device unless a keyframe decision / staged fallback needs them
    # (callable returning (xy_raw, xy, octave, angle, response, desc, valid))
    lazy_feats: object = None
    scale_factor: float = 1.2

    def __post_init__(self):
        n = len(self.xy)
        if self.mp is None:
            self.mp = np.full(n, -1, np.int32)

    def ensure_features(self):
        """Materialize the feature arrays from the deferred fetch.
        Providers yield 6-tuples (xy, ...) for distortion-free cameras or
        7-tuples (xy_raw, xy_undistorted, ...)."""
        if self.lazy_feats is None:
            return
        vals = self.lazy_feats()
        if len(vals) == 7:
            xy_raw, xy, octv, ang, resp, desc, valid = vals
            self.xy_raw = np.asarray(xy_raw)
            self.xy = np.asarray(xy)
        else:
            xy, octv, ang, resp, desc, valid = vals
            self.xy = self.xy_raw = np.asarray(xy)
        self.octave = np.asarray(octv)
        self.angle = np.asarray(ang)
        self.response = np.asarray(resp)
        self.desc = np.asarray(desc)
        self.valid = np.asarray(valid)
        self.sigma2 = (self.scale_factor
                       ** (2.0 * self.octave)).astype(np.float32)
        self.lazy_feats = None

    @property
    def n(self) -> int:
        return len(self.xy)

    def center(self) -> np.ndarray:
        T = self.pose_cw
        return -T[:3, :3].T @ T[:3, 3]

    def compute_bow(self, vocab) -> None:
        if self.words is None:
            w, nd = vocab.transform_np(self.desc)
            self.words = np.where(self.valid, w.astype(np.int32), -1)
            self.nodes = np.where(self.valid, nd.astype(np.int32), -1)


def _octree_refine(
    xy: np.ndarray, resp: np.ndarray, octave: np.ndarray,
    valid: np.ndarray, budgets: list[int],
) -> np.ndarray:
    """Per-level exact quadtree keep-mask over detected keypoints."""
    keep = np.ones(len(xy), bool)
    for lvl, budget in enumerate(budgets):
        sel = np.where(valid & (octave == lvl))[0]
        if len(sel) <= budget or len(sel) == 0:
            continue
        xs, ys = xy[sel, 0], xy[sel, 1]
        k = native.distribute_octree(
            xs, ys, resp[sel],
            (xs.min(), ys.min(), xs.max() + 1e-3, ys.max() + 1e-3), budget,
        )
        keep[sel[~k]] = False
    return keep


def build_frame(
    image: np.ndarray,
    timestamp: float,
    cam: CameraConfig,
    orb: OrbConfig,
    n_features: int | None = None,
    depth_image: np.ndarray | None = None,
    features: ex.FrameFeatures | None = None,
    device: torch.device | str | None = None,
) -> Frame:
    """Assemble a Frame; runs the front end on `device` (by default the
    card) unless precomputed `features` (tensors) are supplied."""
    nf = n_features or orb.n_features
    feats = features
    if feats is None:
        device = default_device() if device is None else device
        feats = ex.extract_orb(
            torch.from_numpy(np.ascontiguousarray(image)).to(device),
            n_features=nf,
            n_levels=orb.n_levels,
            scale=orb.scale_factor,
            th_high=float(orb.ini_th_fast),
            th_low=float(orb.min_th_fast),
        )
    # ONE batched device->host transfer for the whole feature set
    if np.any(cam.dist[:4] != 0):
        dev = feats.xy.device
        xy_dev = ex.undistort_points(feats.xy, torch.from_numpy(cam.K).to(dev),
                                     torch.from_numpy(cam.dist).to(dev))
        xy_raw, xy, octave, angle_, resp_, desc_, valid_ = fetch(
            feats.xy, xy_dev, feats.octave, feats.angle, feats.response,
            feats.desc, feats.valid,
        )
    else:
        xy_raw, octave, angle_, resp_, desc_, valid_ = fetch(
            feats.xy, feats.octave, feats.angle, feats.response,
            feats.desc, feats.valid,
        )
        xy = xy_raw
    desc_ = desc_.view(np.uint32)
    if features is None and getattr(orb, "exact_octree", True):
        # exact quadtree redistribution on the host (reference:
        # ORBextractor::DistributeOctTree, ORBextractor.cc:465) — the
        # device program spreads keypoints with a per-cell-max bonus; on
        # the staged path (initialization, relocalization) we refine that
        # to the reference's exact per-level budgeting via the native
        # C++ quadtree (csrc/octree.cc).
        valid_ = valid_ & _octree_refine(
            xy_raw, resp_, octave, valid_,
            ex.level_budgets(nf, orb.n_levels, orb.scale_factor),
        )
    sig2 = ex.scale_sigma2(orb.n_levels, orb.scale_factor)[octave]
    kp_depth = None
    if depth_image is not None:
        h, w = depth_image.shape
        xs = np.clip(np.round(xy_raw[:, 0]).astype(int), 0, w - 1)
        ys = np.clip(np.round(xy_raw[:, 1]).astype(int), 0, h - 1)
        d = depth_image[ys, xs].astype(np.float32)
        kp_depth = np.where(np.isfinite(d) & (d > 0), d, -1.0).astype(np.float32)
    return Frame(
        frame_id=next(_frame_ids),
        timestamp=timestamp,
        K=cam.K.copy(),
        xy=np.asarray(xy),
        xy_raw=np.asarray(xy_raw),
        octave=np.asarray(octave),
        angle=np.asarray(angle_),
        response=np.asarray(resp_),
        desc=np.asarray(desc_),
        valid=np.asarray(valid_),
        hw=image.shape[:2],
        sigma2=sig2,
        kp_depth=kp_depth,
    )
