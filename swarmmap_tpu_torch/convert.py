"""numpy <-> tensor conversion of the records both packages share.

The JAX package's records (`TrackInputs`, `TrackOutputs`, `FrameFeatures`,
`PoseOptResult`), taken as numpy arrays (`np.asarray` of each field),
become this package's tensors and back, so a test can feed the same state
to both and compare field by field in numpy.  Descriptor words are uint32
in the JAX package and int32 here, holding the same bits.
"""
from __future__ import annotations

import numpy as np
import torch

from .ops.extractor import FrameFeatures
from .ops.pose_opt import PoseOptResult
from .pipeline import TrackInputs, TrackOutputs
from .utils.device import default_device


def to_tensor(x, device: torch.device | str | None = None) -> torch.Tensor:
    """numpy array -> tensor on `device` (by default the card); uint32
    becomes an int32 view."""
    device = default_device() if device is None else device
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a)).to(device)  # a writable copy


def to_numpy(t: torch.Tensor, uint32: bool = False) -> np.ndarray:
    """tensor -> numpy; with uint32, an int32 tensor comes back as a uint32
    view (descriptor words)."""
    a = t.detach().cpu().numpy()
    return a.view(np.uint32) if uint32 else a


def track_inputs_from_numpy(inp, device: torch.device | str | None = None) -> TrackInputs:
    """The JAX package's TrackInputs (any array-likes, batched or not) ->
    this package's TrackInputs on `device` (by default the card)."""
    return TrackInputs(*(to_tensor(getattr(inp, f), device) for f in TrackInputs._fields))


def frame_features_to_numpy(f: FrameFeatures) -> FrameFeatures:
    return FrameFeatures(
        xy=to_numpy(f.xy), response=to_numpy(f.response), octave=to_numpy(f.octave),
        angle=to_numpy(f.angle), desc=to_numpy(f.desc, uint32=True),
        valid=to_numpy(f.valid),
    )


def track_outputs_to_numpy(out: TrackOutputs) -> TrackOutputs:
    return TrackOutputs(
        Tcw=to_numpy(out.Tcw), n_inliers=to_numpy(out.n_inliers),
        match_mp=to_numpy(out.match_mp),
        features=frame_features_to_numpy(out.features), xy_ud=to_numpy(out.xy_ud),
    )


def pose_result_to_numpy(res: PoseOptResult) -> PoseOptResult:
    return PoseOptResult(*(to_numpy(x) for x in res))
