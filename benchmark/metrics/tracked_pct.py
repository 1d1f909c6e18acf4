"""tracked_pct (%): agent frames of the window whose pose has at least the
configuration's min_tracked_inliers inliers (ORB-SLAM2's TrackLocalMap
bar), in % of all agent frames."""


def read(ctx):
    w = ctx.window
    return 100.0 * w.tracked_frames / w.frames if w.frames else None
