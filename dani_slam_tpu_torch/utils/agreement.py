"""The monocular and stereo functions on a device against the CPU, on the
same inputs and to the same limits wherever they are checked (the card-only
tests and chip_smoke.py). Each returns its measurements and `ok`."""
from __future__ import annotations

import numpy as np
import torch

from dani_slam_tpu_torch.utils import synthetic


def two_view_init(device) -> dict:
    """ops/twoview.two_view_init on synthetic.two_view_rays (300 matches,
    60 corrupted, injected draws): the same decision on both devices, R
    within 1e-4, unit t within 1e-3, inlier counts within 3, and the CPU's
    R within 2e-2 of the truth."""
    from dani_slam_tpu_torch.ops import twoview
    r1, r2, R, _, idx = synthetic.two_view_rays()
    out = {}
    for d in ("cpu", str(device)):
        res = twoview.two_view_init(
            tuple(torch.as_tensor(i, device=d) for i in idx),
            torch.as_tensor(r1, device=d), torch.as_tensor(r2, device=d),
            torch.ones(len(r1), dtype=torch.bool, device=d), 520.0)
        out[d] = [x.cpu().numpy() for x in res]
    c, g = out["cpu"], out[str(device)]
    r = dict(decided=(bool(g[5]), bool(c[5])),
             homography=(bool(g[6]), bool(c[6])),
             inliers=(int(g[4]), int(c[4])),
             R_diff=float(np.abs(g[0] - c[0]).max()),
             t_diff=float(np.abs(g[1] - c[1]).max()),
             R_err_cpu=float(np.abs(c[0] - R).max()))
    r["ok"] = (all(r["decided"]) and r["homography"][0] == r["homography"][1]
               and r["R_diff"] < 1e-4 and r["t_diff"] < 1e-3
               and r["R_err_cpu"] < 2e-2
               and abs(r["inliers"][0] - r["inliers"][1]) <= 3)
    return r


def stereo_depth(device, baseline: float = 0.12) -> dict:
    """slam/frame.stereo_match_depth and its LightGlue variant on one
    rendered 640x480 rectified pair's SuperPoint keypoints (extracted on
    the CPU): the same depth set, > 100 depths, within 1e-5 relative; the
    LightGlue variant (bf16 layers that round on other units) the same
    finite set on >= 97 % of the valid rows and equal within 1e-5 on >= 97
    % of the depths both found."""
    from dani_slam_tpu_torch.models import lightglue, superpoint
    from dani_slam_tpu_torch.ops import frontend, image
    from dani_slam_tpu_torch.slam import frame
    R, t = synthetic.orbit_trajectory(2, radius=10.0, angle_span=0.01)
    left, right, _ = synthetic.make_stereo_image_sequence(
        [500.0, 500.0, 320.0, 240.0], 640, 480, R[:1], t[:1],
        baseline=baseline)
    sp = superpoint.load_default_params("cpu")
    outs = [frontend.extract(*superpoint.apply(sp, image.to_gray01(
        torch.as_tensor(im))), n_max=1024) for im in (left[0], right[0])]
    args = [o[k] for o in outs for k in ("xy", "desc", "valid")]
    res = {}
    for d in ("cpu", str(device)):
        a = [x.to(d) for x in args]
        res[d] = (frame.stereo_match_depth(*a, 500.0, baseline).cpu().numpy(),
                  frame.stereo_match_depth_lightglue(
                      lightglue.load_default_matcher(640, 480, device=d), *a,
                      500.0, baseline).cpu().numpy())
    (dc, lc), (dg, lg) = res["cpu"], res[str(device)]
    ok = np.isfinite(dc)
    valid = args[2].numpy()
    both = np.isfinite(lg) & np.isfinite(lc)
    r = dict(depths=int(ok.sum()),
             same_set=bool(np.array_equal(np.isfinite(dg), ok)),
             max_rel=float(np.max(np.abs(dg[ok] - dc[ok]) / dc[ok]))
             if ok.any() else 0.0,
             lg_depths=int(both.sum()),
             lg_same_rows=float((np.isfinite(lg) == np.isfinite(lc))[valid]
                                .mean()),
             lg_equal=float(np.isclose(lg[both], lc[both], rtol=1e-5).mean())
             if both.any() else 0.0)
    r["ok"] = (r["same_set"] and r["depths"] > 100 and r["max_rel"] < 1e-5
               and r["lg_same_rows"] >= 0.97 and r["lg_equal"] >= 0.97)
    return r
