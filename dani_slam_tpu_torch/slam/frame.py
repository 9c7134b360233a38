"""Frame construction: image(s) -> fixed-size feature set (counterpart of
dani_slam_tpu/slam/frame.py): the RGB-D, monocular (single- and
multi-level), rectified-stereo and fisheye-stereo constructors, and the
stereo depth they use."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from dani_slam_tpu_torch.core import cameras as _cam
from dani_slam_tpu_torch.models import lightglue as lg
from dani_slam_tpu_torch.models import superpoint
from dani_slam_tpu_torch.ops import frontend, image as image_ops
from dani_slam_tpu_torch.ops import matching as m_ops
from dani_slam_tpu_torch.ops import stats


class FrameFeatures(NamedTuple):
    """Fixed-size per-frame features (padded to N slots)."""
    xy: torch.Tensor       # [N,2] undistorted pixel coords
    desc: torch.Tensor     # [N,D] unit descriptors
    depth: torch.Tensor    # [N] metric depth (inf = no reading)
    valid: torch.Tensor    # [N] bool
    time: torch.Tensor     # [] f32 timestamp (seconds)
    octave: Optional[torch.Tensor] = None   # [N] int8 (None = level 0)

    @property
    def n(self):
        return self.xy.shape[0]

    def octave_or_zeros(self) -> torch.Tensor:
        if self.octave is None:
            return torch.zeros((self.xy.shape[0],), dtype=torch.int8,
                               device=self.xy.device)
        return self.octave


def _frame_rgbd_program(sp_model, img, depth_img, cam, time, depth_factor,
                        threshold, boxes=None, box_mask=None,
                        n_max: int = 1024) -> FrameFeatures:
    """The RGB-D frontend: grayscale -> SuperPoint -> NMS/top-k select ->
    (dynamic-box suppression) -> descriptor sampling -> depth gather ->
    undistortion. img (H,W,3) uint8, depth_img (H,W) uint16-valued."""
    g = image_ops.to_gray01(img)
    heat, dm = superpoint.apply(sp_model, g)
    out = frontend.extract(heat, dm, n_max=n_max, threshold=threshold,
                           boxes=boxes, box_mask=box_mask)
    dmap = image_ops.depth_from_encoded(depth_img, depth_factor)
    xi = torch.clamp(out["xy"][:, 0].long(), 0, dmap.shape[1] - 1)
    yi = torch.clamp(out["xy"][:, 1].long(), 0, dmap.shape[0] - 1)
    xy = _cam.undistort_keypoints(cam, out["xy"])
    return FrameFeatures(xy=xy, desc=out["desc"], depth=dmap[yi, xi],
                         valid=out["valid"], time=time)


def build_frame_rgbd(sp_model, img, depth_img, cam: _cam.Camera, time: float,
                     depth_factor: float = 5000.0, n_max: int = 1024,
                     threshold: float = 0.007, boxes=None,
                     box_mask=None) -> FrameFeatures:
    """RGB-D frame: depth sampled at keypoint locations (reference:
    Frame::ComputeStereoFromRGBD; metric depth kept directly)."""
    return _frame_rgbd_program(sp_model, img, depth_img, cam,
                               _time(time, cam.device),
                               depth_factor, threshold, boxes, box_mask,
                               n_max=n_max)


def _time(time, device) -> torch.Tensor:
    return torch.full((), time, dtype=torch.float32, device=device)


def build_frame_mono(sp_model, img, cam: _cam.Camera, time: float,
                     n_max: int = 1024, threshold: float = 0.007,
                     boxes=None, box_mask=None, n_levels: int = 1,
                     scale_factor: float = 1.2) -> FrameFeatures:
    """Monocular frame: gray -> SuperPoint -> select -> undistort; depth is
    inf. n_levels > 1 runs the multi-level pyramid with per-level budgets
    and sets the keypoints' octaves (reference: the mono Frame constructor
    with SPextractor's ComputePyramid)."""
    g = image_ops.to_gray01(img)
    if n_levels > 1:
        out = frontend.extract_multiscale(
            sp_model, g, n_max=n_max, n_levels=n_levels,
            scale_factor=scale_factor, threshold=threshold)
        valid = out["valid"]
        if boxes is not None:
            valid = frontend.suppress_in_boxes(out["xy"], valid, boxes,
                                               box_mask)
        octave = out["octave"]
    else:
        heat, dm = superpoint.apply(sp_model, g)
        out = frontend.extract(heat, dm, n_max=n_max, threshold=threshold,
                               boxes=boxes, box_mask=box_mask)
        valid, octave = out["valid"], None
    xy = _cam.undistort_keypoints(cam, out["xy"])
    return FrameFeatures(xy=xy, desc=out["desc"],
                         depth=torch.full((xy.shape[0],), float("inf"),
                                          device=xy.device),
                         valid=valid, time=_time(time, xy.device),
                         octave=octave)


def _median_trim(m, depth):
    """The stereo outlier trim: matches with a descriptor distance above
    1.5x the median are dropped. The median is the reference's jnp.median
    over the accepted rows with NaN in the others: it is NaN, and the trim
    off (a limit of 1.5e9), unless every row was matched."""
    med = stats.median(torch.where(m.ok, m.dist,
                                   torch.full_like(m.dist, float("nan"))))
    med = torch.nan_to_num(med, nan=1e9)
    keep = m.ok & (m.dist <= 1.5 * med + 1e-6)
    return torch.where(keep, depth, torch.full_like(depth, float("inf")))


def stereo_match_depth(xy_l, desc_l, valid_l, xy_r, desc_r, valid_r, fx,
                       baseline, y_band: float = 2.0, th_desc: float = 0.7):
    """Left <-> right descriptor matching on a rectified pair -> depth per
    left keypoint (inf where unmatched): mutual nearest neighbour within an
    epipolar row band and positive disparity, then the median trim
    (reference: Frame::ComputeStereoMatches)."""
    d = m_ops.desc_distance_matrix(desc_l, desc_r)
    band = torch.abs(xy_l[:, None, 1] - xy_r[None, :, 1]) <= y_band
    disp_ok = (xy_l[:, None, 0] - xy_r[None, :, 0]) > 0.1
    mask = band & disp_ok & valid_l[:, None] & valid_r[None, :]
    m = m_ops.masked_match(d, mask, th=th_desc, mutual=True)
    disp = xy_l[:, 0] - xy_r[m.idx, 0]
    return _median_trim(m, fx * baseline / torch.clamp(disp, min=1e-6))


def stereo_match_depth_lightglue(matcher, xy_l, desc_l, valid_l, xy_r,
                                 desc_r, valid_r, fx, baseline,
                                 y_band: float = 4.0):
    """Stereo depth through the LightGlue matcher (the reference's
    ComputeStereoMatches matcher) with the rectified-geometry gates of the
    descriptor variant (row band, positive disparity)."""
    idx, _, ok = lg.match(matcher, xy_l, desc_l, valid_l, xy_r, desc_r,
                          valid_r)
    idx = idx.long()
    disp = xy_l[:, 0] - xy_r[idx, 0]
    band = torch.abs(xy_l[:, 1] - xy_r[idx, 1]) <= y_band
    keep = ok & band & (disp > 0.1)
    return torch.where(keep, fx * baseline / torch.clamp(disp, min=1e-6),
                       torch.full_like(disp, float("inf")))


def _extract_pair(sp_model, img_l, img_r, n_max, threshold):
    """Both images through SuperPoint as one batch of two, then keypoint
    selection per image."""
    g = torch.stack([image_ops.to_gray01(img_l), image_ops.to_gray01(img_r)])
    with torch.no_grad():
        heat, dm = sp_model(g[:, None])
    return (frontend.extract(heat[0], dm[0], n_max=n_max,
                             threshold=threshold),
            frontend.extract(heat[1], dm[1], n_max=n_max,
                             threshold=threshold))


def build_frame_stereo(sp_model, img_l, img_r, cam: _cam.Camera,
                       baseline: float, time: float, n_max: int = 1024,
                       threshold: float = 0.007,
                       matcher=None) -> FrameFeatures:
    """Rectified stereo frame: SuperPoint on both images as one batch, then
    stereo matching (LightGlue when a matcher is given, descriptor mutual
    NN otherwise) fills metric depth at the left keypoints."""
    out_l, out_r = _extract_pair(sp_model, img_l, img_r, n_max, threshold)
    args = (out_l["xy"], out_l["desc"], out_l["valid"], out_r["xy"],
            out_r["desc"], out_r["valid"], cam.params[0], baseline)
    if matcher is not None:
        depth = stereo_match_depth_lightglue(matcher, *args)
    else:
        depth = stereo_match_depth(*args)
    xy = _cam.undistort_keypoints(cam, out_l["xy"])
    return FrameFeatures(xy=xy, desc=out_l["desc"], depth=depth,
                         valid=out_l["valid"], time=_time(time, xy.device))


def stereo_fisheye_depth(cam_l: _cam.Camera, cam_r: _cam.Camera, xy_l,
                         desc_l, valid_l, xy_r, desc_r, valid_r, R_rl, t_rl,
                         lapping_l=(0, 1e9), lapping_r=(0, 1e9),
                         th_desc: float = 0.7, reproj_px: float = 2.0,
                         min_parallax_cos: float = 0.9998):
    """Unrectified (fisheye) stereo depth: mutual-NN descriptor matching
    inside the lapping areas, two-view ray triangulation, reprojection and
    parallax gates (reference: Frame::ComputeStereoFishEyeMatches with
    KannalaBrandt8::TriangulateMatches). (R_rl, t_rl) maps left-camera
    coordinates to the right camera. Returns depth [N] in the left camera
    (inf where unmatched or rejected)."""
    in_l = (xy_l[:, 0] >= lapping_l[0]) & (xy_l[:, 0] <= lapping_l[1])
    in_r = (xy_r[:, 0] >= lapping_r[0]) & (xy_r[:, 0] <= lapping_r[1])
    d = m_ops.desc_distance_matrix(desc_l, desc_r)
    mask = (valid_l & in_l)[:, None] & (valid_r & in_r)[None, :]
    m = m_ops.masked_match(d, mask, th=th_desc, mutual=True)
    r_l = _cam.unproject(cam_l, xy_l)
    r_r = _cam.unproject(cam_r, xy_r)[m.idx]
    X_l = _cam.triangulate_two_view(r_l, r_r, R_rl, t_rl)
    X_r = torch.einsum('ij,nj->ni', R_rl, X_l) + t_rl
    e_l = _cam.project(cam_l, X_l) - xy_l
    e_r = _cam.project(cam_r, X_r) - xy_r[m.idx]
    ok_rep = ((torch.sum(e_l * e_l, -1) < reproj_px ** 2) &
              (torch.sum(e_r * e_r, -1) < reproj_px ** 2))
    r_r_in_l = torch.einsum('ji,nj->ni', R_rl, r_r)
    cosp = torch.einsum('ni,ni->n', r_l, r_r_in_l) / torch.clamp(
        torch.linalg.norm(r_l, dim=-1) * torch.linalg.norm(r_r_in_l, dim=-1),
        min=1e-9)
    good = (m.ok & (X_l[:, 2] > 0) & (X_r[:, 2] > 0) & ok_rep &
            (cosp < min_parallax_cos))
    return torch.where(good, X_l[:, 2], torch.full_like(X_l[:, 2],
                                                        float("inf")))


def build_frame_stereo_fisheye(sp_model, img_l, img_r, cam_l: _cam.Camera,
                               cam_r: _cam.Camera, R_rl, t_rl, time: float,
                               lapping_l=(0, 1e9), lapping_r=(0, 1e9),
                               n_max: int = 1024,
                               threshold: float = 0.007) -> FrameFeatures:
    """Fisheye (KB8) stereo frame without rectification: SuperPoint on both
    images as one batch, lapping-area matching and ray triangulation for
    metric depth; the keypoints enter the SLAM layer undistorted."""
    out_l, out_r = _extract_pair(sp_model, img_l, img_r, n_max, threshold)
    depth = stereo_fisheye_depth(
        cam_l, cam_r, out_l["xy"], out_l["desc"], out_l["valid"],
        out_r["xy"], out_r["desc"], out_r["valid"], R_rl, t_rl, lapping_l,
        lapping_r)
    xy = _cam.undistort_keypoints(cam_l, out_l["xy"])
    return FrameFeatures(xy=xy, desc=out_l["desc"], depth=depth,
                         valid=out_l["valid"], time=_time(time, xy.device))
