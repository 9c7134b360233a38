"""The reference-scale nets in the port (models/lightglue_official.py,
models/yolo_official.py, superpoint.load_magicleap_pt) against the JAX
package's, on the CPU: the shipped official weights
(dani_slam_tpu/weights/{lightglue,yolo}_official_synthetic.npz) at full
width, and public-layout state dicts that the tests write themselves (the
public checkpoints are not in the repository).

Tolerances. In float32 both frameworks compute the same graph: LightGlue log
scores within 2e-3 over 9 layers, YOLO head maps within 1e-3 + 1e-3 |x|
(the oracle of the public forward, a plain-f32 torch evaluation of the
state dict, within the same). In the working bf16 each framework rounds at
its own places, and 9 layers (LightGlue) or 60 convolutions (yolov5s)
compound it: assignment probabilities within 0.03 and matchability logits
within 0.25 (tests/test_torch_lightglue.py holds the 6-layer compact net to
0.03 and 0.15), match sets differing only on near-ties, YOLO heads within
0.1 + 3 % (a bf16 step is 0.4 % of the value; the heads reach 24) and 0.02
on average, the mask program's boxes within 4 px and its area ratio within
0.01.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dani_slam_tpu.models import lightglue as jlg
from dani_slam_tpu.models import lightglue_official as jlo
from dani_slam_tpu.models import superpoint as jsp
from dani_slam_tpu.models import yolo_official as jyo
from dani_slam_tpu_torch.models import lightglue as tlg
from dani_slam_tpu_torch.models import lightglue_official as tlo
from dani_slam_tpu_torch.models import superpoint as tsp
from dani_slam_tpu_torch.models import yolo_official as tyo
from dani_slam_tpu_torch.utils import synthetic

from test_torch_lightglue import SCORE_TOL, _assert_match_sets_agree, \
    make_pair

torch.set_num_threads(2)       # several test workers share the machine

W, H = 640, 480
T = torch.as_tensor


# ---------------------------------------------------------------------------
# Official LightGlue (256 x 9)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def official_matchers():
    return jlo.load_official_matcher(W, H), \
        tlo.load_official_matcher(W, H, device="cpu")


def _pairs():
    """Two pairs of 96 keypoints with ragged masks (valid prefixes 90 / 80
    and 64 / 96)."""
    xy0, d0, m0, xy1, d1, m1 = make_pair(96, 90, 80, 3, batch=2)
    m0[1], m1[1] = np.arange(96) < 64, True
    return xy0, d0, m0, xy1, d1, m1


def _forward_jax(model, params, xy0, d0, m0, xy1, d1, m1):
    out = model.apply(params, jlg.normalize_keypoints(jnp.asarray(xy0), W, H),
                      jlg.normalize_keypoints(jnp.asarray(xy1), W, H),
                      jnp.asarray(d0), jnp.asarray(d1), jnp.asarray(m0),
                      jnp.asarray(m1))
    return [np.asarray(x) for x in out]


def _forward_torch(model, xy0, d0, m0, xy1, d1, m1):
    with torch.no_grad():
        out = model(tlg.normalize_keypoints(T(xy0), W, H),
                    tlg.normalize_keypoints(T(xy1), W, H), T(d0), T(d1),
                    T(m0), T(m1))
    return [x.numpy() for x in out]


def test_official_lightglue_f32_matches_flax(official_matchers):
    """The shipped 256 x 9 weights through both graphs in float32: the
    converter and every layer agree."""
    jm, tm = official_matchers
    args = _pairs()
    jmodel = jlo.LightGlueOfficial(compute_dtype=jnp.float32)
    tmodel = copy.deepcopy(tm.model)
    for blk in (*tmodel.self_blocks, *tmodel.cross_blocks):
        blk.dt = blk.ffn.dt = torch.float32
    sj, z0j, z1j = _forward_jax(jmodel, jm.params, *args)
    st, z0t, z1t = _forward_torch(tmodel, *args)
    valid = args[2][:, :, None] & args[5][:, None, :]
    assert st.shape == sj.shape == (2, 96, 96)
    assert np.abs(st - sj)[valid].max() < 2e-3
    np.testing.assert_allclose(z0t, z0j, atol=2e-3)
    np.testing.assert_allclose(z1t, z1j, atol=2e-3)


def test_official_lightglue_bf16_matches_flax(official_matchers):
    """Production precision (bf16 dense layers): probabilities, logits and
    the mutual match sets of match_pairs."""
    jm, tm = official_matchers
    assert isinstance(tm.model, tlo.LightGlueOfficial)
    assert (tm.model.dim, tm.model.depth, tm.model.heads) == (256, 9, 4)
    assert sum(p.numel() for p in tm.model.parameters()) > 11_000_000
    args = _pairs()
    sj, z0j, z1j = _forward_jax(jm.model, jm.params, *args)
    st, z0t, z1t = _forward_torch(tm.model, *args)
    assert np.isfinite(st).all()
    assert np.abs(np.exp(st) - np.exp(sj)).max() < SCORE_TOL
    for zt, zj, m in ((z0t, z0j, args[2]), (z1t, z1j, args[5])):
        assert np.abs(zt - zj)[m].max() < 0.25
    out_j = jlg.match_pairs(jm.model, jm.params,
                            *(jnp.asarray(a) for a in args), W, H)
    before = tlg.FORWARDS.count
    out_t = tlg.match_pairs(tm.model, *(T(a) for a in args), W, H)
    assert tlg.FORWARDS.count == before + 1
    _assert_match_sets_agree(out_t, out_j, np.exp(sj))
    assert int(out_t[2].sum()) > 0.25 * (80 + 64)


def test_official_matcher_memoized_per_device(official_matchers):
    _, tm = official_matchers
    again = tlo.load_official_matcher(320, 240, device="cpu")
    assert again.model is tm.model and (again.width, again.height) == \
        (320, 240)
    assert not any(p.requires_grad for p in tm.model.parameters())


def random_public_lightglue(dim=64, depth=3, heads=4, input_dim=256,
                            seed=0, prefix=""):
    """A public-LightGlue-layout state dict (transformers.{i}.self_attn /
    cross_attn, posenc.Wr, log_assignment.{i}) of torch tensors, weights
    scaled by 1/sqrt(fan_in) so activations stay of order 1."""
    g = torch.Generator().manual_seed(seed)

    def lin(name, o, i, sd):
        sd[f"{prefix}{name}.weight"] = torch.randn(o, i, generator=g) / i ** .5
        sd[f"{prefix}{name}.bias"] = 0.1 * torch.randn(o, generator=g)

    sd = {}
    lin("input_proj", dim, input_dim, sd)
    sd[f"{prefix}posenc.Wr.weight"] = torch.randn(dim // heads // 2, 2,
                                                  generator=g)
    for i in range(depth):
        t = f"transformers.{i}"
        lin(f"{t}.self_attn.Wqkv", 3 * dim, dim, sd)
        lin(f"{t}.self_attn.out_proj", dim, dim, sd)
        for kind in ("self_attn", "cross_attn"):
            lin(f"{t}.{kind}.ffn.0", 2 * dim, 2 * dim, sd)
            sd[f"{prefix}{t}.{kind}.ffn.1.weight"] = \
                1 + 0.1 * torch.randn(2 * dim, generator=g)
            sd[f"{prefix}{t}.{kind}.ffn.1.bias"] = \
                0.1 * torch.randn(2 * dim, generator=g)
            lin(f"{t}.{kind}.ffn.3", dim, 2 * dim, sd)
        for name in ("to_qk", "to_v", "to_out"):
            lin(f"{t}.cross_attn.{name}", dim, dim, sd)
        lin(f"log_assignment.{i}.final_proj", dim, dim, sd)
        lin(f"log_assignment.{i}.matchability", 1, dim, sd)
    return sd


def reference_forward_torch(sd, xy0n, xy1n, d0, d1):
    """The public official forward evaluated from the state dict in plain
    f32 torch, one pair, no masks (a copy of the JAX package's converter
    oracle, dani_slam_tpu/models/lightglue_official.py:307). Its LayerNorm
    is torch's, eps 1e-5, as in the public graph; the JAX module and the
    port take Flax's 1e-6, which moves a normalized value by ~5e-6
    relative."""
    import torch.nn.functional as F
    sd = tlo._normalize_keys(sd)
    depth = 1 + max(int(k.split(".")[1]) for k in sd
                    if k.startswith("transformers."))
    dim = sd["input_proj.weight"].shape[0]
    heads = dim // (2 * sd["posenc.Wr.weight"].shape[0])
    hd = dim // heads

    def lin(x, p):
        return F.linear(x, sd[p + ".weight"], sd.get(p + ".bias"))

    def rot(t, ang):
        c, s = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        t1, t2 = t[..., 0::2], t[..., 1::2]
        return torch.stack([t1 * c - t2 * s, t1 * s + t2 * c],
                           dim=-1).flatten(-2)

    def ffn(x, m, t, kind):
        y = lin(torch.cat([x, m], -1), f"{t}.{kind}.ffn.0")
        y = F.layer_norm(y, (y.shape[-1],), sd[f"{t}.{kind}.ffn.1.weight"],
                         sd[f"{t}.{kind}.ffn.1.bias"])
        return x + lin(F.gelu(y), f"{t}.{kind}.ffn.3")

    def self_block(x, ang, t):
        qkv = lin(x, f"{t}.self_attn.Wqkv").unflatten(-1, (heads, hd, 3))
        q, k, v = rot(qkv[..., 0], ang), rot(qkv[..., 1], ang), qkv[..., 2]
        attn = torch.softmax(torch.einsum('qhd,khd->hqk', q, k) / hd ** .5,
                             -1)
        ctx = torch.einsum('hqk,khd->qhd', attn, v).flatten(-2)
        return ffn(x, lin(ctx, f"{t}.self_attn.out_proj"), t, "self_attn")

    def cross_block(x0, x1, t):
        h = lambda v: v.unflatten(-1, (heads, hd))   # noqa: E731
        qk0, qk1 = h(lin(x0, f"{t}.cross_attn.to_qk")), \
            h(lin(x1, f"{t}.cross_attn.to_qk"))
        v0, v1 = h(lin(x0, f"{t}.cross_attn.to_v")), \
            h(lin(x1, f"{t}.cross_attn.to_v"))
        sim = torch.einsum('qhd,khd->hqk', qk0, qk1) / hd ** .5
        m0 = torch.einsum('hqk,khd->qhd', torch.softmax(sim, -1),
                          v1).flatten(-2)
        m1 = torch.einsum('hqk,khd->qhd',
                          torch.softmax(sim.transpose(-1, -2), -1),
                          v0).flatten(-2)
        return (ffn(x0, lin(m0, f"{t}.cross_attn.to_out"), t, "cross_attn"),
                ffn(x1, lin(m1, f"{t}.cross_attn.to_out"), t, "cross_attn"))

    x0, x1 = lin(T(d0), "input_proj"), lin(T(d1), "input_proj")
    ang0 = T(xy0n) @ sd["posenc.Wr.weight"].t()
    ang1 = T(xy1n) @ sd["posenc.Wr.weight"].t()
    for i in range(depth):
        t = f"transformers.{i}"
        x0, x1 = self_block(x0, ang0, t), self_block(x1, ang1, t)
        x0, x1 = cross_block(x0, x1, t)
    last = f"log_assignment.{depth - 1}"
    p0 = lin(x0, f"{last}.final_proj") / dim ** 0.25
    p1 = lin(x1, f"{last}.final_proj") / dim ** 0.25
    sim = p0 @ p1.T
    z0 = lin(x0, f"{last}.matchability")[:, 0]
    z1 = lin(x1, f"{last}.matchability")[:, 0]
    return (F.log_softmax(sim, -1) + F.log_softmax(sim, -2) +
            F.logsigmoid(z0)[:, None] + F.logsigmoid(z1)[None, :]).numpy()


def _one_pair(n=64, seed=4):
    xy0, d0, m0, xy1, d1, m1 = make_pair(n, n, n, seed)
    return [a[0] for a in (xy0, d0, m0, xy1, d1, m1)]


@pytest.mark.parametrize("prefix", ["", "matcher.", "model.matcher."])
def test_public_state_dict_matches_oracle_and_flax(prefix):
    """A public-layout state dict (any wrapper prefix) through the port's
    converter, the JAX converter and the plain-f32 oracle: one graph."""
    sd = random_public_lightglue(seed=1, prefix=prefix)
    xy0, d0, m0, xy1, d1, m1 = _one_pair()
    model = tlo.load_lightglue_state_dict(sd, compute_dtype=torch.float32)
    assert (model.dim, model.depth, model.heads) == (64, 3, 4)
    n0, n1 = tlg.normalize_keypoints(T(xy0), W, H).numpy(), \
        tlg.normalize_keypoints(T(xy1), W, H).numpy()
    ref = reference_forward_torch(sd, n0, n1, d0, d1)
    st = _forward_torch(model, *(a[None] for a in (xy0, d0, m0, xy1, d1,
                                                   m1)))[0][0]
    jmodel, jparams = jlo.load_lightglue_state_dict(
        sd, compute_dtype=jnp.float32)
    sj = _forward_jax(jmodel, jparams, *(a[None] for a in (
        xy0, d0, m0, xy1, d1, m1)))[0][0]
    np.testing.assert_allclose(st, ref, atol=2e-3)
    np.testing.assert_allclose(st, sj, atol=2e-3)


def test_normalize_keys_prefixes():
    sd = {"matcher.input_proj.weight": 1, "model.posenc.Wr.weight": 2,
          "a.b.transformers.0.self_attn.Wqkv.bias": 3,
          "log_assignment.2.final_proj.weight": 4,
          "superglue.token_confidence.0.token.0.weight": 5}
    want = jlo._normalize_keys(sd)
    assert tlo._normalize_keys(sd) == want
    assert set(want) == {"input_proj.weight", "posenc.Wr.weight",
                         "transformers.0.self_attn.Wqkv.bias",
                         "log_assignment.2.final_proj.weight",
                         "token_confidence.0.token.0.weight"}


@pytest.mark.parametrize("wrap", ["plain", "state_dict"])
def test_load_lightglue_pt_file(tmp_path, wrap):
    """A checkpoint file the test writes (a plain state dict, or one under
    'state_dict') through both packages' .pt loaders: the same weights, and
    bf16 forwards whose probabilities agree within SCORE_TOL."""
    sd = random_public_lightglue(dim=64, depth=2, seed=2, prefix="matcher.")
    path = str(tmp_path / "lightglue.pt")
    torch.save(sd if wrap == "plain" else {"state_dict": sd}, path)
    tm = tlo.load_lightglue_pt(path, W, H, device="cpu")
    jm = jlo.load_lightglue_pt(path, W, H)
    assert (tm.width, tm.height) == (W, H) and tm.model.depth == 2
    jp = jm.params["params"]
    np.testing.assert_array_equal(
        tm.model.self_blocks[1].Wqkv.weight.numpy(),
        np.asarray(jp["self1"]["Wqkv"]["kernel"]).T)
    np.testing.assert_array_equal(tm.model.posenc_Wr.detach().numpy(),
                                  np.asarray(jp["posenc_Wr"]))
    args = [a[None] for a in _one_pair(128, 6)]
    sj = _forward_jax(jm.model, jm.params, *args)[0]
    st = _forward_torch(tm.model, *args)[0]
    assert np.abs(np.exp(st) - np.exp(sj)).max() < SCORE_TOL
    idx, score, ok = tlg.match(tm, *(T(a[0]) for a in args))
    assert idx.shape == score.shape == ok.shape == (128,)


# ---------------------------------------------------------------------------
# yolov5s
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def official_detectors():
    return jyo.load_official_detector(), \
        tyo.load_official_detector(device="cpu")


@pytest.fixture(scope="module")
def bench_frames():
    """Frames 0-2 of the bench's 640x480 sequence: textured spots and the
    movable board."""
    R, t = synthetic.orbit_trajectory(3, radius=10.0, angle_span=0.02)
    imgs, _, _ = synthetic.make_rgbd_image_sequence(
        [500.0, 500.0, 320.0, 240.0], 640, 480, R, t, seed=0)
    return imgs


def test_official_detector_settings(official_detectors):
    jd, td = official_detectors
    assert isinstance(td.model, tyo.YoloV5Net)
    assert td.input_hw == tuple(jd.input_hw) == (384, 512)
    assert td.score_th == jd.score_th == 0.6
    assert td.dyn_ids.tolist() == [0] and td.model.num_classes == 80
    assert td.anchors == tuple(tuple(tuple(a) for a in s)
                               for s in jd.anchors)
    assert sum(p.numel() for p in td.model.parameters()) > 7_000_000
    assert tyo.load_official_detector(device="cpu") is td


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_official_yolo_heads_match_flax(official_detectors, bench_frames,
                                        dtype):
    """Raw head maps of the shipped yolov5s at 384x512 on the bench's
    frame resized as the detector does."""
    jd, td = official_detectors
    from dani_slam_tpu_torch.ops import image as timg
    x = timg.resize_bilinear(T(bench_frames[0]).float() / 255.0, 384, 512)
    jmodel, tmodel = jd.model, td.model
    if dtype == "f32":
        jmodel = jyo.YoloV5Net(num_classes=80, dt=jnp.float32)
        tmodel = copy.deepcopy(td.model)
        tmodel.compute_dtype = torch.float32
    outs_j = jmodel.apply(jd.params, jnp.asarray(x.numpy()))
    with torch.no_grad():
        outs_t = tmodel(x)
    for a, b, hw in zip(outs_t, outs_j, ((48, 64), (24, 32), (12, 16))):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape == hw + (3, 85)
        if dtype == "f32":
            np.testing.assert_allclose(a, b, atol=1e-3, rtol=1e-3)
        else:
            np.testing.assert_allclose(a, b, atol=0.1, rtol=3e-2)
            assert np.mean(np.abs(a - b)) < 0.02


def test_official_mask_program_matches_flax(official_detectors,
                                            bench_frames):
    """Detector.dynamic_mask_inputs (resize, yolov5s, decode, NMS at 0.6,
    refine, area ratio) on the bench's first frames. In float32 the port
    and the JAX package pick the same boxes (within 0.05 px). In bf16 the
    port's boxes lie within 4 px of that float32 answer; the JAX package's
    own bf16 boxes lie up to 7.1 px from it on frame 0, where two anchors'
    boxes nearly tie, so the two bf16 runs are held within 8 px of each
    other."""
    from dani_slam_tpu.models import yolo as jyolo
    jd, td = official_detectors
    jd32 = jyolo.Detector(params=jd.params, model=jyo.YoloV5Net(
        num_classes=80, dt=jnp.float32), input_hw=jd.input_hw,
        dynamic_class_ids=(0,), score_th=0.6)
    td32 = copy.copy(td)
    td32.model = copy.deepcopy(td.model)
    td32.model.compute_dtype = torch.float32
    for img in bench_frames:
        (bj, okj, rj), (b32, ok32, r32) = (
            [np.asarray(x) for x in d.dynamic_mask_inputs(jnp.asarray(img))]
            for d in (jd, jd32))
        (bt, okt, rt), (bt32, okt32, rt32) = (
            [x.numpy() for x in d.dynamic_mask_inputs(T(img))]
            for d in (td, td32))
        assert ok32.sum() >= 1, "the detector should fire on the board"
        np.testing.assert_array_equal(okt32, ok32)
        np.testing.assert_array_equal(okt, okj)
        np.testing.assert_array_equal(okj, ok32)
        np.testing.assert_allclose(bt32[ok32], b32[ok32], atol=0.05)
        assert abs(float(rt32) - float(r32)) < 1e-6
        np.testing.assert_allclose(bt[ok32], b32[ok32], atol=4.0)
        np.testing.assert_allclose(bt[okj], bj[okj], atol=8.0)
        assert abs(float(rt) - float(rj)) < 0.01 and float(rt) > 0.0


def random_yolov5(gw=0.125, gd=0.33, nc=3, seed=0, anchors=True,
                  prefix="model."):
    """An ultralytics-layout yolov5 state dict (conv + BatchNorm per
    layer, the Detect head at model.24) of torch tensors at width gw and
    depth gd, conv weights scaled by 1/sqrt(fan_in) and BN statistics of
    order 1, so activations stay of order 1."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    ref = jyo.YoloV5Net(num_classes=nc, depth_multiple=gd,
                        width_multiple=gw, dt=jnp.float32)
    shapes = jax.eval_shape(ref.init, jax.random.PRNGKey(0),
                            jnp.zeros((64, 64, 3)))["params"]

    def walk(tree, path):
        if "kernel" in tree:
            kh, kw, cin, cout = tree["kernel"].shape
            w = torch.randn(cout, cin, kh, kw, generator=g) / \
                (cin * kh * kw) ** 0.5
            name = path[-1]
            if name.startswith("det"):
                sd[f"{prefix}24.m.{name[3:]}.weight"] = w
                sd[f"{prefix}24.m.{name[3:]}.bias"] = \
                    0.1 * torch.randn(cout, generator=g)
                return
            p = prefix + ".".join(path[:-1])
            sd[p + ".conv.weight"] = w
            sd[p + ".bn.weight"] = 1 + 0.1 * torch.randn(cout, generator=g)
            sd[p + ".bn.bias"] = 0.1 * torch.randn(cout, generator=g)
            sd[p + ".bn.running_mean"] = 0.1 * torch.randn(cout, generator=g)
            sd[p + ".bn.running_var"] = 0.5 + torch.rand(cout, generator=g)
            return
        for k, v in tree.items():
            part = k[1:] if (k[0] == "m" and k[1:].isdigit()) else k
            if path and k[0] == "m" and k[1:].isdigit():
                part = f"m.{k[1:]}"          # C3 bottleneck j -> 'm.j'
            walk(v, path + [part])

    walk(shapes, [])
    if anchors:
        a = np.asarray([[[10, 13], [16, 30], [33, 23]],
                        [[30, 61], [62, 45], [59, 119]],
                        [[116, 90], [156, 198], [373, 326]]], np.float32)
        sd[f"{prefix}24.anchors"] = torch.as_tensor(
            a / np.asarray([8, 16, 32], np.float32)[:, None, None] * 1.5)
    return sd


def test_folded_conv_bn_fold():
    """FoldedConv with fold_bn's weight and bias equals conv + BatchNorm
    (eps 1e-3) + SiLU in eval mode."""
    g = torch.Generator().manual_seed(3)
    conv = torch.nn.Conv2d(8, 16, 3, padding=1, bias=False)
    bn = torch.nn.BatchNorm2d(16, eps=tyo.BN_EPS).eval()
    with torch.no_grad():
        conv.weight.copy_(torch.randn(16, 8, 3, 3, generator=g) / 8)
        bn.weight.copy_(1 + 0.2 * torch.randn(16, generator=g))
        bn.bias.copy_(0.2 * torch.randn(16, generator=g))
        bn.running_mean.copy_(torch.randn(16, generator=g))
        bn.running_var.copy_(0.5 + torch.rand(16, generator=g))
    sd = {"l.conv.weight": conv.weight, "l.bn.weight": bn.weight,
          "l.bn.bias": bn.bias, "l.bn.running_mean": bn.running_mean,
          "l.bn.running_var": bn.running_var}
    w, b = tyo.fold_bn({k: v.detach().numpy() for k, v in sd.items()}, "l")
    fc = tyo.FoldedConv(8, 16, 3)
    fc.conv.load_state_dict({"weight": T(w), "bias": T(b)})
    x = torch.randn(2, 8, 12, 12, generator=g)
    with torch.no_grad():
        np.testing.assert_allclose(fc(x).numpy(),
                                   torch.nn.functional.silu(bn(conv(x)))
                                   .numpy(), atol=1e-5)
    # no BN: the conv's own bias (or none) passes through
    w2, b2 = tyo.fold_bn({"l.conv.weight": w}, "l")
    assert np.array_equal(w2, w) and not b2.any()


def test_yolov5_state_dict_anchors_and_multiples():
    sd = random_yolov5(gw=0.125, gd=0.33, nc=3, prefix="model.model.")
    model, anchors, strides = tyo.load_yolov5_state_dict(sd)
    _, _, anchors_j, strides_j = jyo.load_yolov5_state_dict(sd)
    assert strides == tuple(strides_j) == (8, 16, 32)
    assert anchors == anchors_j
    assert anchors[0][0] == (15.0, 19.5)             # 1.5 x the defaults
    assert model.num_classes == 3 and model.m0.conv.out_channels == 8
    assert len(model.m2.m) == 1 and len(model.m6.m) == 3
    _, anchors_d, _ = tyo.load_yolov5_state_dict(
        random_yolov5(anchors=False))
    assert anchors_d == tuple(tuple(tuple(a) for a in s)
                              for s in jyo.load_yolov5_state_dict(
                                  random_yolov5(anchors=False))[2])


@pytest.mark.parametrize("wrap", ["state_dict", "ultralytics"])
def test_load_yolov5_pt_file(tmp_path, wrap):
    """A checkpoint file the test writes (a plain state dict, or an
    ultralytics dict holding the model) through both packages' .pt
    loaders: equal folded weights, and float32 head maps within 1e-3."""
    sd = random_yolov5(seed=5)
    path = str(tmp_path / "yolov5s.pt")
    if wrap == "ultralytics":
        torch.save({"model": sd, "epoch": 3}, path)
    else:
        torch.save(sd, path)
    td = tyo.load_yolov5_pt(path, input_hw=(64, 96), device="cpu")
    jd = jyo.load_yolov5_pt(path, input_hw=(64, 96))
    assert td.input_hw == (64, 96) and td.score_th == jd.score_th == 0.4
    assert td.anchors == jd.anchors
    jp = jd.params["params"]
    np.testing.assert_allclose(
        td.model.m2.m[0].cv2.conv.weight.detach().numpy(),
        np.asarray(jp["m2"]["m0"]["cv2"]["conv"]["kernel"]).transpose(
            3, 2, 0, 1), rtol=1e-6, atol=1e-7)
    x = np.random.RandomState(1).rand(64, 96, 3).astype(np.float32)
    tmodel = td.model
    tmodel.compute_dtype = torch.float32
    jmodel = jyo.YoloV5Net(num_classes=3, depth_multiple=jd.model
                           .depth_multiple, width_multiple=jd.model
                           .width_multiple, dt=jnp.float32)
    outs_j = jmodel.apply(jd.params, jnp.asarray(x))
    with torch.no_grad():
        outs_t = tmodel(T(x))
    for a, b in zip(outs_t, outs_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-3,
                                   rtol=1e-3)


# ---------------------------------------------------------------------------
# SuperPoint: the MagicLeap checkpoint layout
# ---------------------------------------------------------------------------

def test_load_magicleap_pt_matches_flax(tmp_path):
    """A MagicLeap-layout state dict the test writes through both
    packages' loaders: the same weights, and float32 forwards within
    1e-4."""
    g = torch.Generator().manual_seed(7)
    sd = {}
    for name, cin, cout, k in tsp._LAYERS:
        sd[f"{name}.weight"] = torch.randn(cout, cin, k, k, generator=g) / \
            (cin * k * k) ** 0.5
        sd[f"{name}.bias"] = 0.05 * torch.randn(cout, generator=g)
    path = str(tmp_path / "superpoint_v1.pth")
    torch.save(sd, path)
    model = tsp.load_magicleap_pt(path, device="cpu")
    params = jsp.load_magicleap_pt(path)
    for name, *_ in tsp._LAYERS:
        np.testing.assert_array_equal(
            getattr(model, name).weight.numpy(),
            np.asarray(params["params"][name]["kernel"]).transpose(3, 2, 0, 1))
    g01 = np.random.RandomState(0).rand(64, 96).astype(np.float32)
    hj, dj = jsp.SuperPoint(compute_dtype=jnp.float32).apply(
        params, jnp.asarray(g01)[None, ..., None])
    model.compute_dtype = torch.float32
    ht, dt = tsp.apply(model, T(g01))
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj[0]), atol=1e-4)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj[0]), atol=1e-4)


# ---------------------------------------------------------------------------
# The shipped official weights written in the public layouts: a round trip
# through the .pt loaders (and the files the runner tests pass on the
# command line)
# ---------------------------------------------------------------------------

def lightglue_public_state_dict(model):
    """A LightGlueOfficial's weights in the public cvg/LightGlue layout
    (the last log_assignment head holds final_proj / matchability)."""
    sd = {"posenc.Wr.weight": model.posenc_Wr.detach().T.contiguous()}
    own = {k: v.detach() for k, v in model.state_dict().items()}
    last = f"log_assignment.{model.depth - 1}"
    for k, v in own.items():
        name, _, p = k.rpartition(".")
        if k.startswith("input_proj."):
            sd[k] = v
        elif name in ("final_proj", "matchability"):
            sd[f"{last}.{name}.{p}"] = v
        elif k.startswith(("self_blocks.", "cross_blocks.")):
            blocks, i, rest = k.split(".", 2)
            kind = "self_attn" if blocks == "self_blocks" else "cross_attn"
            rest = rest.replace("ffn.ffn", "ffn.")
            sd[f"transformers.{i}.{kind}.{rest}"] = v
    return sd


def yolov5_public_state_dict(model):
    """A YoloV5Net's weights in the ultralytics layout, BN already folded
    (each conv with its bias, no bn.* entries), the Detect head at
    model.24."""
    sd = {}
    for k, v in model.state_dict().items():
        if k.startswith("det"):
            sd[f"model.24.m.{k[3]}.{k.split('.')[-1]}"] = v.detach()
        else:
            sd["model." + k[1:]] = v.detach()
    return sd


def test_public_layout_round_trip(tmp_path, official_matchers,
                                  official_detectors):
    """The shipped official nets written as public checkpoint files and read
    back by load_lightglue_pt / load_yolov5_pt: the same modules."""
    _, tm = official_matchers
    _, td = official_detectors
    p_lg, p_yo = str(tmp_path / "lightglue.pt"), str(tmp_path / "yolo.pt")
    torch.save(lightglue_public_state_dict(tm.model), p_lg)
    torch.save({"model": yolov5_public_state_dict(td.model)}, p_yo)
    lg = tlo.load_lightglue_pt(p_lg, W, H, device="cpu").model
    yo = tyo.load_yolov5_pt(p_yo, input_hw=(384, 512), device="cpu").model
    for a, b in ((lg, tm.model), (yo, td.model)):
        sa, sb = a.state_dict(), b.state_dict()
        assert sa.keys() == sb.keys()
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
