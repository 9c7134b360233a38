"""The port's training side against the JAX package's, on the CPU at small
sizes (32-64 px images, batch 2, LightGlue depth 2, YOLO width 16, 3
steps): models/superpoint_train, lightglue_train, yolo_train, vocab_train,
models/optim (optax's formulas), the Flax-style initializations, the
reverse weight converter and the lie leftovers.

Tolerances:
  * the numpy generators: bitwise (the same seed, the same arrays);
  * float32 paths (SuperPoint's trainers, YOLO with compute_dtype f32):
    the loss at the same parameters and batch within rtol 1e-5, each
    gradient within 1e-4 of its norm (|g_port - g_jax| / |g_jax|);
  * bf16 paths (LightGlue's dense layers, YOLO's convs, as the JAX modules
    run them): the forward parity tolerances of tests/test_torch_lightglue
    .py (log scores within 1.5, so the match NLL within 1.5 and the loss
    within BF16_LG_LOSS) and tests/test_torch_models.py (detector heads
    within two bf16 steps: the loss within rtol 2e-2); their gradients
    within BF16_GRAD of their norm;
  * the optimizer fed the JAX gradients against optax: 1e-6;
  * the losses of 3 training steps: rtol 1e-3. The first Adam step is
    sign(g) lr, so parameters are never compared after a step (a gradient
    entry at rounding level flips sign between the packages); LightGlue's
    3 steps run on the JAX package's extracted keypoints (a bf16 heat map's
    top-k picks other keypoints on near-ties; the extraction is held on
    its own).
"""
import copy
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dani_slam_tpu.core import lie as jlie
from dani_slam_tpu.models import lightglue as jlg
from dani_slam_tpu.models import lightglue_official as jlgo
from dani_slam_tpu.models import lightglue_train as jlt
from dani_slam_tpu.models import superpoint as jsp
from dani_slam_tpu.models import superpoint_train as jst
from dani_slam_tpu.models import vocab_train as jvt
from dani_slam_tpu.models import yolo as jyolo
from dani_slam_tpu.models import yolo_official as jyo
from dani_slam_tpu.models import yolo_train as jyt
from dani_slam_tpu_torch.core import lie as tlie
from dani_slam_tpu_torch.models import convert
from dani_slam_tpu_torch.models import lightglue as tlg
from dani_slam_tpu_torch.models import lightglue_official as tlgo
from dani_slam_tpu_torch.models import lightglue_train as tlt
from dani_slam_tpu_torch.models import optim
from dani_slam_tpu_torch.models import superpoint as tsp
from dani_slam_tpu_torch.models import superpoint_train as tst
from dani_slam_tpu_torch.models import vocab_train as tvt
from dani_slam_tpu_torch.models import yolo as tyolo
from dani_slam_tpu_torch.models import yolo_official as tyo
from dani_slam_tpu_torch.models import yolo_train as tyt

torch.set_num_threads(2)       # several test workers share the machine

F32_LOSS, F32_GRAD = 1e-5, 1e-4
BF16_LG_LOSS, BF16_YOLO_LOSS, BF16_GRAD = 1.5, 2e-2, 0.1
STEPS_RTOL = 1e-3
SP_HW, SP_NPTS, B = 48, 6, 2
LG_HW, LG_NKP, LG_DIM, LG_DEPTH = 64, 32, 64, 2
YOLO_HW, YOLO_WIDTH = 32, 16


def T(a):
    return torch.as_tensor(np.asarray(a))


def grads_as_flax(model):
    """The gradients of a model's parameters as a Flax tree (the
    converter's layout)."""
    g = copy.deepcopy(model)
    with torch.no_grad():
        for p, q in zip(g.parameters(), model.parameters()):
            p.copy_(q.grad)
    return convert.to_flax(g)["params"]


def grads_rel_err(port_model, jax_grads):
    """|g_port - g_jax| / |g_jax| over all parameters (a leaf whose
    gradient is a sum of cancelling terms has a larger relative error of
    its own)."""
    jflat = {"/".join(str(k.key) for k in kp): np.asarray(v) for kp, v in
             jax.tree_util.tree_flatten_with_path(jax_grads["params"])[0]}
    tflat = {"/".join(kp): v for kp, v in _flatten(grads_as_flax(
        port_model))}
    assert sorted(jflat) == sorted(tflat)
    diff = sum(float(np.sum((tflat[k] - jflat[k]) ** 2)) for k in jflat)
    ref = sum(float(np.sum(jflat[k] ** 2)) for k in jflat)
    return (diff / ref) ** 0.5


def assert_grads_close(port_model, jax_grads, tol):
    err = grads_rel_err(port_model, jax_grads)
    assert err <= tol, err


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def printed_losses(out: str):
    return [float(x) for x in re.findall(r"step \d+: loss ([-0-9.]+)", out)]


# ---------------------------------------------------------------------------
# Generators: bitwise
# ---------------------------------------------------------------------------

GENERATORS = {
    "make_corner_batch": (lambda m, r: m.make_corner_batch(r, 2, 40, 48,
                                                          n_pts=7), "st"),
    "make_textured_batch": (lambda m, r: m.make_textured_batch(r, 2, 40, 48,
                                                              n_pts=9),
                            "st"),
    "sample_homographies_np": (lambda m, r: m.sample_homographies_np(
        r, 3, 40, 48), "st"),
    "cell_labels": (lambda m, r: m.cell_labels(
        *m.make_corner_batch(r, 2, 40, 48)[1:], 40, 48), "st"),
    "v2_batch": (None, "st"),
    "sample_homographies": (lambda m, r: m.sample_homographies(r, 3, 40, 48),
                            "lt"),
    "make_training_batch": (lambda m, r: m.make_training_batch(r, 2, 40,
                                                               48), "lt"),
    "make_detection_batch": (lambda m, r: m.make_detection_batch(r, 2, 64,
                                                                 80), "yt"),
}


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generators_bitwise(name):
    fn, which = GENERATORS[name]
    mods = {"st": (jst, tst), "lt": (jlt, tlt), "yt": (jyt, tyt)}[which]
    outs = []
    for mod in mods:
        rng = np.random.RandomState(7)
        if name == "v2_batch":
            outs.append(_jax_v2_batch(rng, 2) if mod is jst else
                        tst.v2_batch(rng, 2, 2, 40, 48, 6))
        else:
            out = fn(mod, rng)
            outs.append(out if isinstance(out, tuple) else (out,))
    for a, b in zip(*outs):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)


def _jax_v2_batch(rng, i, batch=2, h=40, w=48, n_pts=6):
    """The host part of one step of the JAX package's train_superpoint_v2
    (dani_slam_tpu/models/superpoint_train.py:303-323), verbatim."""
    if i % 3 == 2:
        imgs, xy, valid = jst.make_corner_batch(rng, batch, h, w,
                                                n_pts=n_pts)
    else:
        imgs, xy, valid = jst.make_textured_batch(rng, batch, h, w,
                                                  n_pts=n_pts)
    Hs = jst.sample_homographies_np(rng, batch, h, w)
    xy1 = np.einsum('bij,bnj->bni', Hs, np.concatenate(
        [xy, np.ones_like(xy[..., :1])], -1))
    xy1 = xy1[..., :2] / np.maximum(np.abs(xy1[..., 2:]), 1e-9) * \
        np.sign(xy1[..., 2:])
    in1 = ((xy1[..., 0] > 8) & (xy1[..., 0] < w - 9) &
           (xy1[..., 1] > 8) & (xy1[..., 1] < h - 9))
    pvalid = valid & in1
    labels0 = jst.cell_labels(xy, valid, h, w)
    labels1 = jst.cell_labels(xy1.astype(np.float32), pvalid, h, w)
    gain = rng.uniform(0.8, 1.2, (batch, 1, 1, 1)).astype(np.float32)
    bias = rng.uniform(-0.05, 0.05, (batch, 1, 1, 1)).astype(np.float32)
    return (imgs, Hs, labels0, labels1, xy, xy1.astype(np.float32), pvalid,
            gain, bias)


# ---------------------------------------------------------------------------
# SuperPoint (float32)
# ---------------------------------------------------------------------------

def _jax_v2_loss(params, imgs, Hs, labels0, labels1, xy0, xy1, pvalid, gain,
                 bias, nce_weight=1.0, temp=0.1):
    """The loss of the JAX package's train_superpoint_v2 step (its
    closure at superpoint_train.py:233-295, with its warp, which is
    lightglue_train.warp_batch)."""
    model = jst.SuperPointLogits()

    def sample_desc(desc_map, xy):
        gx = xy[:, 0] / 8.0 - 0.5
        gy = xy[:, 1] / 8.0 - 0.5
        x0 = jnp.floor(gx).astype(jnp.int32)
        y0 = jnp.floor(gy).astype(jnp.int32)
        fx = gx - x0
        fy = gy - y0
        Hc, Wc = desc_map.shape[0], desc_map.shape[1]

        def at(yi, xi):
            return desc_map[jnp.clip(yi, 0, Hc - 1), jnp.clip(xi, 0, Wc - 1)]
        d = (at(y0, x0) * ((1 - fx) * (1 - fy))[:, None] +
             at(y0, x0 + 1) * (fx * (1 - fy))[:, None] +
             at(y0 + 1, x0) * ((1 - fx) * fy)[:, None] +
             at(y0 + 1, x0 + 1) * (fx * fy)[:, None])
        return d / jnp.linalg.norm(d, axis=-1, keepdims=True).clip(1e-8)

    imgs1 = jnp.clip(jlt.warp_batch(imgs, Hs) * gain + bias, 0.0, 1.0)
    semi0, desc0 = model.apply(params, imgs)
    semi1, desc1 = model.apply(params, imgs1)
    det = jst.detector_loss(semi0, labels0) + jst.detector_loss(semi1,
                                                                labels1)
    d0 = jax.vmap(sample_desc)(desc0, xy0)
    d1 = jax.vmap(sample_desc)(desc1, xy1)
    Bb, n, D = d0.shape
    f0 = d0.reshape(Bb * n, D)
    f1 = d1.reshape(Bb * n, D)
    pv = pvalid.reshape(Bb * n)
    sim = (f0 @ f1.T) / temp
    sim = jnp.where(pv[None, :], sim, -1e9)
    simT = jnp.where(pv[:, None], sim, -1e9)
    lab = jnp.arange(Bb * n)
    ce0 = optax.softmax_cross_entropy_with_integer_labels(sim, lab)
    ce1 = optax.softmax_cross_entropy_with_integer_labels(simT.T, lab)
    nce = (jnp.sum(jnp.where(pv, ce0 + ce1, 0.0)) /
           jnp.maximum(jnp.sum(pv), 1.0))
    return det + nce_weight * 0.5 * nce


@pytest.fixture(scope="module")
def sp_jax():
    """JAX's initial SuperPointLogits params (seed 0), the first v2 batch
    of seed 0, the JAX loss and gradients there, and the 3 losses the JAX
    trainer prints."""
    params = jax.jit(jst.SuperPointLogits().init)(
        jax.random.PRNGKey(0), jnp.zeros((1, SP_HW, SP_HW, 1), jnp.float32))
    batch = _jax_v2_batch(np.random.RandomState(0), 0, B, SP_HW, SP_HW,
                          SP_NPTS)
    loss, grads = jax.jit(jax.value_and_grad(_jax_v2_loss))(
        params, *(jnp.asarray(a) for a in batch))
    return params, batch, float(loss), grads


def _port_logits_model(params):
    return convert.from_flax(tst.SuperPointLogits(), params)


def test_superpoint_v2_loss_and_grads(sp_jax):
    params, batch, loss_j, grads_j = sp_jax
    model = _port_logits_model(params)
    loss = tst.v2_loss(model, *(T(a) for a in batch))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), loss_j, rtol=F32_LOSS)
    assert_grads_close(model, grads_j, F32_GRAD)


def test_superpoint_v2_three_steps(sp_jax, capsys):
    jst.train_superpoint_v2(steps=3, batch=B, h=SP_HW, w=SP_HW,
                            n_pts=SP_NPTS, log_every=1)
    want = printed_losses(capsys.readouterr().out)
    got = []
    tst.train_superpoint_v2(steps=3, batch=B, h=SP_HW, w=SP_HW,
                            n_pts=SP_NPTS, device="cpu",
                            init=_port_logits_model(sp_jax[0]),
                            on_step=lambda i, l: got.append(float(l)))
    assert len(want) == 3
    np.testing.assert_allclose(got, want, rtol=STEPS_RTOL)


def test_superpoint_v1_loss_and_three_steps(capsys):
    h = 32
    params = jst.SuperPointLogits().init(jax.random.PRNGKey(0),
                                         jnp.zeros((1, h, h, 1)))
    jst.train_superpoint(steps=3, batch=B, h=h, w=h, log_every=1)
    want = printed_losses(capsys.readouterr().out)
    got = []
    tst.train_superpoint(steps=3, batch=B, h=h, w=h, device="cpu",
                         init=_port_logits_model(params),
                         on_step=lambda i, l: got.append(float(l)))
    np.testing.assert_allclose(got, want, rtol=STEPS_RTOL)


def test_superpoint_logits_match_inference_module(sp_jax):
    """SuperPointLogits shares SuperPoint's layers: the inference module
    (f32) with the same weights gives softmax(semi) as its heat map."""
    model = _port_logits_model(sp_jax[0])
    infer = convert.from_flax(tsp.SuperPoint(compute_dtype=torch.float32),
                              convert.to_flax(model))
    x = T(sp_jax[1][0]).permute(0, 3, 1, 2)
    with torch.no_grad():
        semi, desc = model(x)
        heat, desc2 = infer(x)
    prob = torch.softmax(semi, -1)[..., :64].reshape(B, 6, 6, 8, 8)
    prob = prob.permute(0, 1, 3, 2, 4).reshape(B, SP_HW, SP_HW)
    assert torch.equal(desc, desc2)
    torch.testing.assert_close(prob, heat, rtol=0, atol=1e-7)


# ---------------------------------------------------------------------------
# The optimizer against optax
# ---------------------------------------------------------------------------

OPTIMIZERS = {
    "adam": (lambda: optax.adam(1e-3),
             lambda p: optim.Adam(p, 1e-3)),
    "clip5_adam_cosine": (
        lambda: optax.chain(optax.clip_by_global_norm(5.0),
                            optax.adam(optax.cosine_decay_schedule(1e-3,
                                                                   3))),
        lambda p: optim.Adam(p, optim.cosine_decay(1e-3, 3), clip=5.0)),
    "clip1_adamw_cosine": (
        lambda: optax.chain(optax.clip_by_global_norm(1.0),
                            optax.adamw(optax.cosine_decay_schedule(2e-4,
                                                                    3))),
        lambda p: optim.Adam(p, optim.cosine_decay(2e-4, 3), clip=1.0,
                             weight_decay=1e-4)),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_optax(name, sp_jax):
    """Three updates fed the JAX gradients (scaled per step so that the
    clip both holds and acts) against optax's."""
    params, _, _, grads = sp_jax
    make_optax, make_port = OPTIMIZERS[name]
    tx = make_optax()
    p_j = params
    ost = tx.init(p_j)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    p_t = [torch.tensor(np.asarray(v)) for v in leaves]
    opt = make_port(p_t)
    gleaves = jax.tree_util.tree_leaves(grads)
    for scale in (1.0, -0.05, 40.0):
        g = jax.tree_util.tree_map(lambda x: x * scale, grads)
        up, ost = tx.update(g, ost, p_j)
        p_j = optax.apply_updates(p_j, up)
        opt.step([torch.tensor(np.asarray(x)) * scale for x in gleaves])
        for a, b in zip(p_t, jax.tree_util.tree_leaves(p_j)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-6)


def test_cosine_decay_matches_optax():
    sched = optax.cosine_decay_schedule(2e-4, 7)
    ours = optim.cosine_decay(2e-4, 7)
    for step in range(10):
        np.testing.assert_allclose(ours(step), float(sched(step)),
                                   rtol=1e-6)


# ---------------------------------------------------------------------------
# LightGlue (bf16 dense layers)
# ---------------------------------------------------------------------------

_jax_extract = jax.jit(lambda sp, imgs: jlt.extract_batch(sp, imgs, LG_NKP))
_jax_matcher_grads = jax.jit(jax.value_and_grad(jlt.matcher_loss),
                             static_argnums=1)


@pytest.fixture(scope="module")
def lg_jax():
    """The first batch of seed 0 through the JAX package's pipeline (warp,
    extraction with the shipped SuperPoint, association) and a compact
    LightGlue (dim 64, depth 2) at JAX's initial params, with its loss
    and gradients."""
    sp_params = jsp.load_default_params()
    imgs, Hs, gain, bias = jlt.make_training_batch(np.random.RandomState(0),
                                                   B, LG_HW, LG_HW)
    imgs1 = jnp.clip(jlt.warp_batch(jnp.asarray(imgs), jnp.asarray(Hs)) *
                     gain + bias, 0.0, 1.0)
    both = jnp.concatenate([jnp.asarray(imgs), imgs1], 0)
    xy, desc, valid = _jax_extract(sp_params, both)
    M, un0, un1 = jlt.gt_assignment(xy[:B], valid[:B], xy[B:], valid[B:],
                                    jnp.asarray(Hs), LG_HW, LG_HW)
    model = jlg.LightGlue(dim=LG_DIM, depth=LG_DEPTH, input_dim=256)
    zxy = jnp.zeros((B, LG_NKP, 2))
    zd = jnp.zeros((B, LG_NKP, 256))
    zm = jnp.ones((B, LG_NKP), bool)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), zxy, zxy, zd, zd,
                                 zm, zm)
    ins = (jlg.normalize_keypoints(xy[:B], LG_HW, LG_HW),
           jlg.normalize_keypoints(xy[B:], LG_HW, LG_HW), desc[:B], desc[B:],
           valid[:B], valid[B:], M, un0, un1)
    loss, grads = _jax_matcher_grads(params, model, *ins)
    return dict(sp_params=sp_params, imgs=imgs, Hs=Hs, gain=gain, bias=bias,
                imgs1=np.asarray(imgs1), xy=np.asarray(xy),
                desc=np.asarray(desc), valid=np.asarray(valid),
                M=np.asarray(M), un0=np.asarray(un0), un1=np.asarray(un1),
                params=params, ins=[np.asarray(a) for a in ins],
                loss=float(loss), grads=grads)


def test_warp_batch_matches_jax(lg_jax):
    """Within 1e-5: the homographies' inverses round differently
    (jnp.linalg.inv against torch.linalg.inv)."""
    g = lg_jax
    imgs1 = torch.clamp(tst.warp_batch(T(g["imgs"]), T(g["Hs"])) *
                        T(g["gain"]) + T(g["bias"]), 0.0, 1.0)
    np.testing.assert_allclose(imgs1.numpy(), g["imgs1"], rtol=0, atol=1e-5)


def test_extract_batch_matches_jax(lg_jax):
    """The bf16 SuperPoint's thresholded top-k: near-ties reorder the
    keypoints and move a few across the 0.010 threshold, so the sets are
    compared — over the batch, the common keypoints at least 85 % of the
    larger set (measured: 89 %) — and the descriptors of the common ones
    within 1e-2 (tests/test_torch_models.py's bf16 descriptor
    tolerance)."""
    g = lg_jax
    both = torch.cat([T(g["imgs"]), T(g["imgs1"])])
    xy, desc, valid = tlt.extract_batch(tsp.load_default_params("cpu"),
                                        both, LG_NKP)
    xy, desc, valid = xy.numpy(), desc.numpy(), valid.numpy()
    n_common = n_larger = 0
    for b in range(2 * B):
        ours = {tuple(p): d for p, d, v in zip(xy[b], desc[b], valid[b])
                if v}
        theirs = {tuple(p): d for p, d, v in zip(g["xy"][b], g["desc"][b],
                                                  g["valid"][b]) if v}
        common = set(ours) & set(theirs)
        n_common += len(common)
        n_larger += max(len(ours), len(theirs))
        for p in common:
            np.testing.assert_allclose(ours[p], theirs[p], atol=1e-2)
    assert n_common >= 0.85 * n_larger, (n_common, n_larger)


def test_gt_assignment_matches_jax(lg_jax):
    g = lg_jax
    M, un0, un1 = tlt.gt_assignment(T(g["xy"][:B]), T(g["valid"][:B]),
                                    T(g["xy"][B:]), T(g["valid"][B:]),
                                    T(g["Hs"]), LG_HW, LG_HW)
    assert g["M"].sum() > 0
    for a, b in ((M, g["M"]), (un0, g["un0"]), (un1, g["un1"])):
        np.testing.assert_array_equal(a.numpy(), b)


def _port_matcher(params):
    return convert.from_flax(tlg.LightGlue(dim=LG_DIM, depth=LG_DEPTH), params)


def test_matcher_loss_and_grads(lg_jax):
    model = _port_matcher(lg_jax["params"])
    loss = tlt.matcher_loss(model, *(T(a) for a in lg_jax["ins"]))
    loss.backward()
    assert abs(float(loss) - lg_jax["loss"]) <= BF16_LG_LOSS
    assert abs(float(loss) - lg_jax["loss"]) <= 0.05 * abs(lg_jax["loss"])
    assert_grads_close(model, lg_jax["grads"], BF16_GRAD)


def test_matcher_three_steps_on_jax_keypoints(lg_jax):
    """train_lightglue's update (clip 1 + AdamW on a cosine schedule) over
    3 steps, the official graph (dim 64, depth 2) in float32 on both
    sides, fed the JAX package's extraction of each step's batch."""
    rng = np.random.RandomState(3)
    jmodel = jlgo.LightGlueOfficial(dim=LG_DIM, depth=LG_DEPTH, input_dim=256,
                                    compute_dtype=jnp.float32)
    zxy = jnp.zeros((B, LG_NKP, 2))
    zd = jnp.zeros((B, LG_NKP, 256))
    zm = jnp.ones((B, LG_NKP), bool)
    p_j = jax.jit(jmodel.init)(jax.random.PRNGKey(1), zxy, zxy, zd, zd, zm,
                               zm)
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(optax.cosine_decay_schedule(2e-4, 3)))
    ost = tx.init(p_j)
    tmodel = convert.from_flax(tlgo.LightGlueOfficial(
        dim=LG_DIM, depth=LG_DEPTH, compute_dtype=torch.float32), p_j)
    opt = optim.Adam(tmodel.parameters(), optim.cosine_decay(2e-4, 3),
                     clip=1.0, weight_decay=1e-4)
    want, got = [], []
    for _ in range(3):
        imgs, Hs, gain, bias = jlt.make_training_batch(rng, B, LG_HW, LG_HW)
        imgs1 = jnp.clip(jlt.warp_batch(jnp.asarray(imgs), jnp.asarray(Hs))
                         * gain + bias, 0.0, 1.0)
        xy, desc, valid = _jax_extract(
            lg_jax["sp_params"], jnp.concatenate([jnp.asarray(imgs), imgs1]))
        M, un0, un1 = jlt.gt_assignment(xy[:B], valid[:B], xy[B:],
                                        valid[B:], jnp.asarray(Hs), LG_HW,
                                        LG_HW)
        ins = (jlg.normalize_keypoints(xy[:B], LG_HW, LG_HW),
               jlg.normalize_keypoints(xy[B:], LG_HW, LG_HW), desc[:B],
               desc[B:], valid[:B], valid[B:], M, un0, un1)
        loss, g = _jax_matcher_grads(p_j, jmodel, *ins)
        up, ost = tx.update(g, ost, p_j)
        p_j = optax.apply_updates(p_j, up)
        want.append(float(loss))
        loss_t = tlt.matcher_loss(tmodel, *(T(a) for a in ins))
        opt.zero_grad()
        loss_t.backward()
        opt.step()
        got.append(float(loss_t))
    np.testing.assert_allclose(got, want, rtol=STEPS_RTOL)


def test_train_lightglue_runs_both_graphs():
    """The trainer end to end on the CPU (compact and official graphs):
    finite losses, ground-truth matches found, the matcher evaluated."""
    for official in (False, True):
        model, out = tlt.train_lightglue(
            steps=2, batch=B, h=LG_HW, w=LG_HW, n_kp=LG_NKP, dim=LG_DIM,
            depth=LG_DEPTH, device="cpu", official=official)
        assert np.isfinite(float(out.loss)) and int(out.n_gt) > 0
    prec, rec, n_gt = tlt.evaluate_matcher(model, n_pairs=2, batch=B,
                                           h=LG_HW, w=LG_HW, n_kp=LG_NKP)
    assert 0.0 <= prec <= 1.0 and 0.0 <= rec <= 1.0 and n_gt > 0


# ---------------------------------------------------------------------------
# YOLO
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def yolo_batch():
    return jyt.make_detection_batch(np.random.RandomState(0), B, YOLO_HW,
                                    YOLO_HW)


def _yolo_pair(dt_j, dt_t):
    jmodel = jyolo.YoloNet(num_classes=2, width=YOLO_WIDTH, dt=dt_j)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  jnp.zeros((1, YOLO_HW, YOLO_HW, 3)))
    tmodel = convert.from_flax(tyolo.YoloNet(2, YOLO_WIDTH,
                                             compute_dtype=dt_t), params)
    return jmodel, params, tmodel


def test_build_targets_matches_jax(yolo_batch):
    """Every scale of both images, and a pair of boxes sharing a cell (the
    later one wins)."""
    _, boxes, cls, valid = yolo_batch
    boxes, cls, valid = boxes.copy(), cls.copy(), valid.copy()
    boxes[1, 1] = boxes[1, 0] + 1.0
    cls[1, 1] = 1 - cls[1, 0]
    valid[1, :2] = True
    for stride, anchors in zip(jyolo.STRIDES, jyolo.ANCHORS):
        H = W = YOLO_HW // stride
        out_t = tyt._build_targets_scale(T(boxes), T(cls), T(valid), H, W,
                                         stride, anchors, 2)
        for b in range(B):
            out_j = jyt._build_targets_scale(
                jnp.asarray(boxes[b]), jnp.asarray(cls[b]),
                jnp.asarray(valid[b]), H, W, stride, anchors, 2)
            for a, ref in zip(out_t, out_j):
                np.testing.assert_array_equal(a[b].numpy(), np.asarray(ref))


def _jax_yolo_grads(params, jmodel, batch):
    return jax.jit(jax.value_and_grad(jyt.yolo_loss), static_argnums=(1, 6))(
        params, jmodel, *(jnp.asarray(a) for a in batch), 2)


def test_yolo_loss_and_grads_bf16(yolo_batch):
    jmodel, params, tmodel = _yolo_pair(jnp.bfloat16, torch.bfloat16)
    loss_j, grads_j = _jax_yolo_grads(params, jmodel, yolo_batch)
    loss = tyt.yolo_loss(tmodel, *(T(a) for a in yolo_batch), 2)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(loss_j),
                               rtol=BF16_YOLO_LOSS)
    assert_grads_close(tmodel, grads_j, BF16_GRAD)


def test_yolo_loss_and_grads_f32(yolo_batch):
    """The nets with compute_dtype float32: the port's loss and gradients
    within 1e-7 / 1e-6 of its own float64 evaluation; the JAX package's
    loss within rtol F32_LOSS of the port's, its gradients within 1e-3 —
    XLA's float32 convolutions on the CPU are 1.5e-6 off in the loss and
    5.5e-4 in the gradients against that float64 evaluation (measured),
    the port 1e-8 and 7e-8."""
    jmodel, params, tmodel = _yolo_pair(jnp.float32, torch.float32)
    loss_j, grads_j = _jax_yolo_grads(params, jmodel, yolo_batch)
    loss = tyt.yolo_loss(tmodel, *(T(a) for a in yolo_batch), 2)
    loss.backward()
    m64 = copy.deepcopy(tmodel).double()
    m64.compute_dtype = torch.float64
    batch64 = [T(a).double() if a.dtype == np.float32 else T(a)
               for a in yolo_batch]
    loss64 = tyt.yolo_loss(m64, *batch64, 2)
    loss64.backward()
    num = sum(float(torch.sum((a.grad.double() - b.grad) ** 2))
              for a, b in zip(tmodel.parameters(), m64.parameters()))
    den = sum(float(torch.sum(b.grad ** 2)) for b in m64.parameters())
    np.testing.assert_allclose(float(loss), float(loss64), rtol=1e-7)
    assert (num / den) ** 0.5 <= 1e-6
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=F32_LOSS)
    assert_grads_close(tmodel, grads_j, 1e-3)


def test_train_yolo_three_steps_f32(capsys):
    jmodel, params, tmodel = _yolo_pair(jnp.float32, torch.float32)
    jyt.train_yolo(steps=3, batch=B, h=YOLO_HW, w=YOLO_HW, log_every=1,
                   model=jmodel)
    want = printed_losses(capsys.readouterr().out)
    got = []
    tyt.train_yolo(steps=3, batch=B, h=YOLO_HW, w=YOLO_HW, device="cpu",
                   init=tmodel, on_step=lambda i, l: got.append(float(l)))
    np.testing.assert_allclose(got, want, rtol=STEPS_RTOL)


def test_yolo_batched_forward_is_per_image(yolo_batch):
    """The batched forward of both nets equals the one-image forward the
    SLAM path calls."""
    imgs = T(yolo_batch[0])
    for model in (tyolo.YoloNet(2, 8), tyo.YoloV5Net(3, 0.33, 0.125)):
        convert.flax_init(model, 0)
        with torch.no_grad():
            batched = model(imgs)
            single = [model(img) for img in imgs]
        for s, out in enumerate(batched):
            for b in range(B):
                assert torch.equal(out[b], single[b][s])


def test_evaluate_detector_runs():
    model, loss = tyt.train_yolo(steps=1, batch=B, h=YOLO_HW, w=YOLO_HW,
                                 device="cpu")
    prec, rec, n_gt = tyt.evaluate_detector(model, n_scenes=3, h=YOLO_HW,
                                            w=YOLO_HW)
    assert np.isfinite(loss) and 0.0 <= prec <= 1.0 and 0.0 <= rec <= 1.0


# ---------------------------------------------------------------------------
# Vocabulary
# ---------------------------------------------------------------------------

def test_vocab_train_and_save_match_jax(tmp_path):
    """train_vocab on the JAX corpus against JAX's (the same spherical
    k-means from the same seed pick), save_vocab byte for byte, and
    build_corpus's size against JAX's (the bf16 extraction differs on
    near-ties)."""
    corpus = jvt.build_corpus(jsp.load_default_params(), n_images=4, h=64,
                              w=64, n_per=64)
    ours = tvt.build_corpus(tsp.load_default_params("cpu"), n_images=4,
                            h=64, w=64, n_per=64)
    assert abs(len(ours) - len(corpus)) <= 0.05 * len(corpus)
    cb_j = jvt.train_vocab(corpus, n_words=32, iters=5)
    cb_t = tvt.train_vocab(corpus, n_words=32, iters=5, device="cpu")
    np.testing.assert_allclose(cb_t, cb_j, atol=1e-5)
    jvt.save_vocab(str(tmp_path / "j.npz"), cb_j)
    tvt.save_vocab(str(tmp_path / "t.npz"), cb_j)
    with np.load(tmp_path / "j.npz") as a, np.load(tmp_path / "t.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------------------------
# Initialization, converter, lie
# ---------------------------------------------------------------------------

def _tree_shapes(tree):
    return {"/".join(k): tuple(np.shape(v)) for k, v in _flatten(tree)}


INITS = {
    "superpoint": (lambda: jsp.init_params(jax.random.PRNGKey(0), 32, 32),
                   lambda: tsp.init_params(0, "cpu")),
    "lightglue": (lambda: jlg.init_matcher(jax.random.PRNGKey(0), n=8,
                                           dim=32, depth=2).params,
                  lambda: tlg.init_matcher(0, dim=32, depth=2,
                                           device="cpu").model),
    "lightglue_official": (
        lambda: jlgo.LightGlueOfficial(dim=32, depth=2).init(
            jax.random.PRNGKey(0), *([jnp.zeros((1, 4, 2))] * 2),
            *([jnp.zeros((1, 4, 256))] * 2), *([jnp.ones((1, 4), bool)] * 2)),
        lambda: convert.flax_init(tlgo.LightGlueOfficial(dim=32, depth=2),
                                  0)),
    "yolo": (lambda: jyolo.YoloNet(num_classes=2, width=8).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))),
        lambda: convert.flax_init(tyolo.YoloNet(2, 8), 0)),
    "yolov5s": (lambda: jyo.YoloV5Net(num_classes=80).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))),
        lambda: convert.flax_init(tyo.YoloV5Net(80), 0)),
}


@pytest.mark.parametrize("name", sorted(INITS))
def test_init_names_shapes_and_scale(name):
    """The port's Flax-style initialization: the JAX tree's names and
    shapes, zero biases, unit layer-norm scales, and each kernel's spread
    that of Flax's lecun-normal (within 15 %)."""
    jtree = jax.device_get(jax.jit(INITS[name][0])())["params"]
    model = INITS[name][1]()
    ttree = convert.to_flax(model)["params"]
    assert _tree_shapes(ttree) == _tree_shapes(jtree)
    for key, v in _flatten(ttree):
        j = np.asarray(dict(_flatten(jtree))[key])
        if key[-1] == "bias":
            assert not v.any()
        elif key[-1] == "scale":
            assert (v == 1).all()
        elif v.size >= 256:
            assert abs(v.std() / j.std() - 1) < 0.15, key


def test_converter_round_trip_through_jax(tmp_path, sp_jax):
    """A port-trained SuperPoint saved with the reverse converter loads in
    the JAX package (superpoint_train.load_params) and gives the same heat
    map there (both in float32), and reloads through the port's loader."""
    model, _ = tst.train_superpoint_v2(steps=1, batch=B, h=SP_HW, w=SP_HW,
                                       n_pts=SP_NPTS, device="cpu")
    path = str(tmp_path / "sp.npz")
    tst.save_params(path, model)
    jparams = jst.load_params(path)
    img = sp_jax[1][0][:1]
    heat_j, desc_j = jsp.SuperPoint(compute_dtype=jnp.float32).apply(
        jparams, jnp.asarray(img))
    infer = convert.from_flax(tsp.SuperPoint(compute_dtype=torch.float32),
                              convert.to_flax(model))
    with torch.no_grad():
        heat, desc = infer(T(img).permute(0, 3, 1, 2))
    np.testing.assert_allclose(heat.numpy(), np.asarray(heat_j), atol=1e-5)
    np.testing.assert_allclose(desc.numpy(), np.asarray(desc_j), atol=1e-4)
    loaded = tsp.load_default_params("cpu", path)
    for a, b in zip(loaded.state_dict().values(),
                    infer.state_dict().values()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", sorted(INITS))
def test_converter_round_trip_in_port(name, tmp_path):
    """to_flax -> save -> load -> from_flax gives the same parameters,
    bit for bit."""
    model = INITS[name][1]()
    path = str(tmp_path / "m.npz")
    convert.save_params(path, convert.to_flax(model))
    back = convert.from_flax(copy.deepcopy(model).apply(
        lambda m: [p.data.zero_() for p in m.parameters(recurse=False)]),
        convert.load_params(path))
    for (ka, a), (kb, b) in zip(model.state_dict().items(),
                                back.state_dict().items()):
        assert ka == kb and torch.equal(a, b), ka


def test_lie_leftovers_match_jax():
    rng = np.random.RandomState(0)
    xi = rng.randn(5, 6).astype(np.float32) * 0.4
    R, t = jlie.se3_exp(jnp.asarray(xi))
    Tj = jlie.se3_to_mat(R, t)
    Tt = tlie.se3_to_mat(T(R), T(t))
    np.testing.assert_array_equal(Tt.numpy(), np.asarray(Tj))
    for a, b in zip(tlie.mat_to_se3(Tt), jlie.mat_to_se3(Tj)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    noisy = np.asarray(R) + rng.randn(5, 3, 3).astype(np.float32) * 0.05
    noisy[0] = -noisy[0]                # det -1: the reflection branch
    Rn_j = np.asarray(jlie.normalize_rotation(jnp.asarray(noisy)))
    Rn_t = tlie.normalize_rotation(T(noisy)).numpy()
    np.testing.assert_allclose(Rn_t, Rn_j, atol=2e-6)
    np.testing.assert_allclose(np.linalg.det(Rn_t[1:]), 1.0, atol=1e-5)
