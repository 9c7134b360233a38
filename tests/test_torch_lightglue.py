"""LightGlue in the port against the JAX package's Flax model, on the shipped
weights (dani_slam_tpu/weights/lightglue_synthetic.npz), on the CPU.

Both run the q/k/v/proj and MLP layers in bfloat16, but XLA and PyTorch round
at different places inside those layers (a bf16 GELU computed per operation
there, in f32 with one rounding here; the bias added after or before the
rounding of the product), and six blocks of that compound. Measured against
an all-f32 evaluation of the same weights either implementation is off by
about 0.5 in the log scores and 0.04 in the matchability logits, and they are
as far from each other. Stated tolerances: log scores of valid pairs within
1.5, assignment probabilities exp(score) within 0.03, matchability logits
within 0.15. Match sets: a pair may differ only where its probability is
within SCORE_TOL of the 0.05 threshold or of the runner-up in its row or
column.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dani_slam_tpu.models import lightglue as jlg
from dani_slam_tpu.models import superpoint_train as jtrain
from dani_slam_tpu_torch.models import convert
from dani_slam_tpu_torch.models import lightglue as tlg

torch.set_num_threads(2)       # several test workers share the machine

W, H = 640, 480
SCORE_TOL = 0.03
T = torch.as_tensor


@pytest.fixture(scope="module")
def matchers():
    return jlg.load_default_matcher(W, H), \
        tlg.load_default_matcher(W, H, device="cpu")


def make_pair(n, n0, n1, seed, batch=1):
    """Keypoints of image 0 reappear in image 1 permuted, shifted by about
    a pixel, their unit descriptors perturbed; valid prefixes n0, n1."""
    rng = np.random.RandomState(seed)
    xy0 = rng.uniform(0, [W, H], (batch, n, 2)).astype(np.float32)
    d0 = rng.randn(batch, n, 256).astype(np.float32)
    d0 /= np.linalg.norm(d0, axis=-1, keepdims=True)
    perm = rng.permutation(n)
    xy1 = xy0[:, perm] + rng.randn(batch, n, 2).astype(np.float32)
    d1 = d0[:, perm] + 0.05 * rng.randn(batch, n, 256).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    m0 = np.broadcast_to(np.arange(n)[None] < n0, (batch, n)).copy()
    m1 = np.broadcast_to(np.arange(n)[None] < n1, (batch, n)).copy()
    return xy0, d0, m0, xy1, d1, m1


def test_converter_round_trip():
    """Every leaf of the shipped npz lands in the module (Dense kernels
    transposed), and nothing of the module is left unset."""
    params = convert.load_params(tlg.WEIGHTS)
    model = convert.from_flax(tlg.LightGlue(), params)
    sd = model.state_dict()
    seen = set()

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + [k])
                continue
            parts = [f"layers.{p[5:]}" if p.startswith("layer") else p
                     for p in path]
            if k == "pos_freq":
                name, want = "pos_freq", v
            else:
                name = ".".join(parts + ["weight" if k == "kernel" else k])
                want = v.T if k == "kernel" else v
            np.testing.assert_array_equal(sd[name].numpy(), want)
            seen.add(name)

    walk(params["params"], [])
    assert seen == set(sd)
    assert sd["pos_freq"].shape == (2, 16)
    # same tree as the reference package's loader reads
    jp = jtrain.load_params(tlg.WEIGHTS)["params"]
    np.testing.assert_array_equal(np.asarray(jp["in_proj"]["kernel"]).T,
                                  sd["in_proj.weight"].numpy())


def test_normalize_and_rotary_exact():
    rng = np.random.RandomState(0)
    xy = rng.uniform(0, [W, H], (3, 50, 2)).astype(np.float32)
    np.testing.assert_allclose(
        tlg.normalize_keypoints(T(xy), W, H).numpy(),
        np.asarray(jlg.normalize_keypoints(jnp.asarray(xy), W, H)),
        rtol=0, atol=1e-6)
    x = rng.randn(2, 50, 128).astype(np.float32)
    ang = rng.uniform(-6, 6, (2, 50, 64)).astype(np.float32)
    # f32 sin/cos of the two libraries differ in the last bit
    np.testing.assert_allclose(
        tlg._rotary(T(x), T(ang)).numpy(),
        np.asarray(jlg._rotary(jnp.asarray(x), jnp.asarray(ang))),
        rtol=0, atol=5e-6)


@pytest.mark.parametrize("n,n0,n1,seed", [(256, 200, 230, 0),
                                          (1024, 900, 0, 1),
                                          (1024, 700, 1024, 2)])
def test_forward_matches_flax(matchers, n, n0, n1, seed):
    """scores, z0, z1 at N=256 and N=1024 with ragged masks, one case with
    no valid point on one side (finite everywhere: NEG masking, not -inf)."""
    jm, tm = matchers
    xy0, d0, m0, xy1, d1, m1 = make_pair(n, n0, n1, seed)
    sj, z0j, z1j = jm.model.apply(
        jm.params, jlg.normalize_keypoints(jnp.asarray(xy0), W, H),
        jlg.normalize_keypoints(jnp.asarray(xy1), W, H), jnp.asarray(d0),
        jnp.asarray(d1), jnp.asarray(m0), jnp.asarray(m1))
    with torch.no_grad():
        st, z0t, z1t = tm.model(
            tlg.normalize_keypoints(T(xy0), W, H),
            tlg.normalize_keypoints(T(xy1), W, H), T(d0), T(d1), T(m0),
            T(m1))
    sj, st = np.asarray(sj), st.numpy()
    assert st.shape == sj.shape == (1, n, n)
    assert np.isfinite(st).all() and np.isfinite(z0t.numpy()).all()
    valid = m0[0][:, None] & m1[0][None, :]
    if valid.any():
        assert np.abs(st[0][valid] - sj[0][valid]).max() < 1.5
    assert np.abs(np.exp(st) - np.exp(sj)).max() < SCORE_TOL
    for zt, zj, m in ((z0t, z0j, m0), (z1t, z1j, m1)):
        if m.any():
            assert np.abs(zt.numpy() - np.asarray(zj))[m].max() < 0.15


def _assert_match_sets_agree(out_t, out_j, s_ref):
    """ok sets and indices agree except on near-ties of the probabilities
    s_ref [B,N0,N1] (threshold or runner-up within SCORE_TOL)."""
    it, bt, okt = (x.numpy() for x in out_t)
    ij, bj, okj = (np.asarray(x) for x in out_j)
    assert it.dtype == np.int32 and okt.dtype == bool
    assert np.abs(bt - bj).max() < SCORE_TOL
    top2_r = -np.sort(-s_ref, axis=-1)[..., :2]
    gap_r = top2_r[..., 0] - top2_r[..., 1]                  # [B,N0]
    top2_c = -np.sort(-s_ref, axis=-2)[..., :2, :]
    gap_c = top2_c[..., 0, :] - top2_c[..., 1, :]            # [B,N1]
    near = (np.abs(bj - 0.05) < SCORE_TOL) | (gap_r < 2 * SCORE_TOL) | \
        (np.take_along_axis(gap_c, ij.astype(np.int64), -1) < 2 * SCORE_TOL)
    differ = (okt != okj) | (okj & okt & (it != ij))
    assert not (differ & ~near).any()
    assert okj.sum() > 0 and differ.sum() <= 0.02 * okj.size


@pytest.mark.parametrize("n,n0,n1,batch", [(256, 200, 230, 3),
                                           (512, 512, 400, 1)])
def test_match_pairs_matches_flax(matchers, n, n0, n1, batch):
    jm, tm = matchers
    args = make_pair(n, n0, n1, 5, batch=batch)
    out_j = jlg.match_pairs(jm.model, jm.params,
                            *(jnp.asarray(a) for a in args), W, H)
    out_t = tlg.match_pairs(tm.model, *(T(a) for a in args), W, H)
    sj = jm.model.apply(
        jm.params, jlg.normalize_keypoints(jnp.asarray(args[0]), W, H),
        jlg.normalize_keypoints(jnp.asarray(args[3]), W, H),
        jnp.asarray(args[1]), jnp.asarray(args[4]), jnp.asarray(args[2]),
        jnp.asarray(args[5]))[0]
    _assert_match_sets_agree(out_t, out_j, np.exp(np.asarray(sj)))
    # planted correspondences are found
    assert int(out_t[2].sum()) > 0.25 * min(n0, n1) * batch


def test_match_pair_and_match_match_flax(matchers):
    jm, tm = matchers
    args = [a[0] for a in make_pair(256, 256, 180, 9)]
    out_j = jlg.match_pair(jm.model, jm.params,
                           *(jnp.asarray(a) for a in args), W, H)
    out_t = tlg.match_pair(tm.model, *(T(a) for a in args), W, H)
    out_j2 = jlg.match(jm, *(jnp.asarray(a) for a in args))
    out_t2 = tlg.match(tm, *(T(a) for a in args))
    sj = jm.model.apply(
        jm.params, jlg.normalize_keypoints(jnp.asarray(args[0][None]), W, H),
        jlg.normalize_keypoints(jnp.asarray(args[3][None]), W, H),
        *(jnp.asarray(args[i][None]) for i in (1, 4, 2, 5)))[0]
    s = np.exp(np.asarray(sj))
    for ot, oj in ((out_t, out_j), (out_t2, out_j2)):
        assert ot[0].shape == (256,)
        _assert_match_sets_agree([x[None] for x in ot],
                                 [np.asarray(x)[None] for x in oj], s)
    for a, b in zip(out_t, out_t2):
        assert torch.equal(a, b)
