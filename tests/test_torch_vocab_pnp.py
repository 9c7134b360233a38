"""Place recognition, PnP / Sim3 RANSAC, the essential graph and the PCG
bundle adjustment of the port against the JAX package, on seeded numpy
inputs at the small capacities of tests/test_loop_reloc.py.

Randomness drawn in JAX (the codebook, the RANSAC minimal sets) is carried
across: the JAX key's jax.random.categorical draws are handed to the port's
RANSACs as sample indices, so the comparison never depends on two random
streams.

Tolerances: word ids, candidate ids, keep masks, inlier sets and edge masks
exactly equal; BoW scores within 1e-6; poses after RANSAC within 1e-4 (the
two SVDs may differ in sign and order, the poses they lead to do not);
essential-graph poses within 1e-5; the PCG chunk within rtol 1e-4 and
atol 1e-4 (rotation entries near 0; its landmark sums are differences of an
f32 cumulative sum in both libraries, accumulated in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dani_slam_tpu.core import cameras as jcam
from dani_slam_tpu.core import lie as jlie
from dani_slam_tpu.models import vocab as jvocab
from dani_slam_tpu.ops import ba_large as jbal
from dani_slam_tpu.ops import pnp as jpnp
from dani_slam_tpu.ops import posegraph as jpg
from dani_slam_tpu.ops import sim3 as jsim3
from dani_slam_tpu_torch.core import cameras as tcam
from dani_slam_tpu_torch.core import lie as tlie
from dani_slam_tpu_torch.models import vocab as tvocab
from dani_slam_tpu_torch.ops import ba_large as tbal
from dani_slam_tpu_torch.ops import linalg as tlinalg
from dani_slam_tpu_torch.ops import pnp as tpnp
from dani_slam_tpu_torch.ops import posegraph as tpg
from dani_slam_tpu_torch.ops import sim3 as tsim3
from dani_slam_tpu_torch.utils import checkpoint as tckpt

torch.set_num_threads(2)       # several test workers share the machine

JC = jcam.Camera.pinhole(500.0, 500.0, 320.0, 240.0, 640, 480)
TC = tcam.Camera.pinhole(500.0, 500.0, 320.0, 240.0, 640, 480, device="cpu")


def T(x):
    return torch.as_tensor(np.array(x))


def N(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def categorical(key, mask, n_hypo, k):
    """The minimal sets the JAX RANSACs draw from `key`."""
    p = jnp.asarray(mask).astype(jnp.float32) + 1e-6
    return np.asarray(jax.random.categorical(
        key, jnp.broadcast_to(jnp.log(p), (n_hypo, k, p.shape[0])), axis=-1))


# ---------------------------------------------------------------------------
# Lie group
# ---------------------------------------------------------------------------

def test_sim3_exp_log_and_so3_log():
    rng = np.random.RandomState(0)
    xi = (rng.randn(64, 7) * 0.5).astype(np.float32)
    xi[:8] = 0.0                       # small-angle and small-scale branches
    xi[8:16, 6] = 0.0
    xi[16:24, 3:6] = 1e-5
    a = jlie.sim3_exp(jnp.asarray(xi))
    b = tlie.sim3_exp(T(xi))
    for x, y in zip(a, b):
        np.testing.assert_allclose(N(y), N(x), atol=1e-6)
    np.testing.assert_allclose(N(tlie.sim3_log(*b)), N(jlie.sim3_log(*a)),
                               atol=2e-6)
    np.testing.assert_allclose(N(tlie.so3_log(b[0])), N(jlie.so3_log(a[0])),
                               atol=1e-6)
    np.testing.assert_allclose(N(tlie.vee(tlie.hat(T(xi[:, :3])))), xi[:, :3])
    # forward-mode Jacobian of log(exp(x)) is the identity
    _, J = tlinalg.jacfwd(lambda x: tlie.sim3_log(*tlie.sim3_exp(x)),
                          T(xi[8:]) * 0.1)
    np.testing.assert_allclose(N(J), np.broadcast_to(np.eye(7), J.shape),
                               atol=2e-3)


# ---------------------------------------------------------------------------
# Vocabulary
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bow_db():
    """A database of 24 keyframes (6 of them free slots) from descriptors
    that share structure between neighbouring keyframes, a JAX-drawn
    codebook, and a covisibility matrix."""
    rng = np.random.RandomState(3)
    K, Nk, D, V = 24, 96, 64, 128
    base = rng.randn(40, D).astype(np.float32)
    desc = np.zeros((K, Nk, D), np.float32)
    for k in range(K):
        src = rng.randint(0, 40, Nk)
        d = base[src] + 0.3 * rng.randn(Nk, D)
        desc[k] = d / np.linalg.norm(d, axis=1, keepdims=True)
    mask = rng.rand(K, Nk) > 0.15
    kf_mask = np.ones(K, bool)
    kf_mask[[3, 9, 10, 17, 20, 23]] = False
    cb = np.asarray(jvocab.random_codebook(jax.random.PRNGKey(7), V, D))
    covis = rng.randint(0, 40, (K, K)).astype(np.int32)
    covis = np.triu(covis, 1) + np.triu(covis, 1).T
    return desc, mask, kf_mask, cb, covis


def test_quantize_bow_and_rows(bow_db):
    desc, mask, kf_mask, cb, _ = bow_db
    wj = np.asarray(jvocab.quantize(jnp.asarray(desc[0]),
                                    jnp.asarray(mask[0]), jnp.asarray(cb)))
    wt = N(tvocab.quantize(T(desc[0]), T(mask[0]), T(cb)))
    np.testing.assert_array_equal(wt, wj)
    np.testing.assert_allclose(
        N(tvocab.bow_vector(T(wt), cb.shape[0])),
        N(jvocab.bow_vector(jnp.asarray(wj), cb.shape[0])), atol=1e-6)
    rj = jvocab.rebuild_bow_rows(jnp.asarray(desc), jnp.asarray(mask),
                                 jnp.asarray(kf_mask), jnp.asarray(cb))
    rt = tvocab.rebuild_bow_rows(T(desc), T(mask), T(kf_mask), T(cb))
    np.testing.assert_allclose(N(rt), N(rj), atol=1e-6)
    bj, rowj = jvocab.update_bow_row(rj, jnp.asarray(desc), jnp.asarray(mask),
                                     jnp.asarray(3), jnp.asarray(cb))
    bt, rowt = tvocab.update_bow_row(rt, T(desc), T(mask), torch.tensor(3),
                                     T(cb))
    np.testing.assert_allclose(N(bt), N(bj), atol=1e-6)
    np.testing.assert_allclose(N(rowt), N(rowj), atol=1e-6)
    np.testing.assert_allclose(N(tvocab.idf_weights(rt, T(kf_mask))),
                               N(jvocab.idf_weights(rj,
                                                    jnp.asarray(kf_mask))),
                               atol=1e-6)
    db = tvocab.PlaceDB(T(cb), 24)
    db.add(5, T(desc[5]), T(mask[5]))
    np.testing.assert_allclose(N(db.bow[5]), N(rj[5]), atol=1e-6)
    db.remove(5)
    assert float(db.bow.abs().sum()) == 0.0


def test_train_codebook(bow_db):
    desc, mask, kf_mask, cb, _ = bow_db
    d = desc.reshape(-1, desc.shape[-1])
    m = (mask & kf_mask[:, None]).reshape(-1)
    cj = np.asarray(jvocab.train_codebook(jnp.asarray(d), jnp.asarray(m),
                                          jnp.asarray(cb)))
    ct = N(tvocab.train_codebook(T(d), T(m), T(cb)))
    np.testing.assert_allclose(ct, cj, atol=1e-5)
    # the trained words quantize the database identically
    np.testing.assert_array_equal(
        N(tvocab.quantize(T(d), T(m), T(ct))),
        np.asarray(jvocab.quantize(jnp.asarray(d), jnp.asarray(m),
                                   jnp.asarray(cj))))
    # deterministic: the same inputs give the same bits
    assert torch.equal(tvocab.train_codebook(T(d), T(m), T(cb)), T(ct))


@pytest.mark.parametrize("query", [2, 6, 14])
def test_detect_candidates(bow_db, query):
    desc, mask, kf_mask, cb, covis = bow_db
    rj = jvocab.rebuild_bow_rows(jnp.asarray(desc), jnp.asarray(mask),
                                 jnp.asarray(kf_mask), jnp.asarray(cb))
    rt = T(np.asarray(rj))
    ij, vj = jvocab.detect_candidates(rj, jnp.asarray(kf_mask), rj[query],
                                      jnp.asarray(covis),
                                      jnp.asarray(query), n_best=3)
    it, vt = tvocab.detect_candidates(rt, T(kf_mask), rt[query], T(covis),
                                      torch.tensor(query), n_best=3)
    np.testing.assert_array_equal(N(it), N(ij))
    np.testing.assert_allclose(N(vt), N(vj), atol=1e-6)
    qw = np.asarray(jvocab.quantize(jnp.asarray(desc[query]),
                                    jnp.asarray(mask[query]),
                                    jnp.asarray(cb)))
    q = jvocab.bow_vector(jnp.asarray(qw), cb.shape[0])
    for cov in (None, covis):
        oj = jvocab.detect_reloc_candidates(
            rj, jnp.asarray(kf_mask), q,
            covis=None if cov is None else jnp.asarray(cov), n_best=5)
        ot = tvocab.detect_reloc_candidates(
            rt, T(kf_mask), T(np.asarray(q)),
            covis=None if cov is None else T(cov), n_best=5)
        np.testing.assert_array_equal(N(ot[0]), N(oj[0]))
        np.testing.assert_allclose(N(ot[1]), N(oj[1]), atol=1e-6)
        np.testing.assert_array_equal(N(ot[2]), N(oj[2]))


def test_default_codebook_checksum(tmp_path, monkeypatch):
    cb = tvocab.load_default_codebook(256, device="cpu")
    ref = np.asarray(jvocab.load_default_codebook(256))
    np.testing.assert_array_equal(N(cb), ref)
    from dani_slam_tpu.utils.checkpoint import codebook_checksum
    assert tckpt.codebook_checksum(ref) == codebook_checksum(ref)
    assert tvocab.load_default_codebook(64, device="cpu") is None
    # a stored checksum that does not match is refused
    bad = tmp_path / "dani_slam_tpu" / "weights"
    bad.mkdir(parents=True)
    np.savez(bad / "superpoint_voc.npz", codebook=ref,
             sha=np.frombuffer(b"0" * 64, np.uint8))
    fake_models = tmp_path / "dani_slam_tpu_torch" / "models"
    fake_models.mkdir(parents=True)
    monkeypatch.setattr(tvocab, "__file__",
                        str(fake_models / "vocab.py"))
    with pytest.raises(ValueError, match="checksum"):
        tvocab.load_default_codebook(256, device="cpu")


# ---------------------------------------------------------------------------
# PnP and Sim3 RANSAC
# ---------------------------------------------------------------------------

def _scene(seed, n=300, outliers=60):
    rng = np.random.RandomState(seed)
    X = rng.uniform([-4, -3, 4], [4, 3, 12], (n, 3)).astype(np.float32)
    R, t = (np.asarray(a) for a in jlie.se3_exp(jnp.asarray(
        [0.2, -0.1, 0.3, 0.05, 0.12, -0.03], jnp.float32)))
    xy = np.asarray(jcam.project(JC, jnp.asarray(X @ R.T + t)))
    xy = (xy + rng.randn(n, 2) * 0.4).astype(np.float32)
    xy[:outliers] += rng.uniform(-60, 60, (outliers, 2)).astype(np.float32)
    mask = rng.rand(n) > 0.1
    return rng, X, R, t, xy, mask


@pytest.mark.parametrize("seed", [0, 1])
def test_pnp_ransac_injected_samples(seed):
    _, X, R, t, xy, mask = _scene(seed)
    key = jax.random.PRNGKey(seed)
    rj = jpnp.pnp_ransac(key, JC, jnp.asarray(X), jnp.asarray(xy),
                         jnp.asarray(mask))
    rt = tpnp.pnp_ransac(T(categorical(key, mask, 256, 6)), TC, T(X), T(xy),
                         T(mask))
    np.testing.assert_array_equal(N(rt.inliers), N(rj.inliers))
    assert int(rt.n_inliers) == int(rj.n_inliers) and bool(rt.ok)
    np.testing.assert_allclose(N(rt.R), N(rj.R), atol=1e-4)
    np.testing.assert_allclose(N(rt.t), N(rj.t), atol=1e-4)
    np.testing.assert_allclose(N(rt.t), t, atol=0.05)
    # the port's own draws (a generator) find the pose as well
    rg = tpnp.pnp_ransac(torch.Generator().manual_seed(seed), TC, T(X),
                         T(xy), T(mask))
    assert bool(rg.ok)
    np.testing.assert_allclose(N(rg.t), t, atol=0.05)


@pytest.mark.parametrize("fix_scale", [False, True])
def test_sim3_ransac_and_optimize(fix_scale):
    rng = np.random.RandomState(5)
    n = 200
    P2 = rng.uniform([-3, -2, 3], [3, 2, 9], (n, 3)).astype(np.float32)
    R12, t12 = (np.asarray(a) for a in jlie.se3_exp(jnp.asarray(
        [0.3, -0.2, 0.4, 0.04, -0.06, 0.08], jnp.float32)))
    s12 = np.float32(1.0 if fix_scale else 1.15)
    P1 = (s12 * P2 @ R12.T + t12 + rng.randn(n, 3) * 0.01).astype(np.float32)
    P1[:40] += rng.uniform(-1, 1, (40, 3)).astype(np.float32)
    mask = rng.rand(n) > 0.1
    key = jax.random.PRNGKey(11)
    rj = jsim3.sim3_ransac(key, JC, JC, jnp.asarray(P1), jnp.asarray(P2),
                           jnp.asarray(mask), fix_scale=fix_scale)
    rt = tsim3.sim3_ransac(T(categorical(key, mask, 128, 3)), TC, TC, T(P1),
                           T(P2), T(mask), fix_scale=fix_scale)
    np.testing.assert_array_equal(N(rt.inliers), N(rj.inliers))
    assert int(rt.n_inliers) == int(rj.n_inliers) and bool(rt.ok)
    for a, b in zip((rt.R, rt.t, rt.s), (rj.R, rj.t, rj.s)):
        np.testing.assert_allclose(N(a), N(b), atol=1e-4)
    obs1 = np.asarray(jcam.project(JC, jnp.asarray(P1)))
    obs2 = np.asarray(jcam.project(JC, jnp.asarray(P2)))
    oj = jsim3.optimize_sim3(JC, JC, rj.R, rj.t, rj.s, jnp.asarray(P1),
                             jnp.asarray(obs1), jnp.asarray(P2),
                             jnp.asarray(obs2), rj.inliers,
                             fix_scale=fix_scale)
    ot = tsim3.optimize_sim3(TC, TC, rt.R, rt.t, rt.s, T(P1), T(obs1), T(P2),
                             T(obs2), rt.inliers, fix_scale=fix_scale)
    for a, b in zip(ot[:3], oj[:3]):
        np.testing.assert_allclose(N(a), N(b), atol=1e-4)
    np.testing.assert_array_equal(N(ot[3]), N(oj[3]))
    assert int(ot[4]) == int(oj[4]) > 100
    np.testing.assert_allclose(float(ot[2]), s12, atol=0.01)


# ---------------------------------------------------------------------------
# Essential graph
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def graph():
    """A 24-node sim3 graph: measurements from true poses, nodes perturbed,
    random edges over a spanning chain, one empty slot, node 0 fixed."""
    rng = np.random.RandomState(2)
    K = 24
    xi = (rng.randn(K, 7) * 0.4).astype(np.float32)
    xi[:, 6] *= 0.2
    R, t, s = jlie.sim3_exp(jnp.asarray(xi))
    Rm, tm, sm = jax.vmap(lambda a, b, c: jax.vmap(
        lambda d, e, f: jpg.relative_sim3(a, b, c, d, e, f))(R, t, s))(R, t,
                                                                        s)
    d = (rng.randn(K, 7) * 0.05).astype(np.float32)
    R2, t2, s2 = jlie.sim3_mul(*jlie.sim3_exp(jnp.asarray(d)), R, t, s)
    covis = rng.randint(0, 60, (K, K)).astype(np.int32)
    covis = np.triu(covis, 1) + np.triu(covis, 1).T
    parent = np.arange(-1, K - 1).astype(np.int32)
    loops = np.zeros((K, K), bool)
    loops[K - 2, 0] = True
    mask = np.ones(K, bool)
    mask[7] = False
    fixed = np.zeros(K, bool)
    fixed[0] = True
    return [np.asarray(x) for x in (R2, t2, s2, Rm, tm, sm)] + \
        [covis, parent, loops, mask, fixed]


def test_build_essential_edges(graph):
    *_, covis, parent, loops, mask, _ = graph
    for th in (30, 100):
        ej = jpg.build_essential_edges(jnp.asarray(covis), jnp.asarray(parent),
                                       jnp.asarray(loops), jnp.asarray(mask),
                                       covis_th=th)
        et = tpg.build_essential_edges(T(covis), T(parent), T(loops), T(mask),
                                       covis_th=th)
        np.testing.assert_array_equal(N(et), N(ej))


@pytest.mark.parametrize("fix_scale", [False, True])
def test_optimize_essential_graph(graph, fix_scale):
    R, t, s, Rm, tm, sm, covis, parent, loops, mask, fixed = graph
    e = np.asarray(jpg.build_essential_edges(
        jnp.asarray(covis), jnp.asarray(parent), jnp.asarray(loops),
        jnp.asarray(mask), covis_th=30))
    oj = jpg.optimize_essential_graph(
        *(jnp.asarray(x) for x in (R, t, s, e, Rm, tm, sm, fixed, mask)),
        iters=6, fix_scale=fix_scale)
    ot = tpg.optimize_essential_graph(
        *(T(x) for x in (R, t, s, e, Rm, tm, sm, fixed, mask)), iters=6,
        fix_scale=fix_scale)
    for a, b in zip(ot, oj):
        np.testing.assert_allclose(N(a), N(b), atol=1e-5)


def test_optimize_essential_graph_4dof(graph):
    R, t, _, Rm, tm, _, covis, parent, loops, mask, fixed = graph
    e = np.asarray(jpg.build_essential_edges(
        jnp.asarray(covis), jnp.asarray(parent), jnp.asarray(loops),
        jnp.asarray(mask), covis_th=30))
    oj = jpg.optimize_essential_graph_4dof(
        *(jnp.asarray(x) for x in (R, t, e, Rm, tm, fixed, mask)), iters=6)
    ot = tpg.optimize_essential_graph_4dof(
        *(T(x) for x in (R, t, e, Rm, tm, fixed, mask)), iters=6)
    for a, b in zip(ot, oj):
        np.testing.assert_allclose(N(a), N(b), atol=1e-5)


# ---------------------------------------------------------------------------
# PCG bundle adjustment
# ---------------------------------------------------------------------------

def test_ba_pcg_chunk_and_solve():
    """A 12-keyframe problem with 192 landmarks in the keyframe-major layout
    of global BA (each keyframe sees most of them), noisy start. With a
    short baseline, far landmarks are so badly conditioned that the last
    bits of the two libraries' projections move their LM steps by more than
    the tolerance: the baseline is wide on purpose."""
    rng = np.random.RandomState(9)
    P, L, Nk = 12, 192, 160
    X = rng.uniform([-3, -2, 5], [3, 2, 11], (L, 3)).astype(np.float32)
    xi = np.zeros((P, 6), np.float32)
    xi[:, 0] = np.linspace(-3, 3, P)     # a wide baseline: every landmark
    xi[:, 4] = np.linspace(-0.3, 0.3, P)  # is well conditioned
    R, t = (np.asarray(a) for a in jlie.se3_exp(jnp.asarray(xi)))
    obs_lm = np.stack([rng.permutation(L)[:Nk] for _ in range(P)]).astype(
        np.int32)
    xy = np.asarray(jcam.project(JC, jnp.asarray(
        np.einsum('pij,pnj->pni', R, X[obs_lm]) + t[:, None])))
    xy = (xy + rng.randn(P, Nk, 2) * 0.5).astype(np.float32)
    valid = rng.rand(P, Nk) > 0.1
    obs_lm[~valid] = -1
    lm_valid = np.ones(L, bool)
    lm_valid[-8:] = False
    pose_fixed = np.zeros(P, bool)
    pose_fixed[:2] = True
    X0 = (X + rng.randn(L, 3) * 0.05).astype(np.float32)
    t0 = (t + rng.randn(P, 3) * 0.02 * (~pose_fixed)[:, None]).astype(
        np.float32)
    info = (1.2 ** (-2.0 * rng.randint(0, 3, P * Nk))).astype(np.float32)
    okf = np.repeat(np.arange(P), Nk).astype(np.int32)
    olm = np.where(valid, obs_lm, 0).reshape(-1)
    args_j = (jnp.asarray(pose_fixed), jnp.asarray(lm_valid), JC,
              jnp.asarray(okf), jnp.asarray(olm), jnp.asarray(xy.reshape(-1, 2)),
              jnp.asarray(valid.reshape(-1)))
    args_t = (T(pose_fixed), T(lm_valid), TC, T(okf), T(olm),
              T(xy.reshape(-1, 2)), T(valid.reshape(-1)))
    cj = jbal.ba_pcg_chunk((jnp.asarray(R), jnp.asarray(t0), jnp.asarray(X0),
                            jnp.asarray(1e-4)), *args_j,
                           obs_info=jnp.asarray(info), iters=2)
    ct = tbal.ba_pcg_chunk((T(R), T(t0), T(X0), torch.tensor(1e-4)), *args_t,
                           obs_info=T(info), iters=2)
    for a, b in zip(ct, cj):
        np.testing.assert_allclose(N(a), N(b), rtol=1e-4, atol=1e-4)
    sj = jbal.ba_solve_pcg(jnp.asarray(R), jnp.asarray(t0),
                           jnp.asarray(pose_fixed), jnp.asarray(X0),
                           jnp.asarray(lm_valid), JC, *args_j[3:],
                           obs_info=jnp.asarray(info), iters=4)
    st_ = tbal.ba_solve_pcg(T(R), T(t0), T(pose_fixed), T(X0), T(lm_valid),
                            TC, *args_t[3:], obs_info=T(info), iters=4)
    np.testing.assert_allclose(N(st_.t), N(sj.t), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(N(st_.lm_pos), N(sj.lm_pos), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(N(st_.obs_inlier), N(sj.obs_inlier))
    # the solve moved towards the truth
    assert np.abs(N(st_.t) - t).max() < np.abs(t0 - t).max()


def test_landmark_segments_match_reference():
    rng = np.random.RandomState(4)
    ids = rng.randint(0, 50, 400).astype(np.int32)
    valid = rng.rand(400) > 0.2
    pj = jbal._landmark_segments(jnp.asarray(ids), jnp.asarray(valid), 50)
    pt = tbal._landmark_segments(T(ids), T(valid), 50)
    for a, b in zip(pt, pj):
        np.testing.assert_array_equal(N(a), N(b))
    vals = rng.randn(400, 3).astype(np.float32)
    np.testing.assert_allclose(
        N(tbal._segsum(T(vals)[pt[0]], pt[1], pt[2])),
        N(jbal._segsum(jnp.asarray(vals)[pj[0]], pj[1], pj[2])), atol=1e-5)
