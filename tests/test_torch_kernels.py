"""The port's kernels (dani_slam_tpu_torch/ops/kernels.py) against the JAX
package's Pallas kernels.

On the CPU the wrappers run their plain PyTorch versions; those are held
against pallas_kernels.* in interpret mode and against the *_xla oracles,
with the tolerances of tests/test_pallas_kernels.py (exact indices,
distances within 2e-2, block sums within rtol/atol 1e-5). The CUDA kernels
themselves are compared with the plain versions on the card by
tests/test_torch_cuda.py; what of them can be checked without a card is
checked here: the rule by which the tensor-core window match is held
against its plain version (kernels.window_match_agreement), and the
sort-free algorithm of the device reduction plan, run in Python.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dani_slam_tpu.ops import pallas_kernels as pk
from dani_slam_tpu_torch.ops import kernels


def make_problem(M=300, N=700, D=64, seed=0):
    """The cases of tests/test_pallas_kernels.py: unit descriptors with
    planted exact matches for the first min(M, N) // 2 rows."""
    rng = np.random.RandomState(seed)
    q = rng.randn(M, D).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    t = rng.randn(N, D).astype(np.float32)
    t /= np.linalg.norm(t, axis=1, keepdims=True)
    k = min(M, N) // 2
    t[:k] = q[:k]
    qxy = rng.uniform(0, 640, (M, 2)).astype(np.float32)
    txy = rng.uniform(0, 640, (N, 2)).astype(np.float32)
    txy[:k] = qxy[:k] + rng.randn(k, 2) * 2
    qv = rng.rand(M) > 0.1
    tv = rng.rand(N) > 0.1
    return q, qxy, qv, t, txy, tv


def _torch(args, device="cpu"):
    return tuple(torch.as_tensor(a, device=device) for a in args)


def _np(outs):
    return tuple(np.asarray(o.cpu()) if isinstance(o, torch.Tensor)
                 else np.asarray(o) for o in outs)


def _assert_window_match_close(a, b, atol):
    b1, s1, i1, cb1, ci1 = a
    b2, s2, i2, cb2, ci2 = b
    found = b2 < 1e8
    np.testing.assert_array_equal(b1 < 1e8, found)
    np.testing.assert_array_equal(i1[found], i2[found])
    np.testing.assert_allclose(b1[found], b2[found], atol=atol)
    sel = found & (s2 < 1e8)
    np.testing.assert_array_equal((s1 < 1e8)[found], sel[found])
    np.testing.assert_allclose(s1[sel], s2[sel], atol=atol)
    cfound = cb2 < 1e8
    np.testing.assert_array_equal(cb1 < 1e8, cfound)
    np.testing.assert_array_equal(ci1[cfound], ci2[cfound])
    np.testing.assert_allclose(cb1[cfound], cb2[cfound], atol=atol)


class TestWindowMatchPlain:
    @pytest.mark.parametrize("radius", ["scalar", "per_query"])
    def test_matches_pallas_interpret_and_oracle(self, radius):
        args = make_problem()
        r = (np.float32(10.0) if radius == "scalar" else
             (4.0 * 1.2 ** np.random.RandomState(5).randint(0, 4, 300))
             .astype(np.float32))
        jargs = tuple(jnp.asarray(a) for a in args)
        out_k = _np(pk.window_match_topk2(*jargs, r, interpret=True))
        out_x = _np(pk.window_match_topk2_xla(*jargs, r))
        out_t = _np(kernels.window_match_topk2_ref(*_torch(args),
                                                   torch.as_tensor(r)))
        _assert_window_match_close(out_t, out_k, atol=2e-2)
        _assert_window_match_close(out_t, out_x, atol=2e-2)

    def test_col_outputs_multi_rowblock(self):
        """Column winners merge across row blocks (M > the TPU tile TM)."""
        args = make_problem(M=2 * pk.TM + 17, N=300, seed=7)
        jargs = tuple(jnp.asarray(a) for a in args)
        *_, cb1, ci1 = _np(pk.window_match_topk2(*jargs, 25.0,
                                                 interpret=True))
        *_, cb2, ci2 = _np(kernels.window_match_topk2_ref(*_torch(args),
                                                          25.0))
        cf = cb1 < 1e8
        np.testing.assert_array_equal(cb2 < 1e8, cf)
        np.testing.assert_array_equal(ci2[cf], ci1[cf])
        np.testing.assert_allclose(cb2[cf], cb1[cf], atol=2e-2)

    def test_planted_matches_found(self):
        q, qxy, _, t, txy, _ = make_problem(M=128, N=256, seed=3)
        b, _, i, _, _ = kernels.window_match_topk2_ref(
            *_torch((q, qxy, np.ones(128, bool), t, txy, np.ones(256, bool))),
            10.0)
        hits = (i[:64].numpy() == np.arange(64)) & (b[:64].numpy() < 0.3)
        assert hits.mean() > 0.9

    def test_no_valid_targets(self):
        q, qxy, qv, t, txy, _ = make_problem(M=64, N=128)
        b, s, i, cb, ci = kernels.window_match_topk2_ref(
            *_torch((q, qxy, qv, t, txy, np.zeros(128, bool))), 10.0)
        assert float(b.min()) >= 1e8 and float(cb.min()) >= 1e8
        assert int(ci.abs().max()) == 0      # no admissible row: index 0

    def test_per_query_radius(self):
        q, qxy, _, t, txy, _ = make_problem(M=64, N=128, seed=4)
        b, *_ = kernels.window_match_topk2_ref(
            *_torch((q, qxy, np.ones(64, bool), t, txy, np.ones(128, bool))),
            torch.full((64,), 0.001))
        assert float(b.min()) >= 1e8     # planted targets are ~2 px away

    def test_wrapper_on_cpu_takes_plain_version(self):
        args = _torch(make_problem(M=100, N=90, seed=2))
        before = kernels.window_match_topk2.launches
        out_w = kernels.window_match_topk2(*args, 30.0)
        out_r = kernels.window_match_topk2_ref(*args, 30.0)
        assert kernels.window_match_topk2.launches == before
        for a, b in zip(out_w, out_r):
            assert torch.equal(a, b)

    def test_packed_column_winners_order(self):
        """The CUDA kernel keeps column winners as a 64-bit atomicMin of
        (float_bits(dist) << 32) | row from an initial (bits(BIG) << 32) | 0.
        Emulated here with an amin over rows, the packing must give the
        oracle's (min distance, first row reaching it), and row 0 for a
        column no row may reach."""
        q, qxy, qv, t, txy, tv = make_problem(M=200, N=150, D=32, seed=9)
        q[50] = q[10]              # an exact tie between rows 10 and 50
        qxy[50] = qxy[10]
        args = _torch((q, qxy, qv, t, txy, tv))
        _, _, _, cbest, cidx = kernels.window_match_topk2_ref(*args, 40.0)
        q_, qxy_, qv_, t_, txy_, tv_ = args
        qb = q_.to(torch.bfloat16).float()
        tb = t_.to(torch.bfloat16).float()
        dist = torch.clamp(2.0 - 2.0 * (qb @ tb.T), min=0.0)
        d2 = ((qxy_[:, None] - txy_[None]) ** 2).sum(-1)
        ok = (d2 <= 1600.0) & qv_[:, None] & tv_[None, :]
        dist = torch.where(ok, dist, torch.full_like(dist, kernels.BIG))
        rows = torch.arange(200, dtype=torch.int64)[:, None]
        packed = (dist.view(torch.int32).to(torch.int64) << 32) | rows
        init = torch.full((150,), kernels._BIG_PACKED, dtype=torch.int64)
        win = torch.minimum(torch.amin(packed, dim=0), init)
        cb_k, ci_k = kernels.unpack_col_winners(win)
        found = cbest < 1e8
        assert torch.equal(cb_k < 1e8, found)
        assert torch.equal(ci_k[found], cidx[found])
        np.testing.assert_allclose(cb_k[found].numpy(), cbest[found].numpy(),
                                   atol=1e-6)
        assert int(ci_k[~found].abs().sum()) == 0


class TestWindowMatchAgreement:
    """The rule that holds the CUDA kernel (f32 sums of the exact bf16
    products in the tensor cores' order) against the plain version
    (ascending-k sums): distances within atol 1e-4, an index free only on a
    near-tie. Stand-in for the kernel here: one f32 matmul, whose sum runs
    in yet another order."""

    RADIUS = 40.0

    def _case(self):
        q, qxy, qv, t, txy, tv = make_problem(M=200, N=150, D=64, seed=11)
        qv[:] = True
        tv[:] = True
        t[7], txy[7] = t[5], txy[5]       # row 5: columns 5 and 7 tie exactly
        q[50], qxy[50] = q[10], qxy[10]   # column 10: rows 10 and 50 tie
        args = _torch((q, qxy, qv, t, txy, tv))
        ref_dist = kernels.window_match_dist_ref(*args, self.RADIUS)
        ref_out = kernels.window_match_reduce_ref(ref_dist)
        qb = args[0].to(torch.bfloat16).float()
        tb = args[3].to(torch.bfloat16).float()
        alt = torch.clamp(2.0 - 2.0 * (qb @ tb.T), min=0.0)
        alt = torch.where(ref_dist < 1e8, alt,
                          torch.full_like(alt, kernels.BIG))
        out = [o.clone() for o in kernels.window_match_reduce_ref(alt)]
        return out, ref_out, ref_dist

    def test_accepts_another_summation_order(self):
        out, ref_out, ref_dist = self._case()
        assert float(ref_dist[5, 5]) == float(ref_dist[5, 7]) < 1e-3
        assert int(ref_out[2][5]) == 5 and int(ref_out[4][10]) == 10
        res = kernels.window_match_agreement(out, ref_out, ref_dist)
        assert res["ok"], res
        assert res["max_abs_err"] <= 1e-4
        same = kernels.window_match_agreement(ref_out, ref_out, ref_dist)
        assert same["ok"] and same["max_abs_err"] == 0.0
        assert same["idx_differ"] == same["col_idx_differ"] == 0

    @pytest.mark.parametrize("which,row,other", [("idx", 5, 7),
                                                 ("col_idx", 10, 50)])
    def test_accepts_the_other_side_of_an_exact_tie(self, which, row, other):
        out, ref_out, ref_dist = self._case()
        out = list(ref_out)
        k = 2 if which == "idx" else 4
        out[k] = ref_out[k].clone()
        out[k][row] = other
        res = kernels.window_match_agreement(out, ref_out, ref_dist)
        assert res["ok"], res
        assert res[which + "_differ"] == 1

    @pytest.mark.parametrize("which", ["idx", "col_idx"])
    def test_rejects_one_wrong_index(self, which):
        out, ref_out, ref_dist = self._case()
        k, dim = (2, 1) if which == "idx" else (4, 0)
        found = torch.nonzero(ref_out[0 if dim else 3] < 1e8)[:, 0]
        i = int(found[3])
        line = ref_dist[i] if dim else ref_dist[:, i]
        out[k][i] = int(torch.argmax(line))      # a far or inadmissible pair
        res = kernels.window_match_agreement(out, ref_out, ref_dist)
        assert not res["ok"] and which in res["why"][0]

    @pytest.mark.parametrize("k,name", [(0, "best"), (1, "second"),
                                        (3, "col_best")])
    def test_rejects_one_distance_off_by_1e_3(self, k, name):
        out, ref_out, ref_dist = self._case()
        i = int(torch.nonzero(ref_out[k] < 1e8)[2, 0])
        out[k][i] += 1e-3
        res = kernels.window_match_agreement(out, ref_out, ref_dist)
        assert not res["ok"] and name in res["why"][0]

    def test_rejects_a_found_set_that_differs_or_an_index_out_of_range(self):
        out, ref_out, ref_dist = self._case()
        i = int(torch.nonzero(ref_out[0] < 1e8)[0, 0])
        out[0][i] = kernels.BIG
        assert not kernels.window_match_agreement(out, ref_out,
                                                  ref_dist)["ok"]
        out, ref_out, ref_dist = self._case()
        out[2][0] = ref_dist.shape[1]
        assert not kernels.window_match_agreement(out, ref_out,
                                                  ref_dist)["ok"]


def lba_problem(P=4, N=256, L=512, seed=0):
    rng = np.random.default_rng(seed)
    row_lm = rng.integers(0, L, size=(P, N)).astype(np.int32)
    row_lm[rng.random((P, N)) < 0.3] = -1
    vals = rng.standard_normal((P, N, 30)).astype(np.float32)
    return row_lm, vals


class TestLbaLandmarkBlocksPlain:
    @pytest.mark.parametrize("shape", [(4, 256, 512), (3, 100, 77)])
    def test_matches_pallas_interpret_and_oracle(self, shape):
        P, N, L = shape
        row_lm, vals = lba_problem(P, N, L)
        out_t = _np(kernels.lba_landmark_blocks_ref(
            torch.as_tensor(row_lm), torch.as_tensor(vals), L))
        out_x = _np(pk.lba_landmark_blocks_xla(jnp.asarray(row_lm),
                                               jnp.asarray(vals), L))
        refs = [out_x]
        if L % 256 == 0 and N % 128 == 0:      # the Pallas kernel's tiling
            refs.append(_np(pk.lba_landmark_blocks(
                jnp.asarray(row_lm), jnp.asarray(vals), L, interpret=True)))
        for ref in refs:
            for a, b in zip(out_t, ref):
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)

    def test_matches_float64_einsums(self):
        P, N, L = 3, 128, 256
        row_lm, vals = lba_problem(P, N, L, seed=1)
        H, g, W = _np(kernels.lba_landmark_blocks_ref(
            torch.as_tensor(row_lm), torch.as_tensor(vals), L))
        onehot = (row_lm[:, :, None] == np.arange(L)).astype(np.float64)
        v = vals.astype(np.float64)
        np.testing.assert_allclose(
            H, np.einsum('pnl,pnij->lij', onehot,
                         v[..., :9].reshape(P, N, 3, 3)),
            rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(
            g, np.einsum('pnl,pnk->lk', onehot, v[..., 9:12]),
            rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(
            W, np.einsum('pnl,pnik->plik', onehot,
                         v[..., 12:].reshape(P, N, 6, 3)),
            rtol=1e-4, atol=1e-4)

    def test_plan_segmented_reduction(self):
        """The CUDA kernel's algorithm, run in Python: walk each landmark's
        segment of the stable (landmark, row) order, summing the 12 H_ll/g_l
        channels over the segment and flushing the 18 H_pl channels at every
        change of row. Must equal the plain version (duplicate ids within a
        row included)."""
        P, N, L = 5, 60, 40
        row_lm, vals = lba_problem(P, N, L, seed=3)
        row_lm[2, :10] = 7                      # duplicates within a row
        row_lm[:, -1] = L + 3                   # out of range: ignored
        perm, lm_off = kernels.lba_plan(torch.as_tensor(row_lm), L)
        perm, lm_off = perm.numpy(), lm_off.numpy()
        flat = vals.reshape(-1, 30)
        out12 = np.zeros((L, 12), np.float32)
        hpl = np.zeros((P, L, 18), np.float32)
        for lm in range(L):
            seg = perm[lm_off[lm]:lm_off[lm + 1]]
            assert np.all(row_lm.reshape(-1)[seg] == lm)
            assert np.all(np.diff(seg) > 0)      # rows, then n, ascending
            for o in seg:
                out12[lm] += flat[o, :12]
                hpl[o // N, lm] += flat[o, 12:]
        assert lm_off[-1] == int(np.sum((row_lm >= 0) & (row_lm < L)))
        H, g, W = _np(kernels.lba_landmark_blocks_ref(
            torch.as_tensor(np.where(row_lm < L, row_lm, -1)),
            torch.as_tensor(vals), L))
        np.testing.assert_allclose(out12[:, :9].reshape(L, 3, 3), H,
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(out12[:, 9:], g, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(hpl.reshape(P, L, 6, 3), W, rtol=1e-5,
                                   atol=1e-5)

    @pytest.mark.parametrize("case", ["random", "duplicates_out_of_range",
                                      "no_valid", "all_one_landmark"])
    def test_device_plan_algorithm_equals_sort(self, case):
        """The device plan's algorithm, run in Python: integer histogram of
        the ids, exclusive scan to the segment offsets, fill of the segments
        one keyframe row after the other, within a row in an arbitrary order
        (the order in which atomics hand out slots, here a shuffle), then
        within every run of entries of one row the rank by counting the
        smaller flat ids, and ordered compaction of the observations
        without a landmark. Whatever the fill order, it must equal the
        plain version's stable sort and binary search."""
        P, N, L = 5, 60, 40
        row_lm, _ = lba_problem(P, N, L, seed=6)
        if case == "duplicates_out_of_range":
            row_lm[2, :10] = 7
            row_lm[:, -1] = L + 3
            row_lm[0, 0] = L
        elif case == "no_valid":
            row_lm[:] = -1
        elif case == "all_one_landmark":
            row_lm[:] = 3
        perm_r, off_r = kernels.lba_plan(torch.as_tensor(row_lm), L)
        flat = row_lm.reshape(-1)
        ok = (flat >= 0) & (flat < L)
        cnt = np.zeros(L + 1, np.int64)
        np.add.at(cnt, np.where(ok, flat, L), 1)
        off = np.concatenate([[0], np.cumsum(cnt)])[:L + 1]
        np.testing.assert_array_equal(off, off_r.numpy())
        for shuffle in range(3):
            rng = np.random.default_rng(shuffle)
            cur = off.copy()
            fill = np.full(P * N, -1)
            for p in range(P):
                for o in p * N + rng.permutation(N):
                    if ok[o]:
                        fill[cur[flat[o]]] = o
                        cur[flat[o]] += 1
            perm = np.full(P * N, -1)
            for k in range(off[L]):
                o = fill[k]
                s, e = off[flat[o]], off[flat[o]] + cnt[flat[o]]
                lo, hi = o // N * N, o // N * N + N
                a, b = k, k + 1
                while a > s and fill[a - 1] >= lo:
                    a -= 1
                while b < e and fill[b] < hi:
                    b += 1
                perm[a + int(np.sum(fill[a:b] < o))] = o
            perm[off[L]:] = np.flatnonzero(~ok)
            np.testing.assert_array_equal(perm, perm_r.numpy())

    def test_plan_wrapper_on_cpu_takes_plain_version(self):
        row_lm = torch.as_tensor(lba_problem(3, 32, 20, seed=8)[0])
        before = kernels.lba_plan.launches
        for a, b in zip(kernels.lba_plan(row_lm, 20),
                        kernels.lba_plan_ref(row_lm, 20)):
            assert torch.equal(a, b)
        assert kernels.lba_plan.launches == before
        with pytest.raises(ValueError, match="unsupported device"):
            kernels.lba_plan(torch.zeros((2, 4), dtype=torch.int32,
                                         device="meta"), 8)

    def test_wrapper_on_cpu_takes_plain_version(self):
        row_lm, vals = lba_problem(2, 64, 50, seed=4)
        row_lm = torch.as_tensor(row_lm)
        before = kernels.lba_landmark_blocks.launches
        out_w = kernels.lba_landmark_blocks(row_lm, torch.as_tensor(vals), 50,
                                            kernels.lba_plan(row_lm, 50))
        out_r = kernels.lba_landmark_blocks_ref(row_lm,
                                                torch.as_tensor(vals), 50)
        assert kernels.lba_landmark_blocks.launches == before
        for a, b in zip(out_w, out_r):
            assert torch.equal(a, b)


def test_window_match_refuses_empty_targets():
    q, qxy, qv, t, txy, tv = _torch(make_problem(M=8, N=8, D=8))
    with pytest.raises(ValueError, match="no targets"):
        kernels.window_match_topk2(q, qxy, qv, t[:0], txy[:0], tv[:0], 5.0)


def test_wrappers_refuse_other_devices():
    args = _torch(make_problem(M=8, N=8, D=8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.window_match_topk2(*args, 5.0)
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.lba_landmark_blocks(torch.zeros((2, 4), dtype=torch.int32,
                                                device="meta"),
                                    torch.zeros((2, 4, 30), device="meta"), 8,
                                    None)
