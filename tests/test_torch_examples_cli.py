"""The port's dataset runners (python -m dani_slam_tpu_torch.examples.*) on
the cases of tests/test_examples_cli.py: the same generated TUM and KITTI
sequences (PGM images, written by that file's fixtures into a temporary
directory), run with --device cpu in a subprocess. The trajectory files must
have the JAX runners' formats and a row per tracked frame at the sequence's
absolute timestamps; evaluate_ate prints what the JAX package's prints on
the same files. The runner also takes the public checkpoint layouts
(--superpoint-pt, --lightglue-pt, --yolov5-pt), here the shipped weights
written in those layouts, and refuses --device cuda without a card and the
options whose modules are not ported (--time-stats, --viz).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_examples_cli import kitti_dataset, tum_dataset  # noqa: F401
from test_torch_official_models import lightglue_public_state_dict, \
    yolov5_public_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_port(module, args, timeout=600):
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "-m", f"dani_slam_tpu_torch.examples.{module}"] +
        [str(a) for a in args], capture_output=True, text=True, env=env,
        cwd=REPO, timeout=timeout)


def _rgbd(tum, out, *extra):
    return run_port("rgbd_tum", [tum / "settings.yaml", tum,
                                 tum / "assoc.txt", "--out-prefix", out,
                                 "--device", "cpu", *extra])


class TestRgbdTumCLI:
    def test_full_run(self, tum_dataset, tmp_path):  # noqa: F811
        out = str(tmp_path) + "/"
        r = _rgbd(tum_dataset, out)
        assert r.returncode == 0, r.stderr[-2000:]
        assert "device cpu" in r.stdout
        traj = np.loadtxt(out + "CameraTrajectory.txt")
        assert traj.shape[0] >= 4 and traj.shape[1] == 8
        want = [float(line.split()[0]) for line in
                (tum_dataset / "assoc.txt").read_text().splitlines()]
        np.testing.assert_allclose(traj[:, 0], want[:traj.shape[0]],
                                   atol=1e-6)
        assert os.path.exists(out + "ExecMean.txt")
        stats = np.loadtxt(out + "TrackingTimeStats.txt", comments="#")
        assert stats.shape == (5,)

    def test_evaluate_ate_cli(self, tum_dataset, tmp_path):  # noqa: F811
        """Self-comparison gives 0; the output equals the JAX package's
        evaluate_ate on the same files (the runner's trajectory against a
        perturbed copy of it)."""
        out = str(tmp_path) + "/"
        r = _rgbd(tum_dataset, out, "--max-frames", "4")
        assert r.returncode == 0, r.stderr[-2000:]
        est = out + "CameraTrajectory.txt"
        r2 = run_port("evaluate_ate", [est, est])
        assert r2.returncode == 0, r2.stderr[-1000:]
        line = [ln for ln in r2.stdout.splitlines() if "rmse" in ln][0]
        assert float(line.split()[1]) < 1e-6
        rows = np.loadtxt(est)
        rows[:, 1:4] += np.random.RandomState(0).normal(0, 0.01,
                                                        rows[:, 1:4].shape)
        gt = str(tmp_path / "gt.txt")
        np.savetxt(gt, rows, fmt="%.7f")
        for scale in ([], ["--scale"]):
            mine = run_port("evaluate_ate", [gt, est] + scale)
            ref = subprocess.run([sys.executable, f"{REPO}/examples/"
                                  "evaluate_ate.py", gt, est] + scale,
                                 capture_output=True, text=True, cwd=REPO,
                                 timeout=300)
            assert mine.returncode == ref.returncode == 0, ref.stderr
            assert mine.stdout == ref.stdout

    def test_public_checkpoints(self, tum_dataset, tmp_path):  # noqa: F811
        """--superpoint-pt, --lightglue-pt and --yolov5-pt: the shipped
        SuperPoint, official LightGlue and yolov5s written as MagicLeap,
        cvg/LightGlue and ultralytics files, run through the runner on the
        fixture's frames in colour."""
        from dani_slam_tpu_torch.models import lightglue_official as tlo
        from dani_slam_tpu_torch.models import superpoint as tsp
        from dani_slam_tpu_torch.models import yolo_official as tyo
        sp, lg, yo = (str(tmp_path / n) for n in
                      ("superpoint_v1.pth", "lightglue.pt", "yolov5s.pt"))
        torch.save(tsp.load_default_params("cpu").state_dict(), sp)
        torch.save({"state_dict": lightglue_public_state_dict(
            tlo.load_official_matcher(device="cpu").model)}, lg)
        torch.save({"model": yolov5_public_state_dict(
            tyo.load_official_detector(device="cpu").model)}, yo)
        # the detector needs colour: the fixture's frames as PPM
        from dani_slam_tpu_torch.utils.io import load_image
        seq = tmp_path / "seq"
        os.makedirs(seq / "rgb")
        lines = (tum_dataset / "assoc.txt").read_text().splitlines()
        for line in lines:
            rel = line.split()[1]
            gray = load_image(str(tum_dataset / rel))
            with open(seq / rel.replace(".pgm", ".ppm"), "wb") as f:
                f.write(f"P6\n{gray.shape[1]} {gray.shape[0]}\n255\n"
                        .encode() + np.repeat(gray[..., None], 3,
                                              -1).tobytes())
        os.symlink(tum_dataset / "depth", seq / "depth")
        (seq / "assoc.txt").write_text("\n".join(
            ln.replace(".pgm ", ".ppm ", 1) for ln in lines))
        (seq / "settings.yaml").write_text(
            (tum_dataset / "settings.yaml").read_text())
        out = str(tmp_path) + "/"
        r = _rgbd(seq, out, "--superpoint-pt", sp, "--lightglue-pt", lg,
                  "--yolov5-pt", yo)
        assert r.returncode == 0, r.stderr[-2000:]
        traj = np.loadtxt(out + "CameraTrajectory.txt")
        assert traj.shape[0] >= 4 and np.isfinite(traj).all()

    @pytest.mark.parametrize("flag", ["--time-stats", "--viz"])
    def test_unported_options_refused(self, tum_dataset, tmp_path,  # noqa
                                      flag):
        r = _rgbd(tum_dataset, str(tmp_path) + "/", flag)
        assert r.returncode == 2
        assert flag in r.stderr and "ROADMAP" in r.stderr
        assert not os.path.exists(str(tmp_path) + "/CameraTrajectory.txt")

    def test_cuda_without_a_card_fails(self, tum_dataset, tmp_path):  # noqa
        if torch.cuda.is_available():
            pytest.skip("this host has a card: --device cuda is usable")
        r = run_port("rgbd_tum", [tum_dataset / "settings.yaml", tum_dataset,
                                  tum_dataset / "assoc.txt", "--out-prefix",
                                  str(tmp_path) + "/"])
        assert r.returncode != 0
        assert "torch.cuda.is_available() is False" in r.stderr


class TestMonoTumCLI:
    def test_full_run(self, tum_dataset, tmp_path):  # noqa: F811
        """examples/mono_tum.py's configuration (the settings' pyramid: one
        level here) on the RGB-D fixture's rgb.txt."""
        out = str(tmp_path) + "/"
        r = run_port("mono_tum", [tum_dataset / "settings.yaml", tum_dataset,
                                  "--out-prefix", out, "--device", "cpu"])
        assert r.returncode == 0, r.stderr[-2000:]
        assert "device cpu" in r.stdout
        traj = np.loadtxt(out + "CameraTrajectory.txt", ndmin=2)
        assert traj.shape[1] == 8 and traj.shape[0] >= 1
        assert np.isfinite(traj).all()


class TestStereoKittiCLI:
    def test_full_run(self, kitti_dataset, tmp_path):  # noqa: F811
        out = str(tmp_path) + "/"
        r = run_port("stereo_kitti", [kitti_dataset / "settings.yaml",
                                      kitti_dataset, "--out-prefix", out,
                                      "--device", "cpu"])
        assert r.returncode == 0, r.stderr[-2000:]
        traj = np.loadtxt(out + "CameraTrajectory.txt")
        # KITTI format: 12 numbers per row (3x4 pose)
        assert traj.shape[0] >= 4 and traj.shape[1] == 12
