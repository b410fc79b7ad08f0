"""The port's copy of the TUM / KITTI sequence readers
(mc_slam_tpu_torch/io/datasets.py) against tests/test_datasets.py's two
cases, and against the JAX package's readers on the same folders: equal
outputs (host strings and floats, compared exactly)."""
import os

from mc_slam_tpu.io import datasets as jds
from mc_slam_tpu_torch.io import datasets as tds

from test_datasets import _write


def _tum_folder(root):
    _write(os.path.join(root, "rgb.txt"),
           "# comment\n"
           "100.00 rgb/100.00.png\n"
           "100.05 rgb/100.05.png\n"
           "100.10 rgb/100.10.png\n")
    _write(os.path.join(root, "depth.txt"),
           "100.008 depth/100.008.png\n"
           "100.30 depth/100.30.png\n")


def test_tum_reader_and_depth_association(tmp_path):
    root = str(tmp_path)
    _tum_folder(root)
    seq = tds.load_tum_sequence(root)
    assert len(seq) == 3
    assert seq[0][0] == 100.0
    assert seq[0][1].endswith("rgb/100.00.png")
    # with depth: only the first rgb frame has a depth within 0.02 s
    seq_d = tds.load_tum_sequence(root, with_depth=True)
    assert len(seq_d) == 1
    assert seq_d[0][2].endswith("depth/100.008.png")
    assert seq == jds.load_tum_sequence(root)
    assert seq_d == jds.load_tum_sequence(root, with_depth=True)
    for max_diff in (0.001, 0.2):
        assert (tds.load_tum_sequence(root, with_depth=True, max_diff=max_diff)
                == jds.load_tum_sequence(root, with_depth=True, max_diff=max_diff))


def test_kitti_reader(tmp_path):
    root = str(tmp_path)
    _write(os.path.join(root, "times.txt"), "0.0\n0.103\n0.207\n")
    seq = tds.load_kitti_sequence(root)
    assert len(seq) == 3
    assert seq[1][0] == 0.103
    assert seq[2][1].endswith(os.path.join("image_0", "000002.png"))
    assert seq == jds.load_kitti_sequence(root)
    assert tds.load_kitti_sequence(root, cam="image_1") == jds.load_kitti_sequence(
        root, cam="image_1")
    assert tds.TUM_CAMERAS == jds.TUM_CAMERAS and tds.KITTI_CAMERAS == jds.KITTI_CAMERAS
