"""The in-repo YAML-subset reader against PyYAML on the calibration and
config documents the repo writes and reads."""
import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import pytest

from slam_eds_tpu.config import EDSConfig, load_config
from slam_eds_tpu.io import yaml_subset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MONO_CALIB = """cam0:
  intrinsics: [110.0, 110.0, 63.5, 47.5]
  resolution: [128, 96]
  distortion_model: radtan
  distortion_coeffs: [0, 0, 0, 0]
"""

DUAL_CALIB = MONO_CALIB + """cam1:
  intrinsics: [110.0, 110.0, 63.5, 47.5]
  resolution: [128, 96]
  distortion_model: none
  T_cn_cnm1: [[1, 0, 0, 0], [0, 1, 0, 0],
              [0, 0, 1, 0], [0, 0, 0, 1]]
"""

KALIBR_CAMCHAIN = """# kalibr camchain with block lists at the key's indent
cam0:
  T_cam_imu:
  - [0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975]
  - [0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768]
  - [-0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949]
  - [0.0, 0.0, 0.0, 1.0]
  cam_overlaps: [1]
  camera_model: pinhole
  distortion_coeffs: [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05]
  distortion_model: radtan
  intrinsics: [458.654, 457.296, 367.215, 248.375]
  resolution: [752, 480]
  rostopic: /cam0/image_raw   # comment after a value
  flip: false
cam1:
  distortion_coeffs:
    - -0.28368365
    - 0.07451284
  name: 'event # camera'
  note: "a: b"
  timeshift_cam_imu: null
"""


def _config_yaml():
    yaml = pytest.importorskip("yaml")

    def plain(x):
        if isinstance(x, dict):
            return {k: plain(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [plain(v) for v in x]
        return x
    return yaml.safe_dump(plain(dataclasses.asdict(EDSConfig())),
                          default_flow_style=False)


def _dataset_calib(tmp_path):
    from slam_eds_tpu.io.dataset import SyntheticSequence
    from slam_eds_tpu.utils.cameras import Pinhole
    cam = Pinhole(jnp.float32(30.0), jnp.float32(30.0), jnp.float32(15.5),
                  jnp.float32(11.5), 32, 24)
    d = SyntheticSequence(cam, num_frames=2).write_dataset(
        str(tmp_path / "seq"), events=False)
    with open(os.path.join(d, "calib.yaml")) as f:
        return f.read()


@pytest.mark.parametrize("doc", ["mono", "dual", "kalibr", "config",
                                 "dataset"])
def test_matches_pyyaml(doc, tmp_path):
    yaml = pytest.importorskip("yaml")
    text = {"mono": lambda: MONO_CALIB, "dual": lambda: DUAL_CALIB,
            "kalibr": lambda: KALIBR_CAMCHAIN, "config": _config_yaml,
            "dataset": lambda: _dataset_calib(tmp_path)}[doc]()
    assert yaml_subset.loads(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", ["a: {x: 1}", "- a: 1", "a: &x 1",
                                  "a: [1, 2", "a: |\n  text",
                                  "a: 1\n   b: 2"])
def test_outside_the_subset_raises(text):
    with pytest.raises(ValueError):
        yaml_subset.loads(text)


def test_scalars_and_empty_documents():
    assert yaml_subset.loads("") is None
    assert yaml_subset.loads("# only a comment\n") is None
    got = yaml_subset.loads("a: 1e-5\nb: -3\nc: true\nd: ~\n"
                            "f: '1'\ng: x y\n")
    assert got == {"a": 1e-5, "b": -3, "c": True, "d": None, "f": "1",
                   "g": "x y"}


def test_load_config_from_file(tmp_path):
    path = tmp_path / "cfg.yaml"
    path.write_text("bundles:\n  window_size: 5\n"
                    "coarse:\n  max_iterations: [1, 2, 3]\n"
                    "tracker:\n  loss:\n    kind: cauchy\n")
    cfg = load_config(str(path))
    assert cfg.bundles.window_size == 5
    assert cfg.coarse.max_iterations == (1, 2, 3)
    assert cfg.tracker.loss.kind == "cauchy"
    assert cfg.mapping == EDSConfig().mapping


def test_main_path_imports_without_pyyaml():
    code = ("import sys; sys.modules['yaml'] = None; "
            "import slam_eds_tpu.runner, slam_eds_tpu.config, "
            "slam_eds_tpu.utils.calib; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
