"""chip_smoke.py's phases 3 and 4 on the CPU at a tiny size (96x128, 384
points, 8k-event packets): the card is replaced by one virtual CPU device
and the reference by another, so the comparisons run exactly as on a GPU.
The card itself is reached only by running ``python chip_smoke.py``."""
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

H, W, P, N = 96, 128, 384, 8192

TINY_CONFIG = {
    "caps": {"max_points_per_kf": P, "max_immature_per_kf": 512,
             "max_window_frames": 6},
    "bundles": {"window_size": 4, "min_frames": 3},
    "coarse": {"pyr_levels": 4, "max_iterations": [10, 20, 30, 30]},
    "selector": {"desired_immature_density": 400.0,
                 "desired_point_density": 300.0},
    "event_frame": {"num_levels": 2},
    "tracker": {"max_iterations": [15, 10], "max_step_translation": 0.5},
}


@pytest.fixture
def devices():
    """(device under test, reference device): two CPU devices."""
    import jax
    cpus = jax.devices("cpu")
    return cpus[min(1, len(cpus) - 1)], cpus[0]


def _assert_ok(checks):
    assert checks and all(c.ok for c in checks), checks


def test_sampler_check(devices):
    _assert_ok(chip_smoke.check_sampler(devices[0], H, W, P))


def test_raster_check(devices):
    _assert_ok(chip_smoke.check_raster(devices[0], H, W, N))


def test_ba_check(devices):
    _assert_ok(chip_smoke.check_ba(devices[0], devices[1], H, W, P))


def test_event_solve_check(devices):
    _assert_ok(chip_smoke.check_event_solve(devices[0], devices[1], H, W, P))


def test_report_fails_on_nan_and_excess():
    ok = chip_smoke.Check("a", 0.5, 1.0)
    chip_smoke._report("t", [ok])
    for bad in (chip_smoke.Check("b", 2.0, 1.0),
                chip_smoke.Check("c", float("nan"), 1.0)):
        with pytest.raises(AssertionError):
            chip_smoke._report("t", [ok, bad])


def test_e2e_phase(tmp_path):
    res = chip_smoke.e2e_phase(str(tmp_path), W, H, num_frames=10, events=N,
                               motion_scale=0.35, micro_steps=4,
                               config=TINY_CONFIG, ate_bound=0.2)
    assert res["frames"] == 10 and res["packets"] >= 3


def test_refuses_to_run_without_gpu(tmp_path):
    """With no GPU, and with chip_smoke.py alone in a directory, the script
    exits non-zero and prints no result line."""
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), alone)
    for cwd in (ROOT, str(alone)):
        out = subprocess.run(
            [sys.executable, os.path.join(cwd, "chip_smoke.py")], cwd=cwd,
            env={**os.environ, "JAX_PLATFORMS": "cpu"},
            capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


@pytest.mark.gpu
def test_kernel_phase_on_gpu(gpu_device):
    """Phase 3 at the reference widths, card against this process's CPU."""
    import jax
    chip_smoke.kernel_phase(gpu_device, jax.devices("cpu")[0], 640, 480,
                            2048, 65536)
