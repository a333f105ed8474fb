"""Calibration loading: per-camera info, frame+event dual-camera rigs, the
common-view rectified geometry, and photometric calibration.

Counterpart of reference src/utils/Calib.{hpp,cpp}:
* ``CameraInfo`` (K, D, R, P, T_cam_imu, flip — Calib.hpp:38-56) -> a plain
  dataclass parsed from the same YAML schema (`readCameraCalib`,
  Calib.cpp:65-103),
* ``DualCamera`` rgb + event + extrinsics (Calib.hpp:64-69,
  `readDualCalibration` Calib.cpp:105-169),
* the common-view new camera: both sensors rectified into ONE pinhole
  geometry so event frames and keyframes share pixels (`setNewCamera` /
  `getMapping`, Calib.cpp:171-233) — here the output intrinsics are the
  mean of both scaled intrinsics and the undistortion maps come from
  cameras.undistortion_maps / forward_maps,
* DSO `camera.txt` export (`toDSOFormat`, Calib.cpp:27-62),
* photometric calibration (gamma response + vignette), reference
  src/utils/Undistort.h:40-64 PhotometricUndistorter.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import jax.numpy as jnp
from ..io import yaml_subset
from .cameras import CameraModel, Pinhole, undistortion_maps, forward_maps, \
    gamma_inverse_table


@dataclass
class CameraInfo:
    """One sensor's calibration block (reference Calib.hpp:38-56)."""
    width: int = 0
    height: int = 0
    distortion_model: str = "none"
    intrinsics: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.0)   # fx fy cx cy
    D: Tuple[float, ...] = ()
    R: Optional[list] = None          # 3x3 rectification
    P: Optional[list] = None          # 3x4 projection
    T_cam_imu: Optional[list] = None  # 4x4
    flip: bool = False

    def to_model(self) -> CameraModel:
        fx, fy, cx, cy = self.intrinsics
        pin = Pinhole(jnp.float32(fx), jnp.float32(fy), jnp.float32(cx),
                      jnp.float32(cy), int(self.width), int(self.height))
        model = {"radial-tangential": "radtan", "plumb_bob": "radtan",
                 "equidistant": "kb", "kannala_brandt": "kb",
                 "fov": "fov", "none": "none"}.get(
                     self.distortion_model, self.distortion_model)
        D = jnp.asarray(self.D or (0.0,) * 4, jnp.float32)
        return CameraModel(pin, D, model)


@dataclass
class DualCamera:
    """Frame camera + event camera + extrinsics between them (reference
    Calib.hpp:64-69)."""
    cam0: CameraInfo = field(default_factory=CameraInfo)   # frame (rgb)
    cam1: CameraInfo = field(default_factory=CameraInfo)   # events
    T_cam0_cam1: Optional[list] = None                     # 4x4


def _read_camera_block(data: dict) -> CameraInfo:
    """Parse one `cam0:`-style YAML block (reference readCameraCalib,
    Calib.cpp:65-103; kalibr-style key names)."""
    res = data.get("resolution", [0, 0])
    return CameraInfo(
        width=int(res[0]), height=int(res[1]),
        distortion_model=data.get("distortion_model", "none"),
        intrinsics=tuple(data.get("intrinsics", (0, 0, 0, 0))),
        D=tuple(data.get("distortion_coeffs", ())),
        R=data.get("rectification_matrix"),
        P=data.get("projection_matrix"),
        T_cam_imu=data.get("T_cam_imu"),
        flip=bool(data.get("flip", False)),
    )


def read_camera_calib(path_or_dict, key: str = "cam0") -> CameraInfo:
    data = _load(path_or_dict)
    return _read_camera_block(data.get(key, data))


def read_dual_calibration(path_or_dict) -> DualCamera:
    """Parse the rgb+event dual rig (reference readDualCalibration,
    Calib.cpp:105-169): `cam0` frame camera, `cam1` event camera,
    `cam1.T_cn_cnm1` the 4x4 extrinsic cam1<-cam0."""
    data = _load(path_or_dict)
    cam0 = _read_camera_block(data.get("cam0", {}))
    cam1 = _read_camera_block(data.get("cam1", {}))
    T = data.get("cam1", {}).get("T_cn_cnm1", data.get("T_cam0_cam1"))
    return DualCamera(cam0=cam0, cam1=cam1, T_cam0_cam1=T)


def _load(path_or_dict) -> dict:
    if isinstance(path_or_dict, dict):
        return path_or_dict
    return yaml_subset.load(path_or_dict) or {}


def common_view_camera(dual: DualCamera,
                       out_size: Optional[Tuple[int, int]] = None) -> Pinhole:
    """The shared rectified geometry both sensors are mapped into
    (reference setNewCamera, Calib.cpp:171-197): output size defaults to
    the event camera's (the smaller sensor drives the common view), and the
    output intrinsics are the average of both cameras' intrinsics scaled to
    that size."""
    w1, h1 = dual.cam1.width, dual.cam1.height
    out_w, out_h = out_size or (w1, h1)

    def scaled(info: CameraInfo):
        fx, fy, cx, cy = info.intrinsics
        sx, sy = out_w / info.width, out_h / info.height
        return np.array([fx * sx, fy * sy, cx * sx, cy * sy])

    k = 0.5 * (scaled(dual.cam0) + scaled(dual.cam1))
    return Pinhole(jnp.float32(k[0]), jnp.float32(k[1]), jnp.float32(k[2]),
                   jnp.float32(k[3]), int(out_w), int(out_h))


def dual_mappings(dual: DualCamera, out: Optional[Pinhole] = None):
    """Undistort/rectify maps for both sensors into the common view
    (reference getMapping, Calib.cpp:199-233). Returns a dict with the
    frame camera's inverse maps (for image remap) and the event camera's
    forward maps (for per-event lookup, EventFrame.cpp:316-317)."""
    out = out or common_view_camera(dual)
    frame_maps = undistortion_maps(dual.cam0.to_model(), out)
    event_fwd = forward_maps(dual.cam1.to_model(), out)
    return {"frame_map_x": frame_maps[0], "frame_map_y": frame_maps[1],
            "event_fwd_x": event_fwd[0], "event_fwd_y": event_fwd[1],
            "out": out}


def to_dso_format(cam: CameraModel, out: Optional[Pinhole] = None) -> str:
    """DSO camera.txt content (reference toDSOFormat, Calib.cpp:27-62):
    line 1 normalized input intrinsics + distortion, line 2 input size,
    line 3 normalized output intrinsics, line 4 output size."""
    pin, outp = cam.pinhole, (out or cam.pinhole)
    d = " ".join(f"{float(v):.10f}" for v in np.asarray(cam.D))
    l1 = (f"{float(pin.fx) / pin.width:.10f} {float(pin.fy) / pin.height:.10f} "
          f"{float(pin.cx) / pin.width:.10f} {float(pin.cy) / pin.height:.10f} "
          f"{d}").rstrip()
    l3 = (f"{float(outp.fx) / outp.width:.10f} "
          f"{float(outp.fy) / outp.height:.10f} "
          f"{float(outp.cx) / outp.width:.10f} "
          f"{float(outp.cy) / outp.height:.10f}")
    return (f"{l1}\n{pin.width} {pin.height}\n{l3}\n"
            f"{outp.width} {outp.height}\n")


@dataclass
class PhotometricCalib:
    """Gamma response + vignette (reference PhotometricUndistorter,
    src/utils/Undistort.h:40-64). ``correct`` maps a raw 8-bit image to
    linear irradiance with vignette removed."""
    B: np.ndarray               # [256] response
    Binv: np.ndarray            # [256] inverse response
    vignette_inv: Optional[np.ndarray] = None   # [H, W] 1/V

    @staticmethod
    def from_files(gamma_values, vignette: Optional[np.ndarray] = None
                   ) -> "PhotometricCalib":
        B, Binv = gamma_inverse_table(gamma_values)
        vinv = None
        if vignette is not None:
            v = np.asarray(vignette, np.float64)
            vinv = np.asarray(v.max() / np.maximum(v, 1e-3), np.float32)
        return PhotometricCalib(np.asarray(B), np.asarray(Binv), vinv)

    def correct(self, img_u8):
        img = jnp.asarray(img_u8)
        out = jnp.asarray(self.Binv)[jnp.clip(img.astype(jnp.int32), 0, 255)]
        if self.vignette_inv is not None:
            out = out * jnp.asarray(self.vignette_inv)
        return out

    def b_grad_table(self) -> np.ndarray:
        """[256] lookup of the forward-response derivative at a corrected
        intensity: bg[i] = B[c+1] - B[c] with c = clip(round(i), 5, 250) —
        CalibHessian::getBGradOnly (src/tracking/HessianBlocks.h:384-390).
        FrameHessian::makeImages multiplies the squared-gradient map by
        bg^2 ("convert to gradient of original color space") before pixel
        selection when setting_gammaWeightsPixelSelect is on."""
        B = np.asarray(self.B, np.float64)
        c = np.clip(np.arange(256), 5, 250)
        return np.asarray(B[c + 1] - B[c], np.float32)
