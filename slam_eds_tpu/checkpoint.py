"""Checkpoint / resume of the full sliding-window odometry state.

The reference has NO checkpointing (SURVEY §5 — output recording is
delegated to the external driver, reference src/utils/Config.hpp:27-54);
for a long-running or multi-host deployment restartability is required, so this module
adds it: the complete BA window (BAState incl. the HM/bM marginalization
prior), the depth-filter states, the tracker pose window, and arbitrary
host-side scalars are saved as one pytree.

Orbax is used when importable (the production path: async, sharded,
multi-host safe); a numpy NPZ fallback keeps the feature alive in minimal
images. Both paths round-trip exact bit patterns for float arrays.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import jax
import jax.numpy as jnp

try:                                     # production path
    import orbax.checkpoint as ocp
    _HAS_ORBAX = True
except Exception:                        # pragma: no cover - minimal images
    ocp = None
    _HAS_ORBAX = False


def _flatten(tree) -> Dict[str, np.ndarray]:
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    return ({f"leaf_{i}": np.asarray(x) for i, x in enumerate(leaves)},
            treedef)


def save(path: str, tree: Any, metadata: Optional[dict] = None,
         use_orbax: Optional[bool] = None) -> str:
    """Save a state pytree (e.g. {'ba': BAState, 'filter': DepthFilterState,
    'step': k}) to `path`. Returns the concrete location written."""
    use_orbax = _HAS_ORBAX if use_orbax is None else use_orbax
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    if use_orbax and _HAS_ORBAX:
        ckptr = ocp.PyTreeCheckpointer()
        ckptr.save(os.path.abspath(path), jax.tree_util.tree_map(jnp.asarray, tree),
                   force=True)
        loc = path
    else:
        arrays, _ = _flatten(tree)
        loc = path if path.endswith(".npz") else path + ".npz"
        np.savez_compressed(loc, **arrays)
    if metadata is not None:
        with open(loc.rstrip("/") + ".meta.json", "w") as f:
            json.dump(metadata, f)
    return loc


def restore(path: str, example_tree: Any, use_orbax: Optional[bool] = None):
    """Restore into the structure of `example_tree` (shapes/dtypes must
    match what was saved — the fixed-capacity design guarantees this)."""
    use_orbax = _HAS_ORBAX if use_orbax is None else use_orbax
    if use_orbax and _HAS_ORBAX and os.path.isdir(path):
        ckptr = ocp.PyTreeCheckpointer()
        restored = ckptr.restore(os.path.abspath(path))
        leaves_r = jax.tree_util.tree_leaves(restored)
        treedef = jax.tree_util.tree_structure(example_tree)
        return jax.tree_util.tree_unflatten(
            treedef, [jnp.asarray(x) for x in leaves_r])
    loc = path if path.endswith(".npz") else path + ".npz"
    data = np.load(loc)
    _, treedef = _flatten(example_tree)
    leaves = [jnp.asarray(data[f"leaf_{i}"]) for i in range(len(data.files))]
    return jax.tree_util.tree_unflatten(treedef, leaves)


def load_metadata(path: str) -> Optional[dict]:
    for loc in (path, path + ".npz"):
        meta = loc.rstrip("/") + ".meta.json"
        if os.path.exists(meta):
            with open(meta) as f:
                return json.load(f)
    return None


# ---------------------------------------------------------------------------
# Whole-pipeline checkpoint / resume
# ---------------------------------------------------------------------------
# The tensor state (BAState, KeyFrame, DepthFilterState, TrackerState, ...)
# is a fixed-capacity pytree and goes through save()/restore() above; but a
# resumable odometry process also needs the host-side orchestration state
# (slot bookkeeping, Python lists, optional components). That mixed
# structure is serialized as ONE npz file: arrays under generated keys and a
# JSON manifest (structure + plain-Python scalars) stored as a string array.
# No pickle anywhere — a .ckpt from an untrusted source can corrupt a resume
# but can never execute code (round-2 advisor finding). For multi-host
# sharded deployments, checkpoint the pure-tensor window state with
# save(..., use_orbax=True) and rebuild host bookkeeping from the metadata.

def _to_numpy(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x), tree)


def _encode(obj, arrays: Dict[str, np.ndarray]):
    """Structure -> JSON-able manifest node; arrays hoisted into `arrays`."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj if not isinstance(obj, float) or np.isfinite(obj) \
            else {"t": "f", "v": repr(obj)}
    if isinstance(obj, (np.ndarray, np.generic)) or hasattr(obj, "__jax_array__") \
            or isinstance(obj, jax.Array):
        key = f"a{len(arrays)}"
        arrays[key] = np.asarray(obj)
        return {"t": "arr", "k": key}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):   # NamedTuple
        return {"t": "nt", "cls": type(obj).__name__,
                "v": [_encode(x, arrays) for x in obj]}
    if isinstance(obj, (list, tuple)):
        return {"t": "list" if isinstance(obj, list) else "tuple",
                "v": [_encode(x, arrays) for x in obj]}
    if isinstance(obj, dict):
        return {"t": "dict", "v": {k: _encode(v, arrays)
                                   for k, v in obj.items()}}
    raise TypeError(f"checkpoint cannot encode {type(obj)!r}")


def _nt_registry() -> Dict[str, type]:
    """Known NamedTuple state types, looked up by class name on decode."""
    import inspect
    from .models import ba_state, keyframe
    from .ops import depth_filter, event_tracker, immature, coarse_init
    from .utils import lie
    reg: Dict[str, type] = {}
    for mod in (ba_state, keyframe, depth_filter, event_tracker, immature,
                coarse_init, lie):
        for name, cls in inspect.getmembers(mod, inspect.isclass):
            if issubclass(cls, tuple) and hasattr(cls, "_fields"):
                reg[name] = cls
    return reg


def _decode(node, arrays, reg):
    if node is None or isinstance(node, (bool, int, float, str)):
        return node
    t = node["t"]
    if t == "f":
        return float(node["v"])          # inf/nan round-trip
    if t == "arr":
        return arrays[node["k"]]
    if t == "nt":
        return reg[node["cls"]](*[_decode(x, arrays, reg)
                                  for x in node["v"]])
    if t == "list":
        return [_decode(x, arrays, reg) for x in node["v"]]
    if t == "tuple":
        return tuple(_decode(x, arrays, reg) for x in node["v"])
    if t == "dict":
        return {k: _decode(v, arrays, reg) for k, v in node["v"].items()}
    raise ValueError(f"bad checkpoint node type {t!r}")


def save_pipeline(path: str, pipe) -> str:
    """Snapshot a FrameOnlyPipeline or EDSPipeline (after initialization).
    Returns the file written (``path`` with a .ckpt suffix)."""
    is_eds = hasattr(pipe, "tracker_state")
    fp = pipe.frame_pipe if is_eds else pipe
    w = fp.window
    assert fp._initialized, "checkpoint only defined after initialization"
    d = {
        "version": 1,
        "is_eds": is_eds,
        "window": {
            "state": _to_numpy(w.state),
            "images": np.asarray(w.images),
            "immatures": [None if im is None else _to_numpy(im)
                          for im in w.immatures],
            "frame_times": list(w.frame_times),
            "frame_ids": list(w.frame_ids),
            "next_id": w.next_id,
            "newest_slot": w.newest_slot,
        },
        "frame_pipe": {
            "last_pose": _to_numpy(fp._last_pose),
            "last_good_pose": _to_numpy(fp._last_good_pose),
            "motion": _to_numpy(fp._motion),
            "frames_since_kf": fp._frames_since_kf,
            "lost": fp._lost,
            "lost_frames": fp._lost_frames,
            "resets": fp._resets,
            "world_anchor": _to_numpy(fp._world_anchor),
            "trajectory": [np.asarray(t) for t in fp.trajectory],
            "poses": [_to_numpy(p) for p in fp.poses],
            "times": [float(t) for t in fp.times],
        },
    }
    if is_eds:
        d["eds"] = {
            "kf": None if pipe.kf is None else _to_numpy(pipe.kf),
            "depth": None if pipe.depth is None else _to_numpy(pipe.depth),
            "tracker": _to_numpy(pipe.tracker_state),
            "pose_filter": _to_numpy(pipe.pose_filter),
            "loss_scale": float(pipe.loss_scale),
            "pending_kf": pipe._pending_kf,
            "num_event_kfs": pipe.num_event_kfs,
            "event_poses": [np.asarray(t) for t in pipe.event_poses],
            "event_pose_list": [_to_numpy(p) for p in pipe.event_pose_list],
        }
    loc = path if path.endswith(".ckpt") else path + ".ckpt"
    os.makedirs(os.path.dirname(os.path.abspath(loc)) or ".", exist_ok=True)
    arrays: Dict[str, np.ndarray] = {}
    manifest = _encode(d, arrays)
    with open(loc, "wb") as f:
        np.savez(f, __manifest__=np.asarray(json.dumps(manifest)), **arrays)
    return loc


def restore_pipeline(path: str, cam, cfg=None):
    """Rebuild a running pipeline from a save_pipeline() snapshot.
    Derived state (image pyramids, coarse-tracker templates) is recomputed
    from the restored tensors, so the snapshot stays minimal. The .ckpt is
    plain npz + a JSON manifest — loading never executes code."""
    from .config import EDSConfig
    from .models.pipeline import EDSPipeline, FrameOnlyPipeline
    from .utils.lie import SE3

    loc = path if path.endswith(".ckpt") else path + ".ckpt"
    with np.load(loc, allow_pickle=False) as data:
        manifest = json.loads(str(data["__manifest__"]))
        arrays = {k: data[k] for k in data.files if k != "__manifest__"}
    d = _decode(manifest, arrays, _nt_registry())
    cfg = cfg or EDSConfig()

    def _dev(tree):
        return jax.tree_util.tree_map(jnp.asarray, tree)

    pipe = (EDSPipeline if d["is_eds"] else FrameOnlyPipeline)(cam, cfg)
    fp = pipe.frame_pipe if d["is_eds"] else pipe
    w = fp.window
    dw = d["window"]
    w.state = _dev(dw["state"])
    w.images = jnp.asarray(dw["images"])
    w.immatures = [None if im is None else _dev(im)
                   for im in dw["immatures"]]
    w.frame_times = list(dw["frame_times"])
    w.frame_ids = list(dw["frame_ids"])
    w.next_id = dw["next_id"]
    w.newest_slot = dw["newest_slot"]
    # pyramids are derived from the stored window images (channel 0 is the
    # intensity; gradients are recomputed by build_pyramid)
    valid = np.asarray(w.state.frame_valid)
    w.pyramids = [w._pyramid(w.images[s, ..., 0]) if valid[s] else None
                  for s in range(w.state.num_frames)]
    if w.newest_slot >= 0:
        w.rebuild_coarse_template()

    dfp = d["frame_pipe"]
    fp._initialized = True
    fp._last_pose = SE3(*map(jnp.asarray, dfp["last_pose"]))
    fp._motion = SE3(*map(jnp.asarray, dfp["motion"]))
    fp._frames_since_kf = dfp["frames_since_kf"]
    # recovery-ladder state (older snapshots lack these; defaults apply)
    if "last_good_pose" in dfp:
        fp._last_good_pose = SE3(*map(jnp.asarray, dfp["last_good_pose"]))
        fp._lost = bool(dfp["lost"])
        fp._lost_frames = int(dfp["lost_frames"])
        fp._resets = int(dfp["resets"])
        fp._world_anchor = SE3(*map(jnp.asarray, dfp["world_anchor"]))
        if d["is_eds"]:
            pipe._seen_resets = fp._resets
    fp.trajectory = [np.asarray(t) for t in dfp["trajectory"]]
    fp.poses = [SE3(*map(jnp.asarray, p)) for p in dfp["poses"]]
    fp.times = [float(t) for t in dfp.get("times", [])]

    if d["is_eds"]:
        de = d["eds"]
        pipe.kf = None if de["kf"] is None else _dev(de["kf"])
        pipe.depth = None if de["depth"] is None else _dev(de["depth"])
        pipe.tracker_state = _dev(de["tracker"])
        pipe.pose_filter = _dev(de["pose_filter"])
        pipe.loss_scale = de["loss_scale"]
        pipe._pending_kf = de["pending_kf"]
        pipe.num_event_kfs = de["num_event_kfs"]
        pipe.event_poses = [np.asarray(t) for t in de["event_poses"]]
        pipe.event_pose_list = [SE3(*map(jnp.asarray, p))
                                for p in de["event_pose_list"]]
    return pipe
