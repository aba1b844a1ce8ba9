"""HDF5 persistence (counterpart of ``kontiki_tpu.io``), schema-compatible
with the reference's ``kontiki.io`` and with the JAX package's, so files
move between the three:

- structure group: views/{frame_nr,t0}, landmarks/{inverse_depth,ref_idx,
  color}, observations/{uv,lm_idx,v_idx} (index-linked arrays);
- trajectory group: 'type' tag; per-spline {dt, t0, knots}; SplitTrajectory
  as R3_spline/SO3_spline subgroups; SE3 knots stored as 4x4 matrices;
- the atan camera's calibration file (``load_atan_camera``);
- solver-state checkpoints: each state tensor as a dataset, with the
  iteration and the trust-region radius as attributes.

``h5py`` is imported here only, and the package's ``__init__`` does not
import this module. Loaded trajectories and solver states go to the device
the caller names, the CUDA card by default (``config.resolve_device``):
trajectories take it for their queries, states as the tensors' device.
The sharded solvers (``parallel``) return the global state, the same on
every rank; ``save_solver_state(..., mesh=...)`` writes it once, from rank
0, behind a barrier (the JAX package gathers its sharded arrays there).
"""
from contextlib import contextmanager

import h5py
import numpy as np
import torch

from .config import default_dtype, resolve_device
from .sensors import AtanCamera
from .sfm import Landmark, View
from .trajectories import (
    SplitTrajectory,
    UniformR3SplineTrajectory,
    UniformSE3SplineTrajectory,
    UniformSO3SplineTrajectory,
)


def _read(node):
    """h5py dataset -> value (scalars and byte strings decoded)."""
    v = node[()]
    if isinstance(v, bytes):
        return v.decode()
    return v


@contextmanager
def _create_h5_group(location, group_name):
    try:
        yield location.create_group(group_name)
    except AttributeError:
        with h5py.File(location, "w") as f:
            yield f.create_group(group_name)


@contextmanager
def _open_h5_group(location, group_name):
    try:
        yield location[group_name]
    except (AttributeError, KeyError, TypeError):
        with h5py.File(location, "r") as f:
            yield f[group_name]


def save_structure(fileobj, landmarks, *, group_name="structure", landmark_colors=None):
    """Save SfM structure (views/landmarks/observations) to HDF5."""
    with _create_h5_group(fileobj, group_name) as g:
        views = list({obs.view for lm in landmarks for obs in lm.observations})
        views.sort(key=lambda v: v.frame_nr)
        observations = [obs for lm in landmarks for obs in lm.observations]
        view_to_index = {v: i for i, v in enumerate(views)}
        landmark_to_index = {lm: i for i, lm in enumerate(landmarks)}
        obs_to_index = {obs: i for i, obs in enumerate(observations)}

        gviews = g.create_group("views")
        gviews["frame_nr"] = np.array([v.frame_nr for v in views], dtype="int")
        gviews["t0"] = np.array([v.t0 for v in views])

        glandmarks = g.create_group("landmarks")
        glandmarks["inverse_depth"] = np.array([lm.inverse_depth for lm in landmarks])
        glandmarks["ref_idx"] = np.array(
            [obs_to_index[lm.reference] for lm in landmarks], dtype="int")

        gobs = g.create_group("observations")
        gobs["uv"] = np.vstack([obs.uv for obs in observations])
        gobs["lm_idx"] = np.array(
            [landmark_to_index[obs.landmark] for obs in observations], dtype="int")
        gobs["v_idx"] = np.array([view_to_index[obs.view] for obs in observations],
                                 dtype="int")

        if landmark_colors:
            colors = np.vstack([landmark_colors[lm] for lm in landmarks])
        else:
            colors = np.empty((0, 3))
        glandmarks["color"] = colors


def load_structure(fileobj, group_name="structure"):
    """Load SfM structure. Returns (views, landmarks, landmark_colors)."""
    with _open_h5_group(fileobj, group_name) as g:
        gviews = g["views"]
        views = [View(fnr, t0)
                 for fnr, t0 in zip(_read(gviews["frame_nr"]), _read(gviews["t0"]))]

        glandmarks = g["landmarks"]
        landmarks = [Landmark() for _ in range(len(_read(glandmarks["inverse_depth"])))]

        gobs = g["observations"]
        observations = [
            views[v_idx].create_observation(landmarks[lm_idx], uv)
            for uv, lm_idx, v_idx in zip(_read(gobs["uv"]), _read(gobs["lm_idx"]),
                                         _read(gobs["v_idx"]))
        ]

        for lm, invd, ref_idx in zip(landmarks, _read(glandmarks["inverse_depth"]),
                                     _read(glandmarks["ref_idx"])):
            lm.inverse_depth = invd
            lm.reference = observations[ref_idx]

        colors = _read(glandmarks["color"])
        if len(colors) == len(landmarks):
            landmark_colors = {lm: c for lm, c in zip(landmarks, colors)}
        elif len(colors) == 0:
            landmark_colors = None
        else:
            raise IOError("Number of colors do not match!")

        return views, landmarks, landmark_colors


def _save_spline(group, spline):
    group["dt"] = spline.dt
    group["t0"] = spline.t0
    group["knots"] = np.stack([spline[i] for i in range(len(spline))])


def _load_spline(group, cls, device):
    instance = cls(float(_read(group["dt"])), float(_read(group["t0"])), device=device)
    for v in _read(group["knots"]):
        instance.append_knot(v)
    return instance


def save_trajectory(location, trajectory, group_name="trajectory"):
    """Save a trajectory (type tag + per-spline {dt, t0, knots})."""
    with _create_h5_group(location, group_name) as g:
        g["type"] = trajectory.__class__.__name__
        if type(trajectory) is SplitTrajectory:
            _save_spline(g.create_group("R3_spline"), trajectory.R3_spline)
            _save_spline(g.create_group("SO3_spline"), trajectory.SO3_spline)
        else:
            _save_spline(g, trajectory)


def load_trajectory(location, group_name="trajectory", device=None):
    """Load a trajectory saved by ``save_trajectory`` (or by the reference's
    or the JAX package's io); its queries run on ``device`` (None: the CUDA
    card, resolved at query time)."""
    classes = {cls.__name__: cls for cls in (UniformR3SplineTrajectory,
                                             UniformSO3SplineTrajectory,
                                             UniformSE3SplineTrajectory)}
    with _open_h5_group(location, group_name) as g:
        name = _read(g["type"])
        if name == "SplitTrajectory":
            r3 = _load_spline(g["R3_spline"], UniformR3SplineTrajectory, device)
            so3 = _load_spline(g["SO3_spline"], UniformSO3SplineTrajectory, device)
            return SplitTrajectory(r3, so3, device=device)
        if name in classes:
            return _load_spline(g, classes[name], device)
        raise IOError(f"Unknown trajectory type {name}")


def load_atan_camera(path):
    """Load an AtanCamera from the reference's calibration file schema."""
    with h5py.File(str(path), "r") as f:
        cols, rows = _read(f["size"])
        return AtanCamera(rows, cols, float(_read(f["readout"])), _read(f["K"]),
                          _read(f["wc"]), float(_read(f["lgamma"])))


# ---------------------------------------------------------------------------
# solver-state checkpoints (beyond the reference, which keeps no optimizer
# state): a long solve resumes from the state and the trust-region radius
# ---------------------------------------------------------------------------

def save_solver_state(location, state, *, trust_region_radius=None, iteration=0,
                      group_name="solver_state", mesh=None):
    """Checkpoint a solver state (a dict of tensors on any device: knots,
    sensor parameters, inverse depths, row times) and the LM trust-region
    state to HDF5. Resuming is ``solve(problem,
    initial_trust_region_radius=tr, ...)`` after writing the loaded state
    back into the problem's objects. Under a multi-rank ``mesh``
    (``parallel.mesh.Mesh``) ``state`` is the global state every rank holds:
    rank 0 writes it, and every rank returns once it is written."""
    if mesh is None or mesh.axis_index() == 0:
        with _create_h5_group(location, group_name) as group:
            for key, value in state.items():
                group[key] = (value.detach().cpu().numpy() if torch.is_tensor(value)
                              else np.asarray(value))
            group.attrs["keys"] = ",".join(state.keys())
            group.attrs["iteration"] = int(iteration)
            group.attrs["format_version"] = 1
            if trust_region_radius is not None:
                group.attrs["trust_region_radius"] = float(trust_region_radius)
    if mesh is not None:
        mesh.barrier()


def load_solver_state(location, group_name="solver_state", device=None,
                      dtype=default_dtype):
    """Load a checkpoint: returns (state dict of tensors on ``device``, None
    meaning the CUDA card, floats as ``dtype`` and integers as stored;
    meta dict with the iteration and the trust-region radius)."""
    device = resolve_device(device)
    with _open_h5_group(location, group_name) as group:
        keys = group.attrs["keys"].split(",") if group.attrs["keys"] else []
        state = {}
        for k in keys:
            t = torch.as_tensor(np.array(_read(group[k])), device=device)
            state[k] = t.to(dtype) if t.is_floating_point() else t
        meta = {"iteration": int(group.attrs["iteration"])}
        if "trust_region_radius" in group.attrs:
            meta["trust_region_radius"] = float(group.attrs["trust_region_radius"])
        return state, meta
