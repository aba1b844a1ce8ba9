"""SfM data model: View / Landmark / Observation object graph.

Reference semantics (kontiki's cpplib/include/kontiki/sfm/):

- ``View`` owns its observations; ``create_observation`` is the only way to
  make one (view_impl.h:47-56); deleting a view detaches its observations
  from their landmarks (view_impl.h:18-24); removing a non-owned observation
  raises (RuntimeError).
- ``Landmark`` holds an inverse depth relative to a designated **reference
  observation**; it tracks observations weakly; reference must be one of its
  own observations (RuntimeError otherwise); ids are globally
  auto-incremented; lockable.
- ``Observation``: pixel uv + landmark + weak view; ``is_reference``.

Ownership mirrors the C++ (View->Observation strong, Landmark->Observation
weak, Observation->View weak, Observation->Landmark strong), so CPython
refcounting reproduces the deleted-view cleanup semantics without cycles.
"""
import itertools
import weakref

import numpy as np

from ..config import host_dtype

__all__ = ["View", "Landmark", "Observation"]

_landmark_ids = itertools.count(0)


class Observation:
    def __init__(self, landmark, view, uv):
        self._landmark = landmark
        self._view = weakref.ref(view)
        self._uv = np.asarray(uv, dtype=host_dtype).reshape(2)

    @property
    def uv(self):
        return self._uv.copy()

    @uv.setter
    def uv(self, value):
        self._uv = np.asarray(value, dtype=host_dtype).reshape(2)

    @property
    def u(self):
        return float(self._uv[0])

    @property
    def v(self):
        return float(self._uv[1])

    @property
    def landmark(self):
        return self._landmark

    @property
    def view(self):
        return self._view()

    @property
    def is_reference(self):
        try:
            return self._landmark.reference is self
        except RuntimeError:
            return False

    def __repr__(self):
        v = self.view
        fnr = v.frame_nr if v is not None else "?"
        return f"<Observation lm={self._landmark.id} view={fnr} uv={tuple(self._uv)}>"


class Landmark:
    def __init__(self):
        self._id = next(_landmark_ids)
        self._observations = []  # list of weakrefs, insertion ordered
        self._reference = None  # weakref or None
        self.inverse_depth = 0.0
        self.locked = False

    @property
    def id(self):
        return self._id

    @property
    def observations(self):
        out = []
        alive = []
        for ref in self._observations:
            obs = ref()
            if obs is not None:
                out.append(obs)
                alive.append(ref)
        self._observations = alive
        return out

    def _attach(self, obs):
        self._observations.append(weakref.ref(obs))

    def _detach(self, obs):
        self._observations = [r for r in self._observations if r() is not None and r() is not obs]

    @property
    def reference(self):
        if self._reference is None:
            raise RuntimeError("Landmark has no reference observation")
        obs = self._reference()
        if obs is None:
            raise RuntimeError("Landmark reference observation no longer exists")
        return obs

    @reference.setter
    def reference(self, obs):
        if obs.landmark is not self:
            raise RuntimeError("Reference observation must observe this landmark")
        self._reference = weakref.ref(obs)

    def __repr__(self):
        return f"<Landmark id={self._id} nobs={len(self.observations)}>"


class View:
    def __init__(self, frame_nr, t0):
        self.frame_nr = int(frame_nr)
        self.t0 = float(t0)
        self._observations = []  # strong refs (view owns observations)

    @property
    def observations(self):
        return list(self._observations)

    def __len__(self):
        return len(self._observations)

    def create_observation(self, landmark, uv):
        obs = Observation(landmark, self, uv)
        self._observations.append(obs)
        landmark._attach(obs)
        return obs

    def remove_observation(self, obs):
        if obs not in self._observations:
            raise RuntimeError("Observation not owned by this view")
        self._observations.remove(obs)
        obs.landmark._detach(obs)

    def __del__(self):
        # Detach all owned observations from their landmarks (matches the
        # reference View destructor, view_impl.h:18-24).
        for obs in self._observations:
            try:
                obs.landmark._detach(obs)
            except Exception:
                pass

    def __repr__(self):
        return f"<View frame={self.frame_nr} t0={self.t0} nobs={len(self)}>"
