"""Pinhole projection on torch tensors (counterpart of
``kontiki_tpu.sensors.camera_models``; reference pinhole_camera.h:47-67):
``y = (K X).hnormalized()``."""


def pinhole_project(K, X):
    """[..., 3] camera-frame point -> [..., 2] pixel (K [..., 3, 3])."""
    p = (K @ X[..., None])[..., 0]
    return p[..., :2] / p[..., 2:3]
