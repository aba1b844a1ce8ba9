from . import quaternion, se3  # noqa: F401
