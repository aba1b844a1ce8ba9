from .base import Sensor  # noqa: F401
from .cameras import Camera, PinholeCamera  # noqa: F401
from .imu import BasicImu  # noqa: F401
from . import camera_models  # noqa: F401
