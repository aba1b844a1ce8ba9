from .base import Sensor  # noqa: F401
from .cameras import AtanCamera, Camera, PinholeCamera  # noqa: F401
from .imu import BasicImu, ConstantBiasImu  # noqa: F401
from . import camera_models  # noqa: F401
