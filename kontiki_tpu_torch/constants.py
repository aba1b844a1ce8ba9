"""Physical constants (reference kontiki: cpplib/include/kontiki/constants.h:13-24)."""
import numpy as np

#: Standard gravity magnitude [m/s^2].
STANDARD_GRAVITY = 9.80665

#: Gravity vector in the world frame: (0, 0, -g).
GRAVITY = np.array([0.0, 0.0, -STANDARD_GRAVITY])
