"""Problem families: quadrotor (Crazyflie LTI at 20/50/100 Hz), cartpole,
randomized LTI plants — capability parity with the reference's examples/data
(reference: examples/problem_data/, examples/codegen_cartpole.cpp,
examples/codegen_random.cpp)."""

from .quadrotor import (  # noqa: F401
    load_quadrotor_cache,
    load_quadrotor_problem,
    load_trajectory,
    quadrotor_hovering_setup,
    quadrotor_tracking_setup,
)
from .cartpole import RHO as CARTPOLE_RHO, cartpole_problem  # noqa: F401
from .random_lti import random_lti_plants, random_lti_problem  # noqa: F401
