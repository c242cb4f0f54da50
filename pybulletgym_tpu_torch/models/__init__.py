"""Compile-time model layer: MJCF parsing -> static `Model` descriptions
(numpy only; shared verbatim with the JAX package's schema)."""

from pybulletgym_tpu_torch.models.schema import (  # noqa: F401
    Actuator,
    Body,
    Geom,
    GeomType,
    JointType,
    Model,
)
from pybulletgym_tpu_torch.models.mjcf import load_mjcf, parse_mjcf  # noqa: F401
