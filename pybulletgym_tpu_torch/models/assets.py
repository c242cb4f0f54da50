"""Asset resolution: the MJCF files live once, in the JAX package's
`models/assets/` directory, and are found here by file path. Nothing of that
package is imported (its `__init__` imports jax)."""

import os

_ASSET_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "pybulletgym_tpu", "models", "assets",
)


def asset_path(filename: str) -> str:
    p = os.path.join(_ASSET_DIR, filename)
    if not os.path.exists(p):
        raise FileNotFoundError(f"model asset {filename!r} not found in {_ASSET_DIR}")
    return p
