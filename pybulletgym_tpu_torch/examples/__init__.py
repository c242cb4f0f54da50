"""The JAX package's example scripts (`examples/train_ppo.py`,
`examples/train_loop.py`, `examples/enjoy.py`) for the port, with their
arguments, defaults, printed lines and files, and a `--device` (default
"cuda": the kernels; "cpu" runs the plain version):

    python -m pybulletgym_tpu_torch.examples.train_ppo HopperPyBulletEnv-v0 --iters 300
    python -m pybulletgym_tpu_torch.examples.train_loop AntPyBulletEnv-v0 --iters 150
    python -m pybulletgym_tpu_torch.examples.enjoy HalfCheetahPyBulletEnv-v0 --render out.npy

Their files are the JAX scripts' formats in the same folder, `examples/weights/`
of the checkout (read and written by path), so a file either package writes
loads in the other. Each module's `main(argv)` is what `python -m` runs.
"""

import os

WEIGHTS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "examples", "weights",
)
