"""Models past the huge class by ID (test_torch_sized_models.py's (e), in a
file of its own to keep that one under its 40 s): a six-Humanoid scene (108
bodies, nq 144, nv 138, 102 actuators; the fewest Humanoids past the huge
class's nv 128) registered and made by ID with `device="cpu"`, both
backends, B=1 and one substep. The fused step is `task_step_kernel_sized`'s
wrapper (its hooks traced, the tables in the sized class), and the two
backends agree bitwise. A ten-Humanoid plain step at B=1 takes about 2.4
times a six-Humanoid one on a CPU, which would put the file at ~33 s; the
ten-Humanoid scene runs on the card in chip_smoke.py's sized_model_paths.
"""

import dataclasses

import numpy as np
import torch

import pybulletgym_tpu_torch as pt
from pybulletgym_tpu_torch.ops import cuda_engine as ce
from test_torch_big_models import _PKG_T, humanoids_task, humanoids_xml

SCENE_ID = "SixHumanoids-v0"


def test_scene_by_id_with_both_backends():
    xml = humanoids_xml(6)
    SixHumanoidT = humanoids_task(_PKG_T, torch, 6)

    def factory():  # one substep a step, to keep the plain version's CPU time down
        task = SixHumanoidT(xml)
        task.physics = dataclasses.replace(task.physics, frame_skip=1)
        return task

    pt.register(SCENE_ID, factory, 1000)
    B = 1
    envs = {b: pt.make_batched(SCENE_ID, B, device="cpu", backend=b)
            for b in ("fused", "composed")}
    assert envs["fused"].step_fn.kernel == "task_step_kernel_sized"
    assert envs["fused"].step_fn.size == ce.SIZED and envs["composed"].backend == "composed"
    assert ce.tables_caps(envs["fused"].step_fn.tables) == (128, 160, 160, 192, 32, 224, 160,
                                                            128, 160)
    a = np.random.default_rng(1).uniform(-1, 1, (B, 102)).astype(np.float32)
    out = {b: e.step(e.reset(seed=2), a) for b, e in envs.items()}
    for k in ("q", "v", "obs", "reward", "terminated", "epoch"):
        assert torch.equal(getattr(out["fused"], k), getattr(out["composed"], k)), k
    assert out["fused"].obs.shape == (132 + 138, B) and torch.isfinite(out["fused"].q).all()
    assert sorted(out["fused"].rewards) == ["alive", "progress"]
    assert torch.equal(out["fused"].rewards["alive"], torch.full((B,), 6.0))
