"""The card's physics builds against the host twin, with nvcc's contraction
of products and sums into FMAs and without it.

    python3 pybulletgym_tpu_torch/tools/twin_gap.py
        [--scenes TwoHumanoids-v0,FourHumanoids-v0,TenHumanoids-v0,balls11,balls40]
        [--batch 64] [--envs 8] [--steps 5]

For each scene (chip_smoke.py's multi-Humanoid IDs, their model and reset
from its `humanoids_task`, or `ballsN`, N free balls at rest) the scene's
physics build (its size class's engine.cu library) steps the scene
`--steps` times from its reset at --batch envs (seeded actions as
torques; the balls: random velocities and torques), then once more, from
that state, on the card and on the host twin (engine_host.cpp: the same
core built with g++ -ffp-contract=off), compared on the first --envs envs:
mean and max |dq|, each env's largest |dv| over its largest |v|, whether
all bits agree, and the largest distance of a free root from the origin.
It does so twice: with the libraries built as the package builds them,
and built again with `--fmad=false` (ops.cuda_engine.NVCC_FLAGS extended in
this process only, into libraries of their own names), the rollout's state
the same for both. What differs between the card and the twin apart from
contraction (sinf/cosf's last bits, a fault) stays with --fmad=false.
Prints one JSON line a scene and build, then the card's name and power
limit. Needs one CUDA GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402
from pybulletgym_tpu_torch.envs.base import reset_fn  # noqa: E402
from pybulletgym_tpu_torch.models.mjcf import parse_mjcf  # noqa: E402
from pybulletgym_tpu_torch.models.schema import JointType  # noqa: E402
from pybulletgym_tpu_torch.ops import cuda_engine as ce  # noqa: E402
from pybulletgym_tpu_torch.ops.step import PhysicsConfig  # noqa: E402

SCENE_HUMANOIDS = {"TwoHumanoids-v0": 2, "FourHumanoids-v0": 4, "TenHumanoids-v0": 10}
NO_FMA = ("--fmad=false",)


def scene(name):
    """(the model, its physics config, the task or None)"""
    if name.startswith("balls"):
        return parse_mjcf(cs.balls_xml(int(name[5:]), 0.09), "balls"), PhysicsConfig(), None
    n = SCENE_HUMANOIDS[name]
    task = cs.humanoids_task(cs.humanoids_xml(n), n)
    return task.model, task.physics, task


def root_distance(model, q):
    """The largest distance of a free joint's position from the origin."""
    free = [b.q_adr for b in model.bodies if b.jtype == JointType.FREE]
    return max(float(q[a:a + 3].norm(dim=0).max()) for a in free) if free else None


def start_state(model, task, B, steps, dev, step):
    """The state after `steps` physics steps from the scene's reset."""
    g = torch.Generator(device=dev).manual_seed(7)
    if task is None:
        q = torch.as_tensor(np.repeat(model.qpos0[:, None], B, 1), dtype=torch.float32,
                            device=dev)
        v = torch.rand((model.nv, B), device=dev, generator=g) - 0.5
    else:
        s = reset_fn(task, torch.full((B,), 3, dtype=torch.uint32, device=dev),
                     torch.arange(B, dtype=torch.int32, device=dev),
                     torch.zeros(B, dtype=torch.uint32, device=dev))
        q, v = s.q, s.v
    taus = []
    for _ in range(steps + 1):
        if task is None:
            tau = torch.rand((model.nv, B), device=dev, generator=g) * 2 - 1
        else:
            a = torch.rand((task.act_dim, B), device=dev, generator=g) * 2 - 1
            tau = torch.zeros((model.nv, B), device=dev)
            tau[task.act_dofs] = torch.tensor(task.gears, device=dev)[:, None] * a
        taus.append(tau)
    for tau in taus[:-1]:
        q, v, _ = step(q, v, tau)
    return q.contiguous(), v.contiguous(), taus[-1]


def gap(step, q, v, tau, n):
    k = [x[..., :n].cpu() for x in step(q, v, tau)]
    h = ce.HostTwin().physics_step(step.tables, *[x[..., :n].cpu().contiguous()
                                                  for x in (q, v, tau)])
    dq = (k[0] - h[0]).abs()
    rel = ((k[1] - h[1]).abs().amax(0) / (h[1].abs().amax(0) + 1e-6)).max().item()
    return {"mean_dq": dq.mean().item(), "max_dq": dq.max().item(), "max_rel_dv": rel,
            "bitwise": all(cs.same_bits(x, y) for x, y in zip(k, h)),
            "max_d_depth": (k[2] - h[2]).abs().max().item()}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--scenes", default="TwoHumanoids-v0,FourHumanoids-v0,TenHumanoids-v0,"
                   "balls11,balls40")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--envs", type=int, default=8)
    p.add_argument("--steps", type=int, default=5)
    args = p.parse_args(argv)
    dev = torch.device("cuda", 0)
    names = [x for x in args.scenes.split(",") if x]
    scenes = {name: scene(name) for name in names}
    steps = {name: ce.make_cuda_physics_step(m, cfg)[0] for name, (m, cfg, _) in scenes.items()}
    base = ce.NVCC_FLAGS
    classes = {(st.size, st.caps) for st in steps.values()}
    jobs = {}
    for extra in ((), NO_FMA):  # every library of both builds, and the twins, at once
        ce.NVCC_FLAGS = base + extra
        for size, caps in classes:
            jobs.update({job[2]: job for job in ce._engine_jobs(size, caps)[0]})
    ce.NVCC_FLAGS = base
    for size, caps in classes:
        job = ce.host_job(size, caps)
        jobs[job[2]] = job
    ce.Builds(list(jobs.values())).wait()
    states = {}
    for extra in ((), NO_FMA):
        ce.NVCC_FLAGS = base + extra
        ce._load_cuda_library.cache_clear()
        for name, (m, _, task) in scenes.items():
            st = ce.with_tables(steps[name], steps[name].tables)
            st.prepare(dev, args.batch)
            if name not in states:  # the rollout with the package's build
                states[name] = start_state(m, task, args.batch, args.steps, dev, st)
            q, v, tau = states[name]
            rec = {"scene": name, "kernel": st.kernel, "B": args.batch, "envs": args.envs,
                   "steps": args.steps, "nvcc_extra": list(extra),
                   "max_root_distance_m": root_distance(m, q[:, :args.envs]),
                   **gap(st, q, v, tau, args.envs)}
            print(json.dumps(rec), flush=True)
    ce.NVCC_FLAGS = base
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card}), flush=True)


if __name__ == "__main__":
    main()
