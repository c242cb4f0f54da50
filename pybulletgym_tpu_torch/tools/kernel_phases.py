"""Where a kernel's time goes, by phase, on the card.

    python3 pybulletgym_tpu_torch/tools/kernel_phases.py
        [--envs HalfCheetahPyBulletEnv-v0,...] [--batch 4096] [--lanes 8,16,32]

For each env id it times `env_step_kernel` (graph-replayed launches, CUDA
events, as kernel_ab.py's "graph_ms") on a post-reset state and random
actions, with the launch's tables changed one field at a time:

  * as packed (`full`);
  * `iterations` = 0 and 1: the PGS sweeps' share, and one sweep's cost;
  * `frame_skip` = 0: the launch without substeps (inputs, the task's
    outputs, the writes).

From these: sweeps = full - it0, rest of the substeps = it0 - fs0, and
outputs = fs0. --lanes repeats it at each listed group width G in place of
`pick_lanes`'s. The arithmetic of a launch with changed tables is not the
model's; only its time is read. Prints one JSON line per env, then the
card's name and power limit. Needs one CUDA GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
from pybulletgym_tpu_torch import make_batched, make_task  # noqa: E402
from pybulletgym_tpu_torch.ops import cuda_engine as ce  # noqa: E402


def graph_ms(fn, n=20, reps=3):
    """Device ms a call: n calls captured in one CUDA graph, replayed."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(reps):
        graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (n * reps)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--envs", default="HalfCheetahPyBulletEnv-v0,AntPyBulletEnv-v0,"
                   "HumanoidPyBulletEnv-v0,HumanoidFlagrunHarderPyBulletEnv-v0")
    p.add_argument("--batch", type=int, default=4096)
    p.add_argument("--lanes", default="", help="group widths, e.g. 8,16,32")
    args = p.parse_args(argv)
    B = args.batch
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    for env_id in args.envs.split(","):
        task = make_task(env_id)
        env = make_batched(env_id, B)
        s = env.reset(seed=0)
        a = torch.rand((task.act_dim, B), device=dev, generator=g) * 2 - 1
        step = env.step_fn
        for lanes in [int(x) for x in args.lanes.split(",") if x] or [None]:
            packed = ce.pack_tables(task)
            if lanes is not None:
                packed.lanes = lanes
            rec = {"env": env_id, "B": B, "lanes": packed.lanes,
                   "frame_skip": packed.frame_skip, "iterations": packed.iterations,
                   "launch": ce.launch_config(packed, "env_step_kernel", B)}
            for name, field, value in (("full", None, None), ("it0", "iterations", 0),
                                       ("it1", "iterations", 1), ("fs0", "frame_skip", 0)):
                ctypes.memmove(ctypes.addressof(step.tables), ctypes.addressof(packed),
                               ctypes.sizeof(packed))
                if field is not None:
                    setattr(step.tables, field, value)
                rec[name] = graph_ms(lambda: step(s, a))
            rec["sweeps_ms"] = rec["full"] - rec["it0"]
            rec["one_sweep_ms"] = rec["it1"] - rec["it0"]
            rec["substeps_without_sweeps_ms"] = rec["it0"] - rec["fs0"]
            rec["outside_substeps_ms"] = rec["fs0"]
            print(json.dumps(rec), flush=True)
        ctypes.memmove(ctypes.addressof(step.tables), ctypes.addressof(ce.pack_tables(task)),
                       ctypes.sizeof(packed))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card}), flush=True)


if __name__ == "__main__":
    main()
