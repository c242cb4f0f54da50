"""Does bf16 rounding of the XLA path's product operands explain a TPU-only
figure? A probe on the host twin (CPU only).

    python3 pybulletgym_tpu_torch/tools/bf16_probe.py
        [--envs HumanoidPyBulletEnv-v0,HumanoidMuJoCoEnv-v0] [--batch 8]
        [--seed 123] [--steps 1000] [--plain]

The JAX package's XLA path computes its bias, CRBA, contact-Jacobian and
PGS set-up products as einsums with no `precision=`; on a TPU those take
bf16 operands. The repository's TPU-recorded goldens (`tests/goldens/
<id>.npz`) and some shipped-policy floors (tests/test_frozen_policy.py) were
taken on that path. The host twin (`ops/cuda_engine.HostTwin`, the CUDA
core built with g++) is built twice: as the kernels are, and with
ENG_BF16_PROBE, which rounds exactly those products' operands to bf16
(`engine_core.h · mm_operand`). For each env id and each build it prints
one JSON line with:

  * the shipped policy's returns over one episode of `--batch` envs from
    seed `--seed` (up to `--steps` steps), and each env's episode length;
  * the median |obs - golden| at steps 1, 5 and 20 of the TPU-recorded
    golden, where there is one, over the obs entries the task computes.

With --plain, both are also taken on the plain PyTorch env step on the
CPU (build "plain"; seconds a step on the large models: the episode stops
once every env's first one has ended).

The probe changes nothing in the kernels; no bound, golden or floor reads it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)
from pybulletgym_tpu_torch import make_batched, make_task  # noqa: E402
from pybulletgym_tpu_torch.envs.base import env_step_plain  # noqa: E402
from pybulletgym_tpu_torch.ops import cuda_engine as ce  # noqa: E402
from pybulletgym_tpu_torch.utils.interop import policy_from_npz  # noqa: E402


def twin_step(twin):
    """A build's env step for a task: the host twin on its tables."""
    def make(task):
        tab = ce.pack_tables(task)
        return lambda s, a: twin.env_step(tab, task, s, a)
    return make


def plain_step(task):
    return lambda s, a: env_step_plain(task, s, a)


def episode(make_step, env_id, batch, seed, steps):
    """The shipped policy's returns and episode lengths on one build."""
    task = make_task(env_id)
    step = make_step(task)
    policy = policy_from_npz(os.path.join(ROOT, "examples", "weights", f"{env_id}.npz"),
                             device="cpu")
    s = make_batched(env_id, batch, device="cpu").reset(seed=seed)
    ret = np.zeros(batch)
    length = np.zeros(batch, np.int64)
    alive = np.ones(batch, bool)
    with torch.no_grad():
        for _ in range(min(steps, task.max_episode_steps)):
            a = policy(s.obs.T).T.contiguous()
            s = step(s, a)
            ret += np.where(alive, s.reward.numpy(), 0.0)
            length += alive
            alive &= ~s.done.numpy()
            if not alive.any():
                break
    return ret, length


def golden_drift(make_step, env_id):
    """Median |obs - golden| at each step of the TPU-recorded golden, over
    the obs entries the task computes (the zero blocks of the MuJoCo free
    walkers left out: HumanoidMuJoCo's 331 zeros would make it 0)."""
    path = os.path.join(ROOT, "tests", "goldens", f"{env_id}.npz")
    if not os.path.exists(path):
        return None
    g = np.load(path)
    B, n, seed = int(g["batch"]), int(g["n_steps"]), int(g["seed"])
    task = make_task(env_id)
    step = make_step(task)
    s = make_batched(env_id, B, device="cpu").reset(seed=seed)
    acts = np.random.default_rng(seed).uniform(-1, 1, (n, B, task.act_dim)).astype(np.float32)
    live = task.obs_dim - getattr(task, "n_zero", 0)
    meds = []
    for t in range(n):
        s = step(s, torch.from_numpy(acts[t].T.copy()))
        meds.append(float(np.median(np.abs(s.obs.numpy() - g["obs"][t])[:live])))
    return meds


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--envs", default="HumanoidPyBulletEnv-v0,HumanoidMuJoCoEnv-v0")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=123)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--plain", action="store_true", help="also run the plain env step")
    args = ap.parse_args()
    builds = {"f32": twin_step(ce.HostTwin()),
              "bf16_operands": twin_step(ce.HostTwin(bf16_probe=True))}
    if args.plain:
        builds["plain"] = plain_step
    for env_id in args.envs.split(","):
        for build, make_step in builds.items():
            ret, length = episode(make_step, env_id, args.batch, args.seed, args.steps)
            meds = golden_drift(make_step, env_id)
            print(json.dumps({
                "env": env_id, "build": build, "batch": args.batch, "seed": args.seed,
                "returns": ret.tolist(), "mean_return": float(ret.mean()),
                "episode_lengths": length.tolist(),
                "golden_median_dobs": None if meds is None else
                {"step1": meds[0], "step5": meds[4], "step20": meds[-1]},
            }), flush=True)


if __name__ == "__main__":
    main()
