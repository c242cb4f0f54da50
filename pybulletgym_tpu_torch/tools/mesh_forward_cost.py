"""What a rank pays for running the rollout's policy at the global row count.

    python3 pybulletgym_tpu_torch/tools/mesh_forward_cost.py
        [--batches 4096,65536] [--ranks 2,4] [--device cuda]

Over a mesh, PPO's rollout runs the policy on a rank's rows placed among
zeros at the global batch's row count (`parallel.mesh.global_rows`), so
that each row rounds as it does in the unsharded product: `ranks` times
the forward work that the rank's rows alone need. SAC's collect runs its
actor on the rank's rows alone. For each global batch B and rank count D
this times one step's forward on the last rank both ways, from the same
inputs and the same noise, beside the env step on that rank's B/D envs:

  * PPO on Ant: the shipped TrainState (`examples/weights`), the obs
    normaliser, `policy_sample` and `value_apply` (hidden 64x64);
  * SAC on HopperMuJoCo: the shipped learner's actor, `sample_action`
    (hidden 256x256): what the padding would cost SAC's collect.

"ms" is a call's host-clock time over 50 synchronised calls (what the
rollout loop pays, launches included); on a card, "graph_ms" is its
device time (20 calls captured in a CUDA graph, replayed 3 times). It
prints one JSON line per (model, B, D), then the card's name and power
limit. `--device cpu` runs the same at small sizes as a check of the script.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
ANT, MJ_HOPPER = "AntPyBulletEnv-v0", "HopperMuJoCoEnv-v0"


def host_ms(fn, dev, n=50, warm=5):
    import torch

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    for _ in range(warm):
        fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    sync()
    return (time.perf_counter() - t0) * 1e3 / n


def graph_ms(fn, n=20, reps=3):
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (n * reps)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batches", default="4096,65536")
    ap.add_argument("--ranks", default="2,4")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    from pybulletgym_tpu_torch import make_batched
    from pybulletgym_tpu_torch.parallel import mesh as pmesh
    from pybulletgym_tpu_torch.parallel import sac
    from pybulletgym_tpu_torch.utils.interop import sac_state_from_npz, train_state_from_npz

    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    weights = os.path.join(ROOT, "examples", "weights")
    ts, _ = train_state_from_npz(os.path.join(weights, f"{ANT}.trainstate.npz"), device=dev)
    actor = sac_state_from_npz(os.path.join(weights, f"{MJ_HOPPER}.saclearner.npz"), 8,
                               sac.SACConfig(), device=dev).actor
    gen = torch.Generator(device=dev).manual_seed(0)

    def ppo_forward(obs, eps):
        x = ts.obs_stats.normalize(obs)
        return ts.params.policy_sample(x, None, eps), ts.params.value_apply(x)

    models = {ANT: ppo_forward, MJ_HOPPER: lambda obs, eps: sac.sample_action(actor, obs, eps)}
    for env_id, forward in models.items():
        for B in [int(x) for x in args.batches.split(",")]:
            for D in [int(x) for x in args.ranks.split(",")]:
                b = B // D
                mesh = pmesh.Mesh(D, D - 1, ("env",), (D,), dev)
                env = make_batched(env_id, b, device=dev)
                es = env.reset(seed=0)
                obs = es.obs.T.contiguous()
                eps = torch.randn((B, env.action_size), generator=gen, device=dev)
                mine = eps[(D - 1) * b:]
                act = torch.zeros((env.action_size, b), device=dev)
                fns = {"global_rows": lambda: forward(pmesh.global_rows(obs, mesh), eps),
                       "shard_rows": lambda: forward(obs, mine),
                       "env_step": lambda: env.step_fn(es, act)}
                rec = {name: {"ms": host_ms(fn, dev)} for name, fn in fns.items()}
                if dev.type == "cuda":
                    for name, fn in fns.items():
                        rec[name]["graph_ms"] = graph_ms(fn)
                print(json.dumps({"env": env_id, "B": B, "D": D, "envs_a_rank": b, **rec}),
                      flush=True)
    if dev.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()[0], flush=True)


if __name__ == "__main__":
    main()
