"""GPU smoke run of the PyTorch + CUDA port (pybulletgym_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA GPU (built for sm_90a: an H100), nvcc, and this checkout. It
builds the kernels from `pybulletgym_tpu_torch/csrc/` (one library per lane
group width G, the nvcc runs started together; ptxas must report no spills
and stack frames under 1 KB), prints each model's launch configuration (G,
envs a block, blocks, shared bytes, resident blocks per SM) and the local
memory the first launches reserve, and, for HalfCheetah
(hinge and slide joints), Ant (a free root joint), Humanoid (66
self-collision pairs, nv=23), HumanoidFlagrunHarder (75 pairs, a second
free joint: the cube, nv=29), and the fixed-base family: Reacher (no
contact rows, no gravity), Pusher (disk rows), Striker, Thrower (a free
ball), the two pendula, the eight Gym-MuJoCo mirrors (`*MuJoCoEnv-v0`:
Hopper, Walker2D, HalfCheetah, Ant, Humanoid, Reacher, InvertedPendulum,
InvertedDoublePendulum), and Atlas (a URDF robot: 31 bodies, nv 36, more
dofs than a group's 32 lanes, root paths past bit 31):
  * holds both kernels against their plain PyTorch versions on the card at
    B=4096 (forced resets, reset draws bitwise, bitwise repeatable
    launches; the quaternion stays a unit one), FlagrunHarder's cube
    throw, the physics kernel on HalfCheetah with a cylinder thigh (the
    disk rows' regular branch, which no shipped model reaches), and both
    kernels at ragged batches (B=1, 3E+1, 4097) on HalfCheetah and
    HumanoidMuJoCo, and (B=1, 3E+1, 4096: the first envs of their B=4096
    step, whose plain versions take tens of seconds) on Humanoid and Atlas;
    ReacherMuJoCo's disk-drawn target is held to
    1 ulp and whether it is bitwise is printed;
  * replays the CPU golden rollouts (four walkers, Reacher, the pendula, 7
    MuJoCo mirrors) and the TPU-recorded ones (the humanoid family, the
    arms, HumanoidMuJoCo, Atlas);
  * drives each main path with the launch counts reset just before it and
    read just after: the shipped policy on `BatchedEnv` (26 of them, one
    per env ID) followed, for the models held to the plain version,
    by the physics entry point; the PPO trainer (`parallel.ppo.train`) on
    Ant at B=4096 resumed from the JAX checkpoint, whose rollout launches
    the env-step kernel 32 times a train step; and the SAC learner
    (`parallel.sac`) on HopperMuJoCo at B=4096 resumed from the shipped
    learner, `SACConfig` defaults, through its warm-up and 3 learning
    iterations (4 env-kernel launches each), then one under torch.profiler,
    and held on 64 envs to the same iteration on the CPU (plain env step,
    same draws);
  * drives the gymnasium API and the utils, each with the launch counts
    reset just before it and read just after: `pt.make(HalfCheetah)` (B=1;
    its spaces, an episode of the shipped policy through reset and step to
    truncation at a return of 3000 or more, the epoch-1 state of a reset
    without a seed bitwise, steps/s); `pt.make_vec(HalfCheetah, 4096)`
    (200 steps bitwise equal to `BatchedEnv.step` on the same seeded
    actions, env-steps/s of both, a profiled split of an adapter step);
    `EpisodeStats` over 1000 steps at B=4096 (4096 episodes or more, sums
    within rtol 1e-5 of a float64 fold); an Ant checkpoint at B=4096 saved
    after 5 steps and loaded into a fresh reset, both stepped 5 more times
    bitwise, and the shipped PPO `TrainState` round trip (every leaf and
    the generator; ms to save and load); and `render_state_native` of a
    card state (a (240, 320, 3) frame with the robot in it, equal to the
    CPU state's frame; ms a frame). gymnasium is optional: its absence is
    printed, not skipped over;
  * runs the three example scripts of `pybulletgym_tpu_torch/examples/`
    (`examples_paths`) as a user runs them, `python -m` in a process of its
    own, with the launch counts reset just before each and read just after:
    `train_ppo` on HalfCheetah at B=4096 for 3 iterations (96 env-kernel
    launches, the JAX script's policy file); `train_loop` on Ant at B=4096
    for 2 iterations, twice (64 launches each), the second resuming, its
    TrainState bitwise the first run's files continued in this process;
    `enjoy` with the shipped HalfCheetah weights (one episode at the
    policy's floor, a launch a step), with `--render` (100 frames of the
    native renderer) and on the file `train_ppo` wrote. Each run's seconds
    and its share in the env kernel;
  * drives data parallelism over the env axis (`parallel.mesh`) in a world
    of D ranks, one process each (`mesh.launch`; the kernels are built
    once, here, before the ranks start): D is the number of cards when
    there are two or more (NCCL, a card a rank), else 2 ranks sharing the
    one card over gloo. Each rank's paths run with its launch counts reset
    just before them and read just after (both kernels: the physics kernel
    must launch no time there). `mesh_env`: HalfCheetah and Ant,
    B=4096, 50 steps of seeded actions with forced resets, the gathered
    state bitwise equal to the unsharded `BatchedEnv.step`, and the block
    at the largest env_id offset held to the plain version (reset bitwise);
    `mesh_ppo`: one sharded train step on Ant (config 4) against one
    unsharded step from the same TrainState (final state within 1e-4, obs
    stats 1e-5, each parameter and moment leaf 1e-5 on 98% of it and within
    16 Adam steps everywhere, parameters bitwise equal across ranks), which
    products round alike at a shard's rows, then 3 timed steps; `mesh_sac`:
    HopperMuJoCo, `SACConfig` defaults, the warm-up and two learning
    iterations (the second collects with the actor, on a rank's rows)
    against the unsharded ones (metrics rtol 1e-4, leaves as
    tests/test_torch_sac.py holds them, one Adam step an update; learners
    bitwise across ranks),
    then 3 timed iterations; `mesh_task`: a user's task by its registered ID
    (ShapedAnt, tests/torch_user_tasks.py), 20 steps, the gathered state
    bitwise the unsharded one's, task_step_kernel 20 launches a rank and
    nothing else; `dryrun_multichip`: `entry.dryrun_multichip(D)`.
    Each prints its backend, D and devices;
  * drives any task's env step (`user_task_paths`), each path with the
    launch counts reset just before it and read just after: builds
    `task_step_kernel` (the task's hooks translated into CUDA C++ by
    ops/task_kernel.py, compiled with the substeps; one nvcc a task, all
    started together) for HalfCheetah, Ant, Humanoid, Pusher and
    InvertedPendulum (their shipped classes, translated as a user's would
    be) and for BackwardCheetah (a user's task, defined here); steps each
    model 20 times at B=4096 with forced resets through it (20 launches of
    it, none of the others), each step held to `env_step_kernel`'s from the
    same input within the model's bounds, resets bitwise; steps the same
    models through the composed backend (the hooks in torch around one
    `physics_step_kernel` launch, replayed from a CUDA graph: 20 physics
    launches), bitwise to the eager composed step and within bounds of the
    task kernel's; registers BackwardCheetah and makes it by ID, 50 steps
    (50 task-kernel launches), the first 5 held to the plain version and to
    the composed step; 3 `ppo.train` steps on its ID (96 launches); times
    of every backend and of the capture;
  * drives the hook translation's ops (`task_ops_paths`, each path with the
    launch counts reset just before it and read just after): builds
    task_step_kernel with the hooks of OpProbe (an op of torch an obs entry,
    on InvertedPendulum's model) and ShapedAnt (Ant with a shaped reward of
    softplus, sigmoid, relu and a tensor power, per-env vectors, rounding
    and integer division of env_id, lerp before the physics;
    tests/torch_user_tasks.py), registered by ID; ptxas no spills; 20 steps
    each at B=4096 by ID (20 launches of it, nothing else), the probe's
    every op bitwise to torch's CUDA ops on the same inputs (the plain step
    on the card), ShapedAnt within the walker bounds of the plain version
    at steps 0 and 10, resets bitwise; ShapedAnt composed (20 physics
    launches, graph = eager bitwise) and the task kernel's step bitwise to
    it; ms a step of both beside env_step_kernel's on Ant;
  * drives models over the default tables' caps (`big_model_paths`, each
    path with the launch counts reset just before it and read just after):
    builds the large class of the tables (-DENG_BIG_TABLES: the default
    class's substep over root paths, the sweep by row windows, the tables
    and each env's scratch in global memory; engine.cu, one nvcc a width, and task_step.cu with a user's
    task's hooks, all started together right after the first build, beside
    the phases before this one, as the huge and sized phases' builds are);
    registers TwoHumanoids-v0
    (two copies of humanoid.xml in one worldbody: 36 bodies, nv 46) and
    makes it by ID at B=4096: 10 steps with forced resets through
    task_step_kernel's large build (10 launches, nothing else), and through
    the composed backend around physics_step_kernel's large build (10
    launches, nothing else; each step
    bitwise the eager composed step's); holds both against the plain
    version on the card within the humanoid budget, resets bitwise; holds
    seven free balls (nv 42) through the large physics build to the plain
    physics; times both large kernels beside their bounds; holds the
    physics build (and the balls') to the host twin as the huge ones below;
    Humanoid's physics kernel in the large class and in the default class
    (which factors M over root paths) each within the humanoid budget of
    the plain step and of the other;
  * drives models over the large tables' caps (`huge_model_paths`, the same
    paths through `scene_paths`): builds the huge class (-DENG_HUGE_TABLES:
    the substep over root paths as the large class's, the tables and each env's
    scratch in global memory, a device buffer of B envs' slices allocated
    when the env is made) and registers
    FourHumanoids-v0 (four copies of humanoid.xml: 72 bodies, nv 92, one
    env's scratch over a block's shared memory): 10 steps through
    task_step_kernel's huge build (10 launches, nothing else) and composed
    around physics_step_kernel's huge build (10, graph = eager bitwise),
    both held to the plain version at step 0 (resets bitwise), eleven free
    balls (nv 66) through the huge physics build, both huge kernels timed;
    the physics build (and the balls') against the host twin (the same
    core built with g++) on the first TWIN_ENVS envs of the timed inputs,
    within the bounds of FMA contraction, and a `sweep_blocks` line each;
    the task build against the task's host twin (its resets bitwise);
    the plain step on the first SCENE_PLAIN_ENVS envs;
  * drives models past the huge caps (`sized_model_paths`, the same paths
    through `scene_paths` at B=SIZED_B): builds the sized class
    (-DENG_SIZED_TABLES with caps from the model's sizes: a root-path mask
    of ceil(nv / 32) words, the substep and the scratch as the huge class's)
    for TenHumanoids-v0 (ten copies of humanoid.xml: 180
    bodies, nv 230, eight mask words, the scratch outside Y over a block's
    shared memory) and forty free balls (nv 240): 10 steps through
    task_step_kernel's sized build (10 launches, nothing else) and composed
    around physics_step_kernel's sized build (10, graph = eager bitwise),
    both held to the plain version at step 0 on the first SCENE_PLAIN_ENVS
    envs (resets bitwise), the balls through the sized physics build
    against the plain physics, both sized kernels timed with their ptxas
    reports and buffer bytes, and held to the host twin as the huge ones;
  * times the kernels (a launch's device time: launches captured in a CUDA
    graph and replayed; and back-to-back eager launches), the plain
    versions and the env-steps/s (FlagrunHarder and Pusher at B=4096 and
    16384 too), and prints for each model of the default class (and each
    scene above) its PGS sweep's group sums (`sweep_blocks`: one butterfly a contact row and one
    a limit row or limit pair) beside its kernels' times and launch.

Each phase prints one JSON line; any failure raises (non-zero exit). The
last lines are the kernels' summary, the card's name and power limit as
nvidia-smi reports them, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import atexit
import copy
import ctypes
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CHEETAH = "HalfCheetahPyBulletEnv-v0"
ANT = "AntPyBulletEnv-v0"
HOPPER = "HopperPyBulletEnv-v0"
WALKER = "Walker2DPyBulletEnv-v0"
HUMANOID = "HumanoidPyBulletEnv-v0"
FLAGRUN = "HumanoidFlagrunPyBulletEnv-v0"
HARDER = "HumanoidFlagrunHarderPyBulletEnv-v0"
REACHER = "ReacherPyBulletEnv-v0"
PUSHER = "PusherPyBulletEnv-v0"
STRIKER = "StrikerPyBulletEnv-v0"
THROWER = "ThrowerPyBulletEnv-v0"
PENDULUM = "InvertedPendulumPyBulletEnv-v0"
SWINGUP = "InvertedPendulumSwingupPyBulletEnv-v0"
DOUBLE = "InvertedDoublePendulumPyBulletEnv-v0"
FIXED = (REACHER, PUSHER, STRIKER, THROWER, PENDULUM, DOUBLE)  # held to plain, timed
MIRRORS = ("PusherMuJoCoEnv-v0", "StrikerMuJoCoEnv-v0", "ThrowerMuJoCoEnv-v0")
ATLAS = "AtlasPyBulletEnv-v0"
MJ_HOPPER = "HopperMuJoCoEnv-v0"
MJ_HUMANOID = "HumanoidMuJoCoEnv-v0"
MJ = (MJ_HOPPER, "Walker2DMuJoCoEnv-v0", "HalfCheetahMuJoCoEnv-v0", "AntMuJoCoEnv-v0",
      MJ_HUMANOID, "ReacherMuJoCoEnv-v0", "InvertedPendulumMuJoCoEnv-v0",
      "InvertedDoublePendulumMuJoCoEnv-v0")  # the Gym-MuJoCo mirrors, all held to plain
SOURCE = "pybulletgym_tpu_torch/csrc/engine.cu"
REPLACES = {
    "physics_step_kernel": "pybulletgym_tpu/ops/pallas_engine.py:48",
    "env_step_kernel": "pybulletgym_tpu/ops/pallas_engine.py:123",
    "task_step_kernel": "pybulletgym_tpu/ops/pallas_engine.py:123",  # for any other task
}
# shipped-policy floors, tests/test_frozen_policy.py:29-43 and :44-77
POLICY_FLOOR = {CHEETAH: 3000.0, ANT: 2000.0, HOPPER: 2000.0, WALKER: 750.0,
                HUMANOID: 220.0, FLAGRUN: 140.0, HARDER: 100.0,
                PENDULUM: 950.0, DOUBLE: 9100.0, SWINGUP: 800.0, REACHER: 18.0,
                PUSHER: -80.0, STRIKER: -300.0, THROWER: -80.0,
                MIRRORS[0]: -60.0, MIRRORS[1]: -300.0, MIRRORS[2]: -80.0,
                MJ[0]: 1000.0, MJ[1]: 900.0, MJ[2]: 1100.0, MJ[3]: 1700.0, MJ[4]: 430.0,
                MJ[5]: -14.0, MJ[6]: 950.0, MJ[7]: 9100.0, ATLAS: 75.0}
# H100 SXM data sheet: float32 outside the tensor cores, and HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
B = 4096
T_IMPORT = time.perf_counter()


def emit(phase, **kw):
    """One phase's JSON line, with the seconds since the script started."""
    print(json.dumps({"phase": phase, **kw, "at_seconds": time.perf_counter() - T_IMPORT}),
          flush=True)


def require(cond, msg):
    if not cond:
        raise AssertionError(msg)


def gpu_name_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, n):
    """Mean device milliseconds per call of `fn` over n calls (CUDA events)."""
    import torch

    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def graph_ms(fn, n=20, reps=3):
    """Mean device milliseconds per call of `fn` with no host time between
    launches: n calls captured in one CUDA graph, replayed reps times."""
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


def same_bits(a, b) -> bool:
    """Whether two tensors hold the same bits: floats compared as their
    integer patterns (so -0.0 differs from +0.0 and a NaN equals itself)."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    as_int = {torch.float32: torch.int32, torch.float64: torch.int64}.get(a.dtype)
    if as_int is None:
        return bool(torch.equal(a, b))
    return bool(torch.equal(a.contiguous().view(as_int), b.contiguous().view(as_int)))


def ptxas_report(log):
    """Per library (G) and kernel: registers, stack frame and spill bytes,
    from nvcc's -Xptxas -v output."""
    import re

    out, G, kernel = [], None, None
    for ln in log.splitlines():
        m = re.match(r"== G=(\d+)", ln)
        if m:
            G = int(m.group(1))
        m = re.search(r"entry function '.*?(env_step_kernel|physics_step_kernel|task_step_kernel)",
                      ln)
        if m:
            kernel = m.group(1)
            out.append({"G": G, "kernel": kernel})
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and out:
            out[-1].update(stack_bytes=int(m.group(1)), spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and out:
            out[-1]["registers"] = int(m.group(1))
    return out


def host_ms(fn, n):
    """Mean wall milliseconds per call, synchronised on both ends."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


# ---- the mesh phases' ranks: one process each (parallel.mesh.launch) -------
MESH_STEPS = 50
MESH_FORCED_AT = (10, 30)  # steps before which every third env is forced to reset
SAC_WARM = 7  # SACConfig defaults: iterations that only collect, then ones that learn
SAC_LEARN = 2  # learning iterations held to the unsharded ones: the second's collect is the actor's
MESH_TASK_STEPS = 20  # mesh_task: a user's task by ID, its steps (forced resets at MESH_FORCED_AT)


def mesh_actions(act_dim):
    """mesh_env's seeded actions (steps, B, act) and its forced-reset mask (B,)."""
    import numpy as np

    acts = np.random.default_rng(11).uniform(-1, 1, (MESH_STEPS, B, act_dim)).astype(np.float32)
    forced = np.zeros(B, bool)
    forced[1::3] = True
    return acts, forced


def ppo_leaves(ts):
    return [x.detach().cpu().numpy().copy() for x in
            [*ts.params.leaves(), *ts.opt_m, *ts.opt_v, ts.opt_count, *ts.obs_stats]]


def sac_leaves(ss):
    return [x.detach().cpu().numpy().copy() for x in
            [*ss.actor.leaves(), *ss.critics.leaves(), *ss.targets.leaves(), ss.log_alpha,
             *ss.opt_actor[0], *ss.opt_actor[1], ss.opt_actor[2], *ss.opt_critic[0],
             *ss.opt_critic[1], ss.opt_critic[2], *ss.opt_alpha[0], *ss.opt_alpha[1],
             ss.opt_alpha[2]]]


def mesh_rank():
    """One rank of mesh_env, mesh_ppo and mesh_sac, each path with the launch
    counts reset just before it and read just after. Returns numpy records;
    the global results (gathered states) from rank 0 only."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from pybulletgym_tpu_torch import make_batched, make_task
    from pybulletgym_tpu_torch.envs.base import env_step_plain
    from pybulletgym_tpu_torch.ops import cuda_engine as ce
    from pybulletgym_tpu_torch.parallel import mesh as pmesh
    from pybulletgym_tpu_torch.parallel import ppo, sac
    from pybulletgym_tpu_torch.utils.interop import (
        env_state_to_numpy, sac_state_from_npz, train_state_from_npz,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = pmesh.make_mesh()
    lo, hi = mesh.block(B)
    b, dev, last = hi - lo, mesh.device, mesh.rank == mesh.world - 1
    out = dict(rank=mesh.rank, backend=dist.get_backend(), device=str(dev), envs=[lo, hi])

    def start():  # the counts to 0 with every rank at the start line
        torch.cuda.synchronize()
        dist.barrier()
        ce.reset_launch_counts()
        return time.perf_counter()

    # mesh_env: 50 steps of each model on this rank's block of B=4096
    for env_id in (CHEETAH, ANT):
        task = make_task(env_id)
        env = make_batched(env_id, b, device=dev)
        acts, forced = mesh_actions(task.act_dim)
        a = torch.as_tensor(acts[:, lo:hi], device=dev)
        f = torch.as_tensor(forced[lo:hi], device=dev)
        env.step(env.reset(seed=1, first_env=lo), a[0])  # warm-up: a first launch loads the kernel
        s = env.reset(seed=0, first_env=lo)
        t0 = start()
        for t in range(MESH_STEPS):
            if t in MESH_FORCED_AT:
                s = s._replace(terminated=s.terminated | f)
            s = env.step(s, a[t])
        torch.cuda.synchronize()
        rec = dict(ms_per_step=(time.perf_counter() - t0) * 1e3 / MESH_STEPS,
                   launches=dict(ce.LAUNCHES))
        g = pmesh.gather_env_state(s, mesh)
        if mesh.rank == 0:
            rec["state"] = env_state_to_numpy(g)
        if last:  # the block at the largest env_id offset against the plain version
            ins = s._replace(terminated=s.terminated | f)
            at = a[0].T.contiguous()
            rk = ce.make_cuda_env_step(task, frame_skip=0)(ins, at)
            rp = env_step_plain(task, ins, at, frame_skip=0)
            sk, sp = env.step_fn(ins, at), env_step_plain(task, ins, at)
            torch.cuda.synchronize()
            dq = (sk.q - sp.q).abs()
            rec["offset_check"] = dict(
                first_env=lo, reset_q_bitwise=bool(torch.equal(rk.q, rp.q)),
                reset_v_bitwise=bool(torch.equal(rk.v, rp.v)),
                counters_bitwise=all(torch.equal(getattr(sk, k), getattr(sp, k))
                                     for k in ("epoch", "step_count", "truncated", "env_id")),
                mean_dq=dq.mean().item(), max_dq=dq.max().item())
        out[env_id] = rec

    # mesh_task: a user's task by its ID (ShapedAnt, registered in the rank,
    # its hooks translated there; task_step_kernel from the build made before
    # the ranks started), MESH_TASK_STEPS steps on this rank's block
    import pybulletgym_tpu_torch as pt
    from pybulletgym_tpu_torch.envs import locomotion as loco
    import torch_user_tasks as ut

    pt.register(ut.SHAPED_ANT_ID, ut.shaped_ant(loco, torch, ut.NN_TORCH), ut.SHAPED_ANT_STEPS)
    env = make_batched(ut.SHAPED_ANT_ID, b, device=dev)
    acts, forced = mesh_actions(env.task.act_dim)
    a = torch.as_tensor(acts[:MESH_TASK_STEPS, lo:hi], device=dev)
    f = torch.as_tensor(forced[lo:hi], device=dev)
    env.step(env.reset(seed=1, first_env=lo), a[0])  # warm-up
    s = env.reset(seed=0, first_env=lo)
    t0 = start()
    for t in range(MESH_TASK_STEPS):
        if t in MESH_FORCED_AT:
            s = s._replace(terminated=s.terminated | f)
        s = env.step(s, a[t])
    torch.cuda.synchronize()
    rec = dict(ms_per_step=(time.perf_counter() - t0) * 1e3 / MESH_TASK_STEPS,
               launches=dict(ce.LAUNCHES), kernel=env.step_fn.kernel)
    g = pmesh.gather_env_state(s, mesh)
    if mesh.rank == 0:
        rec["state"] = env_state_to_numpy(g)
    out["mesh_task"] = rec

    # mesh_ppo: Ant, PPOConfig defaults + normalize_obs, from the JAX checkpoint
    cfg = ppo.PPOConfig(normalize_obs=True)
    env = make_batched(ANT, b, device=dev)
    path = os.path.join(HERE, "examples", "weights", f"{ANT}.trainstate.npz")
    ts = pmesh.replicated(train_state_from_npz(path, device=dev, seed=0)[0], mesh)
    es = env.reset(seed=0, first_env=lo)
    step = ppo.make_train_step(env.task, cfg, step_fn=env.step_fn, mesh=mesh)
    start()
    ts, es, m = step(ts, es)
    rec = dict(metrics={k: float(x) for k, x in m.items()}, leaves=ppo_leaves(ts))
    g = pmesh.gather_env_state(es, mesh)
    if mesh.rank == 0:
        rec["state"] = env_state_to_numpy(g)
    ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts, es, m = step(ts, es)
        float(m["loss"])  # synchronises
        ms.append((time.perf_counter() - t0) * 1e3)
    rec.update(ms_per_train_step=ms, launches=dict(ce.LAUNCHES))
    out["ppo"] = rec

    # mesh_sac: HopperMuJoCo, SACConfig defaults, from the shipped learner
    cfg = sac.SACConfig()
    env = make_batched(MJ_HOPPER, b, device=dev)
    path = os.path.join(HERE, "examples", "weights", f"{MJ_HOPPER}.saclearner.npz")
    ss = sac_state_from_npz(path, b, cfg, device=dev)
    pmesh.replicated(ss[:8], mesh)  # the learner and its generator; the ring is this rank's
    es = env.reset(seed=0, first_env=lo)
    it = sac.make_sac_iteration(env.task, cfg, step_fn=env.step_fn, mesh=mesh)
    start()
    for _ in range(SAC_WARM + SAC_LEARN):
        ss, es, m = it(ss, es)
    rec = dict(metrics={k: float(x) for k, x in m.items()}, leaves=sac_leaves(ss))
    ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ss, es, m = it(ss, es)
        float(m["critic_loss"])
        ms.append((time.perf_counter() - t0) * 1e3)
    rec.update(ms_per_iteration=ms, launches=dict(ce.LAUNCHES),
               ring_envs=int(ss.buf_obs.shape[-1]), buf_ptr=ss.buf_ptr)
    out["sac"] = rec
    return out


# ---- user tasks on the card: task_step_kernel and the composed backend -------
USER_MODELS = (CHEETAH, ANT, HUMANOID, PUSHER, PENDULUM)  # point, pair, disk rows and none
USER_MODEL_STEPS = 20
USER_FORCED_AT = (0, 10)  # steps before which every third env is forced to reset
USER_ID = "BackwardCheetah-v0"
USER_STEPS = 50
USER_PLAIN_STEPS = 5  # of them held to the plain version (about 2 s a step at B=4096)
TASK_SOURCE = "pybulletgym_tpu_torch/csrc/task_step.cu"


def backward_cheetah_task():
    """A user's task: HalfCheetah paid for running backwards (the progress
    component negated), with an aux key the env kernel does not know (steps
    with a negative root x-velocity) and a pre-physics push on the back
    thigh (tests/test_torch_custom_task.py holds the same task against the
    JAX package)."""
    import torch

    from pybulletgym_tpu_torch.envs import locomotion as loco

    class BackwardCheetah(loco.WalkerTask):
        PUSH = 0.5

        def __init__(self):
            super().__init__(loco.HALF_CHEETAH)
            self.push_dof = self.model.dof_index("bthigh")

        def initial_state_scalar(self, seed, env_id, epoch):
            q, v, aux = super().initial_state_scalar(seed, env_id, epoch)
            return q, v, dict(aux, backward_steps=torch.zeros_like(aux["potential"]))

        def pre_physics_scalar(self, q, v, aux, ids=None):
            v = list(v)
            v[self.push_dof] = v[self.push_dof] + self.PUSH
            return q, v, aux

        def output_scalar(self, q, v, depths, a, aux, ids=None):
            obs, reward, term, aux2, comps = super().output_scalar(q, v, depths, a, aux, ids)
            progress = comps["progress"]
            back = aux["backward_steps"] + torch.where(v[0] < 0.0, 1.0, 0.0)
            return (obs, reward - 2.0 * progress, term, dict(aux2, backward_steps=back),
                    dict(comps, progress=-progress))

    return BackwardCheetah()


def user_task_paths(card):
    """Any task's env step on the card at B=4096, each path with the launch
    counts reset just before it and read just after. Returns ({path:
    launches}, the task kernel's entry of the kernels line less its
    launches).

    * Build: `task_step_kernel` (csrc/task_step.cu with the task's hooks
      translated by ops/task_kernel.py) for HalfCheetah, Ant, Humanoid,
      Pusher, InvertedPendulum (their shipped classes, translated as a
      user's would be) and BackwardCheetah, one nvcc each, all together.
    * `task_kernel:<id>`, the five models: 20 steps of seeded actions, every
      third env forced to reset before steps 0 and 10: task_step_kernel 20
      launches, nothing else. From each step's input, the hand-written
      env_step_kernel's step within the model's bounds, and at the forced
      steps the reset (no physics) bitwise the env kernel's.
    * `composed:<id>`, the same models through `backend="composed"` (the
      hooks in torch around physics_step_kernel, replayed from a CUDA
      graph): physics_step_kernel 20, nothing else; each step bitwise the
      eager composed step and within the model's bounds of the task
      kernel's. Times of every backend, the capture's ms.
    * `user_task`: BackwardCheetah registered and made by ID (the default
      backend): 50 steps, task_step_kernel 50; the first 5 held to the plain
      version on the card (env_step_plain) and to the composed step; the
      composed step's times (graph, replay, eager, capture).
    * `ppo:BackwardCheetah-v0`: 3 `ppo.train` steps on its ID
      (PPOConfig(normalize_obs=True)): finite, task_step_kernel 96."""
    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(HERE, "tests"))
    from test_torch_cuda import bounds_env, bounds_fixed, bounds_humanoid

    import pybulletgym_tpu_torch as pt
    from pybulletgym_tpu_torch.envs.base import env_step_plain
    from pybulletgym_tpu_torch.ops import cuda_engine as ce
    from pybulletgym_tpu_torch.ops import task_kernel as tk
    from pybulletgym_tpu_torch.parallel import ppo

    dev = torch.device("cuda", 0)
    fields = ("q", "v", "obs", "reward", "terminated", "truncated", "step_count", "epoch")
    launches = {}
    none = dict.fromkeys(ce.LAUNCHES, 0)

    def bitwise(a, b):
        return (all(torch.equal(getattr(a, k), getattr(b, k)) for k in fields)
                and all(torch.equal(a.aux[k], b.aux[k]) for k in b.aux)
                and all(torch.equal(a.rewards[k], b.rewards[k]) for k in b.rewards))

    def counted(fn):
        torch.cuda.synchronize()
        ce.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        return out, dict(ce.LAUNCHES)

    def max_dq(a, b):
        return (a.q - b.q).abs().max().item()

    def holder(env_id, task):
        return {HUMANOID: bounds_humanoid, PUSHER: bounds_fixed, PENDULUM: bounds_fixed}.get(
            env_id, lambda a, b: bounds_env(a, b, len(task.foot_rows)))

    # ---- build every task kernel at once ----------------------------------
    pt.register(USER_ID, backward_cheetah_task, 1000)
    tasks = {env_id: pt.make_task(env_id) for env_id in USER_MODELS + (USER_ID,)}
    t0 = time.perf_counter()
    steps = {env_id: tk.CudaTaskStep(task) for env_id, task in tasks.items()}
    for st in steps.values():
        st.prepare()
    trace_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    logs = tk.build_task_libraries(steps.values())
    build_s = time.perf_counter() - t0
    libs = []
    for env_id, st in steps.items():
        path = os.path.join(ce.BUILD_DIR, tk._cuda_job(st.program.source, st.tables.lanes)[1])
        rep = [dict(k, G=st.tables.lanes) for k in ptxas_report(logs[path])]
        cfg = st.launch_config(dev, B)
        libs.append({"env": env_id, "hook_statements": st.program.ops,
                     "hook_flops": st.program.flops, "ptxas": rep, "launch": cfg})
    emit("task_build", trace_seconds=trace_s, nvcc_seconds=build_s, kernels=libs, card=card)

    # ---- the five models: task_step_kernel, then the composed backend -------
    def rollout(env_id, step_fn, fresh):
        acts = torch.as_tensor(np.random.default_rng(12).uniform(
            -1, 1, (USER_MODEL_STEPS, tasks[env_id].act_dim, B)).astype(np.float32), device=dev)
        forced = torch.zeros(B, dtype=torch.bool, device=dev)
        forced[::3] = True
        s, out = fresh, []
        for t in range(USER_MODEL_STEPS):
            if t in USER_FORCED_AT:
                s = s._replace(terminated=s.terminated | forced)
            out.append((s, acts[t], step_fn(s, acts[t])))
            s = out[-1][2]
        return out, forced

    timing = {}
    for env_id in USER_MODELS:
        task, tstep = tasks[env_id], steps[env_id]
        fused = pt.make_batched(env_id, B)
        require(fused.step_fn.kernel == "env_step_kernel", f"{env_id}: {fused.step_fn.kernel}")
        hold = holder(env_id, task)
        (ksteps, forced), n = counted(lambda: rollout(env_id, tstep, fused.reset(seed=3)))
        launches["task_kernel:" + env_id] = n
        require(n == dict(none, task_step_kernel=USER_MODEL_STEPS), f"{env_id} task kernel: {n}")
        worst_fused = dict.fromkeys(("q", "obs", "reward"), 0.0)
        reset_k = tk.CudaTaskStep(task, frame_skip=0)
        reset_f = ce.make_cuda_env_step(task, frame_skip=0)
        for t, (s, a, out) in enumerate(ksteps):
            f = fused.step_fn(s, a)
            hold(out, f)
            for k in worst_fused:
                worst_fused[k] = max(worst_fused[k],
                                     (getattr(out, k) - getattr(f, k)).abs().max().item())
            if t in USER_FORCED_AT:
                rk, rf = reset_k(s, a), reset_f(s, a)
                require(torch.equal(rk.q[:, forced], rf.q[:, forced])
                        and torch.equal(rk.v[:, forced], rf.v[:, forced])
                        and torch.equal(rk.epoch, rf.epoch),
                        f"{env_id} step {t}: the task kernel's reset differs from the env kernel's")
        require(bool(torch.isfinite(ksteps[-1][2].q).all()), f"{env_id}: non-finite")

        comp = pt.make_batched(env_id, B, backend="composed")
        eager = pt.make_batched(env_id, B, backend="composed", graph=False)
        (csteps, _), n = counted(lambda: rollout(env_id, comp.step_fn, fused.reset(seed=3)))
        launches["composed:" + env_id] = n
        require(n == dict(none, physics_step_kernel=USER_MODEL_STEPS), f"{env_id} composed: {n}")
        worst_comp = 0.0
        for (s, a, out), (_, _, k) in zip(csteps, ksteps):
            require(bitwise(out, eager.step_fn(s, a)),
                    f"{env_id}: the graph replay differs from the eager composed step")
            hold(out, tstep(s, a))
            worst_comp = max(worst_comp, max_dq(out, tstep(s, a)))
        s, a = ksteps[5][0], ksteps[5][1]
        g = next(iter(comp.step_fn._graphs.values()))
        flops, nbytes = tk.work_per_task_step(
            tstep.tables, tstep.program, (s.terminated | s.truncated).float().mean().item())
        t_ops = flops * B / PEAK_FP32_FLOPS * 1e3
        t_bytes = (nbytes * B + ctypes.sizeof(tstep.tables)) / PEAK_BYTES_PER_S * 1e3
        rec = dict(
            task_kernel_ms=graph_ms(lambda: tstep(s, a)),
            task_kernel_host_ms=host_ms(lambda: tstep(s, a), 20),
            fused_ms=graph_ms(lambda: fused.step_fn(s, a)),
            composed_graph_host_ms=host_ms(lambda: comp.step_fn(s, a), 20),
            composed_replay_ms=cuda_ms(g.graph.replay, 10),
            composed_eager_host_ms=host_ms(lambda: eager.step_fn(s, a), 3),
            capture_ms=comp.step_fn.capture_ms)
        rec.update({k.replace("_ms", "_env_steps_per_s"): B * 1e3 / v
                    for k, v in list(rec.items()) if k != "capture_ms"})
        rec.update(task_kernel_bound_ms=max(t_ops, t_bytes),
                   task_kernel_bound_by="operations" if t_ops >= t_bytes else "bytes",
                   flops_per_env_step=flops, bytes_per_env_step=nbytes)
        timing[env_id] = rec
        emit("user_task_model", env=env_id, B=B, steps=USER_MODEL_STEPS,
             forced_reset_at=USER_FORCED_AT,
             launches={"task_kernel": launches["task_kernel:" + env_id],
                       "composed": launches["composed:" + env_id]},
             max_abs_diff_task_vs_env_kernel=worst_fused, max_dq_composed_vs_task=worst_comp,
             resets_bitwise=True, graph_vs_eager_bitwise=True, card=card, **rec)

    # ---- a user's task by its registered ID, then PPO on it ----------------
    task = tasks[USER_ID]
    acts = torch.as_tensor(np.random.default_rng(13).uniform(
        -1, 1, (USER_STEPS, B, task.act_dim)).astype(np.float32), device=dev)

    def user_rollout():  # no forced resets: step t's output is t+1's input
        env = pt.make_batched(USER_ID, B)
        states = [env.reset(seed=4)]
        for t in range(USER_STEPS):
            states.append(env.step(states[-1], acts[t]))
        return env, states

    (uenv, states), n = counted(user_rollout)
    launches["user_task"] = n
    require(uenv.backend == "fused" and uenv.step_fn.kernel == "task_step_kernel"
            and n == dict(none, task_step_kernel=USER_STEPS), f"{USER_ID}: {n}")
    comp = pt.make_batched(USER_ID, B, backend="composed")
    plain, vs_comp, plain_ms = {}, {}, []
    for t in range(USER_PLAIN_STEPS):
        a = acts[t].T.contiguous()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p = env_step_plain(task, states[t], a)
        torch.cuda.synchronize()
        plain_ms.append((time.perf_counter() - t0) * 1e3)
        bounds_env(states[t + 1], p, len(task.foot_rows))
        c = comp.step_fn(states[t], a)
        bounds_env(states[t + 1], c, len(task.foot_rows))
        plain[t], vs_comp[t] = max_dq(states[t + 1], p), max_dq(states[t + 1], c)
    last = states[-1]
    require(bool(torch.isfinite(last.q).all()) and "backward_steps" in last.aux
            and bool((last.aux["backward_steps"] >= 0).all()), f"{USER_ID}: final state")
    s, a = states[5], acts[5].T.contiguous()
    eager = pt.make_batched(USER_ID, B, backend="composed", graph=False)
    g = next(iter(comp.step_fn._graphs.values()))
    composed = dict(composed_graph_host_ms=host_ms(lambda: comp.step_fn(s, a), 20),
                    composed_replay_ms=cuda_ms(g.graph.replay, 10),
                    composed_eager_host_ms=host_ms(lambda: eager.step_fn(s, a), 3),
                    capture_ms=comp.step_fn.capture_ms)
    ustep = uenv.step_fn
    flops, nbytes = tk.work_per_task_step(
        ustep.tables, ustep.program, (s.terminated | s.truncated).float().mean().item())
    t_ops = flops * B / PEAK_FP32_FLOPS * 1e3
    t_bytes = (nbytes * B + ctypes.sizeof(ustep.tables)) / PEAK_BYTES_PER_S * 1e3
    entry = {
        "name": "task_step_kernel", "route": "cuda", "source": TASK_SOURCE,
        "replaces": REPLACES["task_step_kernel"], "max_abs_err": max(plain.values()),
        "ms": graph_ms(lambda: ustep(s, a)), "eager_ms": cuda_ms(lambda: ustep(s, a), 50),
        "plain_ms": min(plain_ms), "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes", "library_ms": None,
        "B": B, "timed_on": USER_ID, "flops_per_env_step": flops, "bytes_per_env_step": nbytes,
        "models": [USER_ID] + list(USER_MODELS), "per_model": timing, **composed}
    emit("user_task", env=USER_ID, task=type(task).__name__, B=B, steps=USER_STEPS,
         launches=n, held_to_plain_steps=USER_PLAIN_STEPS, max_dq_vs_plain=plain,
         max_dq_vs_composed=vs_comp, aux_keys=sorted(last.aux),
         backward_steps_mean=last.aux["backward_steps"].mean().item(),
         ms=entry["ms"], eager_ms=entry["eager_ms"], plain_ms=entry["plain_ms"],
         bound_ms=entry["bound_ms"], bound_by=entry["bound_by"],
         env_steps_per_s=B * 1e3 / entry["ms"], card=card, **composed)

    cfg = ppo.PPOConfig(normalize_obs=True)
    (ts, es, m), n = counted(lambda: ppo.train(USER_ID, B, 3, cfg, seed=0))
    launches["ppo:" + USER_ID] = n
    metrics = {k: float(x) for k, x in m.items()}
    emit("user_task_ppo", env=USER_ID, B=B, train_steps=3, launches=n, metrics=metrics,
         card=card)
    require(all(np.isfinite(list(metrics.values()))), f"non-finite PPO metrics {metrics}")
    require(n == dict(none, task_step_kernel=3 * cfg.rollout_length), f"user-task PPO: {n}")
    return launches, entry


# ---- the translation's ops and a shaped-reward user task (task_ops_paths) ---
OPS_STEPS = 20
OPS_FORCED_AT = (0, 10)  # steps before which every third env is forced to reset
SHAPED_PLAIN_AT = (0, 10)  # ShapedAnt's steps held to the plain version (seconds a step)


def task_ops_paths(card):
    """The translation's ops on the card at B=4096, each path with the
    launch counts reset just before it and read just after. Returns
    ({path: launches}, {env ID: the task kernel's record}).

    * Build: `task_step_kernel` with the hooks of OpProbe (an op an obs
      entry, tests/torch_user_tasks.py) and of ShapedAnt, both registered by
      ID, one nvcc each, together; ptxas: no spills, stack frames under 1 KB.
    * `task_ops:<id>`: 20 steps by ID (`make_batched`, the default fused
      backend), every third env forced to reset before steps 0 and 10:
      task_step_kernel 20 launches, nothing else. The probe's steps each
      held to the plain version on the card (torch's CUDA ops on the same
      inputs): every op's entry bitwise (its largest ulp distance printed),
      the physics within the walkers' bounds of the fixed-base family;
      ShapedAnt's steps 0 and 10 within the walker bounds; the forced envs'
      reset bitwise.
    * `composed:ShapedAnt-v0`: the same ID composed (graph, 20 physics
      launches, nothing else), each step bitwise the eager composed step's,
      and the task kernel's step from the same input: q, obs and reward
      bitwise (each obs entry's largest ulp distance printed).
    * Times: ms a step fused and composed, beside env_step_kernel's on Ant
      in the same run; the plain step's; the bound."""
    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(HERE, "tests"))
    from test_torch_cuda import bounds_env, bounds_fixed
    import torch_user_tasks as ut

    import pybulletgym_tpu_torch as pt
    from pybulletgym_tpu_torch.envs import locomotion as loco
    from pybulletgym_tpu_torch.envs import pendula
    from pybulletgym_tpu_torch.envs.base import env_step_plain
    from pybulletgym_tpu_torch.ops import cuda_engine as ce
    from pybulletgym_tpu_torch.ops import task_kernel as tk

    dev = torch.device("cuda", 0)
    fields = ("q", "v", "obs", "reward", "terminated", "truncated", "step_count", "epoch")
    none = dict.fromkeys(ce.LAUNCHES, 0)
    launches, timing = {}, {}

    def counted(fn):
        torch.cuda.synchronize()
        ce.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        return out, dict(ce.LAUNCHES)

    def bitwise(a, b):  # bit for bit: a zero's sign counts
        return (all(same_bits(getattr(a, k), getattr(b, k)) for k in fields)
                and all(same_bits(a.aux[k], b.aux[k]) for k in b.aux)
                and all(same_bits(a.rewards[k], b.rewards[k]) for k in b.rewards))

    # ---- build both task kernels at once -----------------------------------
    pt.register(ut.OP_PROBE_ID, ut.op_probe(pendula, torch), 1000)
    pt.register(ut.SHAPED_ANT_ID, ut.shaped_ant(loco, torch, ut.NN_TORCH), ut.SHAPED_ANT_STEPS)
    ids = (ut.OP_PROBE_ID, ut.SHAPED_ANT_ID)
    tasks = {env_id: pt.make_task(env_id) for env_id in ids}
    t0 = time.perf_counter()
    steps = {env_id: tk.CudaTaskStep(task) for env_id, task in tasks.items()}
    for st in steps.values():
        st.prepare()
    trace_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    logs = tk.build_task_libraries(steps.values())
    build_s = time.perf_counter() - t0
    libs = []
    for env_id, st in steps.items():
        rep = [dict(k, G=st.tables.lanes) for k in
               ptxas_report(logs[os.path.join(ce.BUILD_DIR, st.cuda_job()[1])])]
        libs.append({"env": env_id, "hook_statements": st.program.ops,
                     "hook_flops": st.program.flops, "ptxas": rep,
                     "launch": st.launch_config(dev, B)})
    emit("task_ops_build", trace_seconds=trace_s, nvcc_seconds=build_s, kernels=libs, card=card)
    for lib in libs:
        for k in lib["ptxas"]:
            require(k["spill_stores"] == 0 and k["spill_loads"] == 0 and k["stack_bytes"] < 1024,
                    f"ptxas, {lib['env']}: {k}")

    forced = torch.zeros(B, dtype=torch.bool, device=dev)
    forced[::3] = True

    def actions(env_id):
        if env_id == ut.OP_PROBE_ID:
            a = [ut.probe_actions(B, 100 + t) for t in range(OPS_STEPS)]
        else:
            a = np.random.default_rng(14).uniform(-1, 1, (OPS_STEPS, tasks[env_id].act_dim, B))
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    def rollout(step_fn, fresh, acts):
        s, out = fresh, []
        for t in range(OPS_STEPS):
            if t in OPS_FORCED_AT:
                s = s._replace(terminated=s.terminated | forced)
            out.append((s, acts[t], step_fn(s, acts[t])))
            s = out[-1][2]
        return out

    # env_step_kernel on Ant, the yardstick of this run
    ant = pt.make_batched(ANT, B)
    sa = ant.reset(seed=3)
    aa = actions(ut.SHAPED_ANT_ID)[0]
    ant_ms = graph_ms(lambda: ant.step_fn(sa, aa))

    for env_id in ids:
        task = tasks[env_id]
        probe = env_id == ut.OP_PROBE_ID
        fused = pt.make_batched(env_id, B)
        require(fused.backend == "fused" and fused.step_fn.kernel == "task_step_kernel",
                f"{env_id}: {fused.backend}, {fused.step_fn.kernel}")
        acts = actions(env_id)
        fresh = fused.reset(seed=3)
        ksteps, n = counted(lambda: rollout(fused.step_fn, fresh, acts))
        launches["task_ops:" + env_id] = n
        require(n == dict(none, task_step_kernel=OPS_STEPS), f"{env_id} task kernel: {n}")
        reset_k = tk.CudaTaskStep(task, frame_skip=0)
        plain_ms, max_dq, ops = [], 0.0, {}
        for t, (s, a, out) in enumerate(ksteps):
            if probe or t in SHAPED_PLAIN_AT:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                p = env_step_plain(task, s, a)
                torch.cuda.synchronize()
                plain_ms.append((time.perf_counter() - t0) * 1e3)
                (bounds_fixed if probe else
                 lambda x, y: bounds_env(x, y, len(task.foot_rows)))(out, p)
                max_dq = max(max_dq, (out.q - p.q).abs().max().item())
                if probe:  # each op against torch's CUDA kernel, on the same inputs
                    h, g = out.obs.cpu().numpy(), p.obs.cpu().numpy()
                    for k, (name, _) in enumerate(ut.OP_ENTRIES):
                        was = ops.get(name, (True, 0))
                        ops[name] = (was[0] and np.array_equal(h[k].view(np.int32),
                                                               g[k].view(np.int32)),
                                     max(was[1], int(ut.ulps(h[k], g[k]).max())))
            if t in OPS_FORCED_AT:
                rk, rp = reset_k(s, a), env_step_plain(task, s, a, frame_skip=0)
                require(torch.equal(rk.q[:, forced], rp.q[:, forced])
                        and torch.equal(rk.v[:, forced], rp.v[:, forced])
                        and torch.equal(rk.epoch, rp.epoch),
                        f"{env_id} step {t}: the task kernel's reset differs from the plain one")
        last = ksteps[-1][2]
        require(bool(torch.isfinite(last.q).all()) and sorted(last.aux) == sorted(fresh.aux),
                f"{env_id}: the final state")
        if probe:
            emit("task_ops_probe", env=env_id, B=B, steps=OPS_STEPS,
                 entries={k: {"bitwise": v[0], "max_ulp": v[1]} for k, v in ops.items()},
                 card=card)
            require(all(ok for ok, _ in ops.values()),
                    f"ops off torch's CUDA kernels: {[k for k, v in ops.items() if not v[0]]}")
        st = fused.step_fn
        s, a = ksteps[5][0], ksteps[5][1]
        flops, nbytes = tk.work_per_task_step(
            st.tables, st.program, (s.terminated | s.truncated).float().mean().item())
        t_ops = flops * B / PEAK_FP32_FLOPS * 1e3
        t_bytes = (nbytes * B + ctypes.sizeof(st.tables)) / PEAK_BYTES_PER_S * 1e3
        rec = dict(ms=graph_ms(lambda: st(s, a)), host_ms=host_ms(lambda: st(s, a), 20),
                   plain_ms=min(plain_ms), max_abs_err=max_dq,
                   bound_ms=max(t_ops, t_bytes),
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   flops_per_env_step=flops, bytes_per_env_step=nbytes,
                   env_step_kernel_ant_ms=ant_ms)
        if not probe:
            comp = pt.make_batched(env_id, B, backend="composed")
            eager = pt.make_batched(env_id, B, backend="composed", graph=False)
            csteps, n = counted(lambda: rollout(comp.step_fn, fresh, acts))
            launches["composed:" + env_id] = n
            require(n == dict(none, physics_step_kernel=OPS_STEPS), f"{env_id} composed: {n}")
            obs_ulp = np.zeros(task.obs_dim, np.int64)
            q_bitwise, reward_off = True, 0.0
            for s_c, a_c, out in csteps:
                require(bitwise(out, eager.step_fn(s_c, a_c)),
                        f"{env_id}: the graph replay differs from the eager composed step")
                k = fused.step_fn(s_c, a_c)
                q_bitwise = q_bitwise and bool(torch.equal(k.q, out.q))
                obs_ulp = np.maximum(obs_ulp, ut.ulps(k.obs.cpu().numpy(),
                                                      out.obs.cpu().numpy()).max(1))
                reward_off = max(reward_off, (k.reward - out.reward).abs().max().item())
                bounds_env(k, out, len(task.foot_rows))
            g = next(iter(comp.step_fn._graphs.values()))
            rec.update(composed_graph_host_ms=host_ms(lambda: comp.step_fn(s, a), 20),
                       composed_replay_ms=cuda_ms(g.graph.replay, 10),
                       composed_eager_host_ms=host_ms(lambda: eager.step_fn(s, a), 3),
                       capture_ms=comp.step_fn.capture_ms, composed_q_bitwise=q_bitwise,
                       composed_obs_max_ulp=obs_ulp.tolist(), composed_reward_max_diff=reward_off)
            require(q_bitwise and int(obs_ulp.max()) == 0 and reward_off == 0.0,
                    f"{env_id}: the task kernel's step differs from the composed one: q bitwise "
                    f"{q_bitwise}, obs ulps {obs_ulp.tolist()}, reward {reward_off}")
        rec["env_steps_per_s"] = B * 1e3 / rec["ms"]
        timing[env_id] = rec
        emit("task_ops", env=env_id, B=B, steps=OPS_STEPS, forced_reset_at=OPS_FORCED_AT,
             launches={p: n for p, n in launches.items() if p.endswith(env_id)},
             held_to_plain_steps=OPS_STEPS if probe else SHAPED_PLAIN_AT,
             resets_bitwise=True, graph_vs_eager_bitwise=not probe or None, card=card, **rec)
    return launches, timing


BIG_ID = "TwoHumanoids-v0"
HUGE_ID = "FourHumanoids-v0"
SIZED_ID = "TenHumanoids-v0"
# steps of a scene by ID; every third env is forced to reset before step 0
# and the middle step. 10, so that the whole run ends within its time limit
# (the ten-Humanoid scene's eager composed step, held bitwise to the graph
# replay each step, takes ~1.6 s)
SCENE_STEPS = 10
BIG_PLAIN_AT = (0,)  # steps held to the plain version (~15 s a step at B=4096 on an H100)
HUGE_PLAIN_AT = (0,)  # the four-Humanoid scene's plain step takes ~3x the two's
SIZED_PLAIN_AT = (0,)  # the ten-Humanoid scene's: ~3x the four's
# the envs of the four- and ten-Humanoid scenes' plain step: the first 512 of
# B=4096 (every third of them forced to reset), the kernels' outputs held
# on the same envs
SCENE_PLAIN_ENVS = 512
BALLS = 7  # free balls: nv 42, over the default caps' 40
HUGE_BALLS = 11  # nv 66, over the large caps' 64
SIZED_BALLS = 40  # nv 240: eight mask words, the scratch outside Y over 227 KB
# The ten-Humanoid scene's batch, the other scenes': its scratch buffer by
# root paths is 108,928 B an env, 0.45 GB at B=4096
SIZED_B = 4096
# the envs of a scene's kernels and its balls' held to the host twins, and
# the mean |dq| allowed. The card and the twin differ by rounding only:
# built with --fmad=false the card equals the twin bit for bit on eleven and
# forty balls, and the Humanoid scenes' gap halves, what stays being
# sinf/cosf's last bits (tools/twin_gap.py on an H100 80GB HBM3). The gap
# grows with the scene, whose torsos stand farther from the origin (2, 4.7,
# 13.6 m): mean |dq| 4.5e-7, 2.9e-6, 1.9e-5 on two, four and ten Humanoids
# (1.8e-5 in this script's timed input); 1e-4 is 5x the largest reading
TWIN_ENVS = 8
TWIN_MEAN_DQ = 1e-4
# timing launches of a scene's kernels: (graph-captured calls, replays,
# eager calls), and of its composed step (graph, replay, eager)
SCENE_TIMING = ((5, 2, 5), (10, 10, 3))
SIZED_TIMING = ((2, 1, 2), (3, 3, 1))


def humanoids_xml(n: int) -> str:
    """n copies of the repository's humanoid.xml in one worldbody: copy k's
    (k >= 2) body, joint, geom and actuator names prefixed with "h{k}_", its
    torso 1.5 (k - 1) m along y (tests/test_torch_big_models.py builds the
    same)."""
    import copy
    import xml.etree.ElementTree as ET

    from pybulletgym_tpu_torch.models.assets import asset_path

    root = ET.parse(asset_path("humanoid.xml")).getroot()
    world, motors = root.find("worldbody"), root.find("actuator")
    body, motor_list = world.find("body"), list(motors)
    for k in range(2, n + 1):
        torso = copy.deepcopy(body)
        for el in torso.iter():
            if "name" in el.attrib:
                el.set("name", f"h{k}_" + el.get("name"))
        torso.set("pos", f"0 {1.5 * (k - 1)} 1.4")
        world.append(torso)
        for m in motor_list:
            m2 = copy.deepcopy(m)
            m2.set("name", f"h{k}_" + m.get("name"))
            m2.set("joint", f"h{k}_" + m.get("joint"))
            motors.append(m2)
    return ET.tostring(root, encoding="unicode")


def humanoids_task(xml: str, n: int):
    """A user's task over `humanoids_xml(n)` (tests/test_torch_big_models.py
    and test_torch_huge_models.py hold the same task against the JAX
    package). Reset: qpos0 plus U(±0.01) on every q and v; torque: each
    actuator's gear times the clipped action; obs: every humanoid's q less
    each root's x and y, and 0.1 v; reward: the torsos' world x-velocities
    plus 1 alive each; done: any torso below z 0.8."""
    import torch

    from pybulletgym_tpu_torch.envs.base import Task
    from pybulletgym_tpu_torch.models.mjcf import parse_mjcf
    from pybulletgym_tpu_torch.ops import rand
    from pybulletgym_tpu_torch.ops.contacts import SolverConfig
    from pybulletgym_tpu_torch.ops.step import PhysicsConfig

    class HumanoidsTask(Task):
        NOISE = 0.01

        def __init__(self):
            self.model = m = parse_mjcf(xml, f"humanoids{n}")
            self.physics = PhysicsConfig(solver=SolverConfig())
            self.act_dofs = [a.v_adr for a in m.actuators]
            self.gears = [float(a.gear) for a in m.actuators]
            names = ["torso"] + [f"h{k}_torso" for k in range(2, n + 1)]
            roots = [m.bodies[m.body_index(name)] for name in names]
            self.root_q = [b.q_adr for b in roots]
            self.root_v = [b.v_adr for b in roots]
            drop = {r + k for r in self.root_q for k in (0, 1)}
            self.obs_q = [j for j in range(m.nq) if j not in drop]
            self.obs_dim = len(self.obs_q) + m.nv
            self.act_dim = len(self.act_dofs)
            self.max_episode_steps = 1000

        def initial_state_scalar(self, seed, env_id, epoch):
            m, noise = self.model, self.NOISE
            q = [float(m.qpos0[j]) + rand.uniform(seed, j, env_id, epoch, -noise, noise)
                 for j in range(m.nq)]
            v = [rand.uniform(seed, m.nq + d, env_id, epoch, -noise, noise) for d in range(m.nv)]
            return q, v, {}

        def action_tau_scalar(self, a):
            tau = [0.0] * self.model.nv
            for d, g, ai in zip(self.act_dofs, self.gears, a):
                tau[d] = g * ai
            return tau

        def _vx(self, q, v, r, d):
            w, x, y, z = q[r + 3], q[r + 4], q[r + 5], q[r + 6]
            return ((1.0 - 2.0 * (y * y + z * z)) * v[d + 3] + 2.0 * (x * y - w * z) * v[d + 4]
                    + 2.0 * (x * z + w * y) * v[d + 5])

        def output_scalar(self, q, v, depths, a, aux, ids=None):
            obs = [q[j] for j in self.obs_q] + [0.1 * x for x in v]
            progress = sum(self._vx(q, v, r, d) for r, d in zip(self.root_q, self.root_v))
            alive = torch.full_like(q[0], float(n))
            fallen = q[self.root_q[0] + 2] < 0.8
            for r in self.root_q[1:]:
                fallen = fallen | (q[r + 2] < 0.8)
            return obs, progress + float(n), fallen, dict(aux), {"alive": alive, "progress": progress}

    return HumanoidsTask()


def balls_xml(n: int, z: float) -> str:
    """n free spheres of radius 0.1 at height z above a floor plane (6n dofs)."""
    balls = "".join(
        f'<body name="b{i}" pos="{0.3 * i} 0 {z}"><joint name="j{i}" type="free"/>'
        f'<geom name="g{i}" type="sphere" size="0.1"/></body>' for i in range(n))
    return ('<mujoco model="balls"><worldbody><geom name="floor" type="plane" '
            f'size="10 10 0.1"/>{balls}</worldbody></mujoco>')


def first_envs(x, n, device=None):
    """The first n envs of a batch-trailing tensor or of an EnvState (moved
    to `device` if given)."""
    if hasattr(x, "q"):
        return type(x)(*[{k: first_envs(y, n, device) for k, y in f.items()}
                         if isinstance(f, dict) else first_envs(f, n, device) for f in x])
    x = x[..., :n].contiguous()
    return x if device is None else x.to(device)


def reset_only(step):
    """A copy of the task kernel wrapper `step` (CudaTaskStep) whose tables
    are at frame_skip 0 (uploaded apart): the same library and buffers, the
    resets without the substeps, without tracing the hooks again."""
    other = copy.copy(step)
    other.tables = type(step.tables).from_buffer_copy(step.tables)
    other.tables.frame_skip = 0
    other.device_tables = {}
    return other


def task_vs_twin(step, s, a, n=TWIN_ENVS, mean_dq=TWIN_MEAN_DQ):
    """The task kernel build `step` (a CudaTaskStep) from the state `s` and
    the actions `a` on the card, against the task's host twin
    (ops.task_kernel.HostTaskTwin: task_step.cu's body built with g++, its
    library built ahead by `scene_build`) on the first n envs: q within
    mean |dq| `mean_dq` and max 2e-3, each env's largest |dv| within 2e-3
    of its largest |v|, epoch and step_count bit for bit; and the resets
    (both at frame_skip 0, `reset_only`): q, v, epoch and step_count bit for
    bit on the envs that `s` resets, of which there must be one. Returns the
    record; raises on a miss."""
    import torch

    from pybulletgym_tpu_torch.ops import task_kernel as tk

    cpu = torch.device("cpu")
    sh, ah = first_envs(s, n, cpu), first_envs(a, n, cpu)
    k = first_envs(step(s, a), n, cpu)
    h = tk.HostTaskTwin(step.task, program=step.program)(sh, ah)
    dq = (k.q - h.q).abs()
    rel = ((k.v - h.v).abs().amax(0) / (h.v.abs().amax(0) + 1e-6)).max().item()
    rk = first_envs(reset_only(step)(s, a), n, cpu)
    rh = tk.HostTaskTwin(step.task, frame_skip=0, program=step.program)(sh, ah)
    f = sh.terminated | sh.truncated
    rec = {"envs": n, "reset_envs": int(f.sum()),
           "bitwise": same_bits(k.q, h.q) and same_bits(k.v, h.v),
           "mean_dq": dq.mean().item(), "max_dq": dq.max().item(), "max_rel_dv": rel,
           "max_d_reward": (k.reward - h.reward).abs().max().item()}
    require(rec["mean_dq"] < mean_dq and rec["max_dq"] < 2e-3 and rel < 2e-3,
            f"{step.kernel}: the card differs from the task's host twin: {rec}")
    require(torch.equal(k.epoch, h.epoch) and torch.equal(k.step_count, h.step_count),
            f"{step.kernel}: epoch or step_count differs from the host twin's")
    require(bool(f.any()) and same_bits(rk.q[:, f], rh.q[:, f])
            and same_bits(rk.v[:, f], rh.v[:, f]) and torch.equal(rk.epoch, rh.epoch)
            and torch.equal(rk.step_count, rh.step_count),
            f"{step.kernel}: the resets differ from the host twin's")
    return rec


def step_as(step, size):
    """A CudaPhysicsStep like `step` whose tables are the same model's in
    the larger fixed size class `size` (LARGE or HUGE:
    `ops.cuda_engine.tables_in_class`): the same model, with the tables and
    the scratch in global memory."""
    from pybulletgym_tpu_torch.ops import cuda_engine as ce

    other = copy.copy(step)
    other.tables, other.size = ce.tables_in_class(step.tables, size), size
    other.kernel = "physics_step_kernel" + ce.KERNEL_SUFFIX[size]
    other.device_tables, other.buffers = {}, {}
    return other


def scene_build(scene_id, humanoids, n_balls, size):
    """A humanoids scene's builds, started: `scene_id` registered
    (`humanoids_xml(humanoids)`), its task's hooks traced
    (`CudaTaskStep.prepare`), the physics steps of the scene and of `n_balls`
    free balls packed in the size class `size`, and the nvcc jobs of the
    class's engine.cu libraries (one nvcc a group width; in the sized class
    one set for the scene's caps and one for the balls') and of task_step.cu
    with the hooks, and the g++ jobs of the class's host twin and of the
    task's (`HostTaskTwin`), started together (`ce.Builds`), running beside
    the caller until `scene_paths` waits for them. Returns a namespace of all that."""
    import types

    import pybulletgym_tpu_torch as pt
    from pybulletgym_tpu_torch.models.mjcf import parse_mjcf
    from pybulletgym_tpu_torch.ops import cuda_engine as ce
    from pybulletgym_tpu_torch.ops import task_kernel as tk
    from pybulletgym_tpu_torch.ops.step import PhysicsConfig

    xml = humanoids_xml(humanoids)
    pt.register(scene_id, lambda: humanoids_task(xml, humanoids), 1000)
    task = pt.make_task(scene_id)
    task_build = tk.CudaTaskStep(task)
    t0 = time.perf_counter()
    task_build.prepare()
    trace_s = time.perf_counter() - t0
    phys = ce.make_cuda_physics_step(task.model, task.physics)[0]
    bm = parse_mjcf(balls_xml(n_balls, 0.09), "balls")
    bcfg = PhysicsConfig()
    bphys = ce.make_cuda_physics_step(bm, bcfg)[0]
    jobs = {}
    for st in (phys, bphys):
        jobs.update({job[2]: job for job in ce._engine_jobs(size, st.caps)[0]})
        twin = ce.host_job(size, st.caps)  # the host twin, against which scene_paths holds the card
        jobs[twin[2]] = twin
    twin = tk.host_task_job(task_build.program, task_build.tables)[0]  # the task's host twin
    jobs[twin[2]] = twin
    tjob, tname = task_build.cuda_job()
    return types.SimpleNamespace(
        task=task, task_build=task_build, trace_s=trace_s, phys=phys, bm=bm, bcfg=bcfg,
        bphys=bphys, n_jobs=len(jobs) + 1, tname=tname, started=time.perf_counter(),
        builds=ce.Builds(list(jobs.values()) + [tjob]))


def scene_paths(card, tag, scene_id, humanoids, n_balls, plain_at, size, B=B,
                timing=SCENE_TIMING, build=None, steps=SCENE_STEPS, plain_envs=None):
    """A humanoids scene over a size class's caps on the card, at B envs,
    each path with the launch counts reset just before it and read just
    after. `size`: the tables' class (ops.cuda_engine.LARGE, HUGE or SIZED),
    whose builds' kernels count apart (`*_large`, `*_huge`, `*_sized`);
    `timing`: the timing launches (SCENE_TIMING); `build`: the scene's
    `scene_build`, if started ahead (its nvcc seconds are then not
    recorded: they ran beside earlier phases); `steps`: the steps of each
    path, every third env forced to reset before step 0 and step
    steps // 2; `plain_envs`: the first envs that the plain step holds (all
    B if None). Returns ({path: launches},
    the class's entries of the kernels line less their launches, the record
    of the `{tag}_model_paths` phase).

    * Build: `scene_build`, waited for (`{tag}_build`).
    * `{tag}_fused`: `scene_id` (`humanoids_xml(humanoids)`) registered and
      made by ID, the default backend: `steps` steps of seeded actions,
      with the forced resets: the class's task_step_kernel build `steps`
      launches, nothing else.
    * `{tag}_composed`: the same ID with backend "composed" (the hooks in
      torch around the class's physics_step_kernel build, replayed from a
      CUDA graph): its `steps` launches, nothing else; each step bitwise the
      eager composed step's and within the humanoid budget of the task
      kernel's from the same input.
    * Held to the plain version on the card (the steps of `plain_at`, from
      the fused rollout's input, on the first `plain_envs` envs): both
      kernels within the humanoid budget, the forced resets (frame_skip 0)
      bitwise.
    * `n_balls` free balls: the class's physics_step_kernel build against
      the plain physics, 3 steps, the walkers' bounds.
    * Each kernel's time (CUDA-graph-timed) beside its bound (over root
      paths, the dense count beside), the plain version's, its launch
      configuration, ptxas report, nvcc seconds and the tables' bytes and
      the device buffer's (the scratch; the dense layout's beside).
    * The physics build and the balls' from the timed inputs against the
      host twin (the same core built with g++) on the first TWIN_ENVS envs,
      within the FMA-contraction bounds of tests/test_torch_cuda.py, and a
      `sweep_blocks` line each: one butterfly a contact row and a limit
      step. The task build against the task's host twin (`task_vs_twin`)
      from the input of the second forced resets: the same bounds, the
      resets, epoch and step_count bit for bit."""
    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(HERE, "tests"))
    from test_torch_cuda import bounds_humanoid

    import pybulletgym_tpu_torch as pt
    from pybulletgym_tpu_torch.envs.base import compose_env_step, env_step_plain
    from pybulletgym_tpu_torch.ops import cuda_engine as ce
    from pybulletgym_tpu_torch.ops import task_kernel as tk
    from pybulletgym_tpu_torch.ops.step import make_physics_step_plain

    dev = torch.device("cuda", 0)
    fields = ("q", "v", "obs", "reward", "terminated", "truncated", "step_count", "epoch")
    none = dict.fromkeys(ce.LAUNCHES, 0)
    suffix = ce.KERNEL_SUFFIX[size]
    names = {"task": "task_step_kernel" + suffix, "physics": "physics_step_kernel" + suffix}
    launches = {}

    def counted(fn):
        torch.cuda.synchronize()
        ce.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        return out, dict(ce.LAUNCHES)

    def bitwise(a, b):
        return (all(torch.equal(getattr(a, k), getattr(b, k)) for k in fields)
                and all(torch.equal(a.rewards[k], b.rewards[k]) for k in b.rewards))

    def hold(a, b, what):
        try:
            bounds_humanoid(a, b)
            require(bool((a.reward - b.reward).abs().median() < 5e-2), "reward median")
        except AssertionError as e:
            raise AssertionError(f"{what}: {e}; max |dq| {(a.q - b.q).abs().max().item()}")
        return (a.q - b.q).abs().max().item()

    # ---- the class's libraries, built at once -----------------------------------
    ahead = build is not None
    build = build or scene_build(scene_id, humanoids, n_balls, size)
    task, task_build, phys = build.task, build.task_build, build.phys
    bm, bcfg, bphys = build.bm, build.bcfg, build.bphys
    m = task.model
    require(task_build.size == size and task_build.kernel == names["task"],
            f"{scene_id}: tables of caps_id {task_build.tables.caps_id}")
    require(phys.size == size and phys.kernel == names["physics"], "the physics tables' class")
    require(bphys.size == size and bm.nv == 6 * n_balls, "the balls' tables' class")
    logs = build.builds.wait()
    nvcc_s = None if ahead else time.perf_counter() - build.started
    _, elog = ce.load_cuda_library(size, phys.caps)
    ptx = {names["physics"]: ptxas_report(elog),
           names["task"]: [dict(k, G=task_build.tables.lanes) for k in ptxas_report(
               logs[os.path.join(ce.BUILD_DIR, build.tname)])]}
    balls_ptx = ptxas_report(ce.load_cuda_library(size, bphys.caps)[1])
    config = {names["physics"]: ce.launch_config(phys.tables, "physics_step_kernel", B),
              names["task"]: task_build.launch_config(dev, B)}
    sizes = dict(bodies=len(m.bodies), nq=m.nq, nv=m.nv, act=task.act_dim, rows=phys.tables.nr,
                 pair_rows=phys.tables.npair, limit_rows=phys.tables.nl, obs=task.obs_dim)
    caps = {st.kernel if st is phys else "balls": dict(zip(ce.SIZED_CAPS, st.caps))
            for st in (phys, bphys) if st.caps is not None}
    if task_build.caps is not None:
        caps[names["task"]] = dict(zip(ce.SIZED_CAPS, task_build.caps))
    buf_bytes = 4 * ce.buffer_floats(task_build.tables)
    emit(f"{tag}_build", env=scene_id, B=B, model=sizes, trace_seconds=build.trace_s,
         nvcc_seconds=nvcc_s, built_beside_earlier_phases=ahead, nvcc_jobs=build.n_jobs,
         table_bytes=ctypes.sizeof(phys.tables),
         buffer_bytes_per_env=buf_bytes, buffer_bytes=buf_bytes * B, caps=caps,
         hook_statements=task_build.program.ops, ptxas=ptx, balls_ptxas=balls_ptx,
         launch=config, card=card)

    # ---- the scene by ID: fused, then composed ---------------------------------
    acts = torch.as_tensor(np.random.default_rng(14).uniform(
        -1, 1, (steps, task.act_dim, B)).astype(np.float32), device=dev)
    forced_at = (0, steps // 2)
    forced = torch.zeros(B, dtype=torch.bool, device=dev)
    forced[::3] = True

    def rollout(step_fn, fresh):
        s, out = fresh, []
        for t in range(steps):
            if t in forced_at:
                s = s._replace(terminated=s.terminated | forced)
            out.append((s, acts[t], step_fn(s, acts[t])))
            s = out[-1][2]
        return out

    fused = pt.make_batched(scene_id, B)
    require(fused.backend == "fused" and fused.step_fn.kernel == names["task"],
            f"{scene_id}: {fused.step_fn.kernel}")
    fresh = fused.reset(seed=3)
    ksteps, n = counted(lambda: rollout(fused.step_fn, fresh))
    launches[f"{tag}_fused"] = n
    require(n == dict(none, **{names["task"]: steps}), f"{scene_id} fused: {n}")
    require(all(bool(torch.isfinite(o.q).all()) for _, _, o in ksteps), f"{scene_id}: non-finite")

    comp = pt.make_batched(scene_id, B, backend="composed")
    eager = pt.make_batched(scene_id, B, backend="composed", graph=False)
    csteps, n = counted(lambda: rollout(comp.step_fn, fresh))
    launches[f"{tag}_composed"] = n
    require(n == dict(none, **{names["physics"]: steps}), f"{scene_id} composed: {n}")
    worst_comp, comp_q_bitwise = 0.0, True
    for t, ((s, a, out), (ks, ka, kout)) in enumerate(zip(csteps, ksteps)):
        require(bitwise(out, eager.step_fn(s, a)),
                f"{scene_id} step {t}: the graph replay differs from the eager composed step")
        c = comp.step_fn(ks, ka)
        worst_comp = max(worst_comp, hold(c, kout, f"composed step {t}"))
        comp_q_bitwise = comp_q_bitwise and torch.equal(c.q, kout.q)

    # ---- both kernels against the plain version ---------------------------------
    plain_phys = make_physics_step_plain(m, task.physics)[0]
    phys_ms = []

    def timed_plain_phys(q, v, tau):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = plain_phys(q, v, tau)
        torch.cuda.synchronize()
        phys_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    reset_k = reset_only(fused.step_fn)
    vs_plain, plain_ms = {}, []
    n_plain = plain_envs or B
    cut = (lambda x: x) if n_plain == B else (lambda x: first_envs(x, n_plain))  # noqa: E731
    for t in plain_at:
        s, a, k = ksteps[t]
        sp, ap = cut(s), cut(a)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p = compose_env_step(task, timed_plain_phys, sp, ap)  # env_step_plain, its physics timed
        torch.cuda.synchronize()
        plain_ms.append((time.perf_counter() - t0) * 1e3)
        c = comp.step_fn(s, a)
        vs_plain[t] = {names["task"]: hold(cut(k), p, f"task kernel step {t}"),
                       names["physics"]: hold(cut(c), p, f"composed step {t}")}
        if t in forced_at:
            rk, rp = cut(reset_k(s, a)), env_step_plain(task, sp, ap, 0)
            f = forced[:n_plain]
            require(torch.equal(rk.q[:, f], rp.q[:, f]) and torch.equal(rk.v[:, f], rp.v[:, f])
                    and torch.equal(rk.epoch, rp.epoch) and torch.equal(rk.step_count, rp.step_count),
                    f"{scene_id} step {t}: the reset differs from the plain version's")

    # ---- free balls: the class's physics build against plain --------------------
    bplain = make_physics_step_plain(bm, bcfg)[0]
    g = torch.Generator(device=dev).manual_seed(5)
    q = torch.as_tensor(np.repeat(bm.qpos0[:, None], B, 1), dtype=torch.float32, device=dev)
    v = torch.rand((bm.nv, B), device=dev, generator=g) - 0.5
    balls = []
    for _ in range(3):
        tau = torch.rand((bm.nv, B), device=dev, generator=g) * 2 - 1
        (qk, vk, dk), (qp, vp, dp) = bphys(q, v, tau), bplain(q, v, tau)
        dq = (qk - qp).abs()
        balls.append({"mean_dq": dq.mean().item(), "max_dq": dq.max().item(),
                      "max_d_depth": (dk - dp).abs().max().item()})
        require(balls[-1]["mean_dq"] < 3e-4 and balls[-1]["max_dq"] < 1e-2, f"balls: {balls}")
        q, v = qp, vp
    bs, bt = q.contiguous(), (torch.rand((bm.nv, B), device=dev, generator=g) * 2 - 1)
    (n_graph, reps, n_eager), (c_graph, c_replay, c_eager) = timing
    balls_ms = graph_ms(lambda: bphys(bs, v, bt), n=4 * n_graph, reps=reps + 1)

    # ---- times ------------------------------------------------------------------
    s, a = ksteps[min(5, steps // 2 - 1)][:2]  # an input between the forced resets
    share = (s.terminated | s.truncated).float().mean().item()
    tstep = fused.step_fn
    tau = torch.zeros((m.nv, B), device=dev)
    tau[task.act_dofs] = torch.tensor(task.gears, device=dev)[:, None] * a.clamp(-1.0, 1.0)
    work = {names["task"]: tk.work_per_task_step(tstep.tables, tstep.program, share),
            names["physics"]: ce.work_per_env_step(phys.tables, env_step=False)}
    timed = {names["task"]: (lambda: tstep(s, a), min(plain_ms)),
             names["physics"]: (lambda: phys(s.q, s.v, tau), min(phys_ms))}
    work_dense = {names["task"]: tk.work_per_task_step(tstep.tables, tstep.program, share,
                                                       dense=True),
                  names["physics"]: ce.work_per_env_step(phys.tables, env_step=False, dense=True)}
    # ---- the card against the host twin (engine_host.cpp: the same core
    # built with g++, the lanes and butterflies emulated in the card's order)
    # on the first TWIN_ENVS envs of the timed inputs, the scene's physics
    # build and the balls'. nvcc contracts products and sums into FMAs and
    # the card's sinf/cosf round otherwise than the host's, so the two agree
    # to those roundings, not bit for bit: max |dq| 2e-3 and each env's
    # largest |dv| within 2e-3 of its largest |v| (as tests/test_torch_cuda.py
    # · test_sweep_matches_the_twin), mean |dq| TWIN_MEAN_DQ
    twin = {}
    for name, (st, args) in {names["physics"]: (phys, (s.q, s.v, tau)),
                             "balls": (bphys, (bs, v, bt))}.items():
        k = [x[..., :TWIN_ENVS].cpu() for x in st(*args)]
        h = ce.HostTwin().physics_step(st.tables, *[x[..., :TWIN_ENVS].cpu().contiguous()
                                                    for x in args])
        dq = (k[0] - h[0]).abs()
        rel = ((k[1] - h[1]).abs().amax(0) / (h[1].abs().amax(0) + 1e-6)).max().item()
        twin[name] = {"envs": TWIN_ENVS, "bitwise": all(same_bits(x, y) for x, y in zip(k, h)),
                      "mean_dq": dq.mean().item(), "max_dq": dq.max().item(),
                      "max_rel_dv": rel, "max_d_depth": (k[2] - h[2]).abs().max().item()}
        require(twin[name]["mean_dq"] < TWIN_MEAN_DQ and twin[name]["max_dq"] < 2e-3 and rel < 2e-3,
                f"{scene_id} {name}: the card differs from the host twin: {twin[name]}")
    # the task build against the task's host twin, from the input of the
    # rollout's second forced resets (envs 0, 3, 6 of the first TWIN_ENVS)
    twin[names["task"]] = task_vs_twin(tstep, *ksteps[forced_at[1]][:2])
    gr = next(iter(comp.step_fn._graphs.values()))
    composed = dict(graph_host_ms=host_ms(lambda: comp.step_fn(s, a), c_graph),
                    replay_ms=cuda_ms(gr.graph.replay, c_replay),
                    eager_host_ms=host_ms(lambda: eager.step_fn(s, a), c_eager),
                    capture_ms=comp.step_fn.capture_ms)
    entries = []
    for name, (fn, p_ms) in timed.items():
        flops, nbytes = work[name]
        t_ops = flops * B / PEAK_FP32_FLOPS * 1e3
        t_bytes = (nbytes * B + ctypes.sizeof(phys.tables)) / PEAK_BYTES_PER_S * 1e3
        ms = graph_ms(fn, n=n_graph, reps=reps)  # 10 ms to seconds a launch
        entries.append({
            "name": name, "route": "cuda",
            "source": TASK_SOURCE if name.startswith("task") else SOURCE,
            "build": ce.CLASS_FLAGS[size][0], "replaces": REPLACES[name[:-len(suffix)]],
            "max_abs_err": max(r[name] for r in vs_plain.values()),
            "ms": ms, "eager_ms": cuda_ms(fn, n_eager), "plain_ms": p_ms, "plain_envs": n_plain,
            "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None, "B": B, "timed_on": scene_id, "env_steps_per_s": B * 1e3 / ms,
            "flops_per_env_step": flops, "bytes_per_env_step": nbytes,
            "table_bytes": ctypes.sizeof(phys.tables), "launch": config[name], "ptxas": ptx[name],
            "buffer_bytes": buf_bytes * B, "caps": caps.get(name),
            "nvcc_seconds": nvcc_s, "models": [scene_id] + (
                [f"{n_balls} free balls"] if name.startswith("physics") else [])})
        entries[-1]["dense"] = {  # L, Y and the sweep dense: the work before the root paths
            "flops_per_env_step": work_dense[name][0],
            "bound_ms": max(work_dense[name][0] * B / PEAK_FP32_FLOPS * 1e3, t_bytes),
            "buffer_bytes_per_env": 4 * ce.dense_stride(tstep.tables if name.startswith(
                "task") else phys.tables)}
        entries[-1]["twin"] = twin[name]
    entries[1]["balls"] = {"ms": balls_ms, "vs_plain": balls, "caps": caps.get("balls"),
                           "launch": ce.launch_config(bphys.tables, "physics_step_kernel", B),
                           "ptxas": balls_ptx, "twin": twin["balls"],
                           "buffer_bytes_per_env": 4 * ce.buffer_floats(bphys.tables)}
    # the sweep: one butterfly a contact row and one a limit step
    # (ops/cuda_engine.py · sweep_group_sums), beside the per-direction count
    for st, label in ((phys, scene_id), (bphys, f"{n_balls} free balls")):
        tab = st.tables
        pairs = sum(ce.limit_pairs(tab))
        sums = ce.sweep_group_sums(tab)
        wide = sum(tab.path_w1[j] > tab.path_w0[j] + 1 for j in range(tab.nr + tab.nl))
        emit("sweep_blocks", env=label, B=B, kernel=st.kernel, contact_rows=tab.nr,
             limit_rows=tab.nl, limit_pairs=pairs, group_sums_a_sweep=sums,
             per_direction_group_sums_a_sweep=3 * tab.nr + tab.nl, rows_past_a_window=wide,
             physics_ms=entries[1]["ms"] if st is phys else balls_ms,
             task_ms=entries[0]["ms"] if st is phys else None,
             scratch_bytes_per_env=4 * tab.sc_stride, dense_bytes_per_env=4 * ce.dense_stride(tab),
             launch=ce.launch_config(tab, "physics_step_kernel", B), card=card)
        require(sums == tab.nr + tab.nl - pairs and 2 * pairs <= tab.nl,
                f"{label}: {sums} group sums a sweep")
    record = dict(env=scene_id, B=B, steps=steps, forced_reset_at=forced_at,
                  launches=launches, held_to_plain_at=plain_at, plain_envs=n_plain,
                  max_dq_vs_plain=vs_plain,
                  resets_bitwise=True, graph_vs_eager_bitwise=True,
                  max_dq_composed_vs_task=worst_comp, composed_q_bitwise_to_task=comp_q_bitwise,
                  composed=composed,
                  kernels={e["name"]: {k: e.get(k) for k in ("ms", "eager_ms", "plain_ms",
                                                              "bound_ms", "bound_by",
                                                              "env_steps_per_s", "dense", "twin")}
                           for e in entries},
                  plain_env_step_ms=min(plain_ms), plain_physics_ms=min(phys_ms), balls=balls,
                  balls_ms=balls_ms, card=card)
    return launches, entries, record


def humanoid_budget(a, b):
    """|dq| of two physics outputs (q, v, depths) against the humanoid
    family's budget (median / mean / max 1.5e-3 / 5e-3 / 8e-2,
    tests/test_pallas_equivalence.py:80-86): (within, the three figures)."""
    dq = (a[0] - b[0]).abs()
    stats = (dq.median().item(), dq.mean().item(), dq.max().item())
    return stats[0] < 1.5e-3 and stats[1] < 5e-3 and stats[2] < 8e-2, stats


def big_model_paths(card, humanoid, build=None):
    """Models over the default tables' caps on the card: engine_core.h's
    large class (-DENG_BIG_TABLES: the default class's substep over root
    paths, the sweep by row windows, the tables and each env's scratch in
    global memory), through `scene_paths` on TwoHumanoids-v0 (the
    two-Humanoid scene: 36 bodies, nq 48, nv 46, 34 actuators, 58 floor
    rows, 68 limit rows; one env's scratch 20,736 B by root paths; paths
    `big_fused`, `big_composed`) held to
    plain at BIG_PLAIN_AT, and seven free balls (nv 42); then what the
    large class costs a model of the default one: Humanoid's physics kernel
    with its default tables (a kernel parameter, the scratch in shared
    memory, M factored over root paths) and with the same tables in the
    large class (the same substep, the sweep by row windows, another build
    of nvcc's), from the inputs of `humanoid` (main's Humanoid parity
    phase: its reset state, torques and plain physics output), each within
    the humanoid budget of the plain step and of the other.
    `build`: the scene's `scene_build`, if started ahead. Returns ({path:
    launches}, the large builds' entries of the kernels line less their
    launches)."""
    import torch

    from pybulletgym_tpu_torch.ops import cuda_engine as ce

    launches, entries, record = scene_paths(card, "big", BIG_ID, 2, BALLS, BIG_PLAIN_AT, ce.LARGE,
                                            build=build)
    dev = torch.device("cuda", 0)
    hs, htau, plain = humanoid["s0"], humanoid["tau"], humanoid["ragged"]["want_phys"]
    h_default = humanoid["phys"]
    h_large = step_as(h_default, ce.LARGE)
    h_large.prepare(dev)
    ho = [f(hs.q, hs.v, htau) for f in (h_default, h_large)]
    budget = {name: humanoid_budget(a, b) for name, (a, b) in (
        ("default_vs_plain", (ho[0], plain)), ("large_vs_plain", (ho[1], plain)),
        ("large_vs_default", (ho[1], ho[0])))}
    tables_ab = {"env": HUMANOID, "bitwise": all(torch.equal(x, y) for x, y in zip(*ho)),
                 "median_mean_max_dq": {k: v[1] for k, v in budget.items()},
                 "default_ms": graph_ms(lambda: h_default(hs.q, hs.v, htau)),
                 "large_ms": graph_ms(lambda: h_large(hs.q, hs.v, htau)),
                 "large_launch": ce.launch_config(h_large.tables, "physics_step_kernel", B)}
    tables_ab["large_again_ms"] = graph_ms(lambda: h_large(hs.q, hs.v, htau))
    tables_ab["default_again_ms"] = graph_ms(lambda: h_default(hs.q, hs.v, htau))
    emit("big_model_paths", **record, tables_in_global_memory=tables_ab)
    for name, (ok, stats) in budget.items():
        require(ok, f"{HUMANOID}: {name} outside the humanoid budget: {stats}")
    return launches, entries


def huge_model_paths(card, build=None):
    """Models over the large tables' caps, or whose one-env scratch outgrows
    a block's shared memory, on the card: engine_core.h's huge class
    (-DENG_HUGE_TABLES: the large class's substep, four mask words, the tables
    and each env's scratch in global memory, the scratch a device buffer of
    B envs' slices), through `scene_paths` on FourHumanoids-v0 (four copies
    of humanoid.xml: 72 bodies, nq 96, nv 92, 68 actuators, 116 floor rows,
    136 limit rows; one env's scratch 233,796 B dense, over a block's 232,448;
    paths `huge_fused`, `huge_composed`) held to plain at HUGE_PLAIN_AT,
    and eleven free balls (nv 66, root paths past dof 63). `build`: the
    scene's `scene_build`, if started ahead. Returns ({path: launches}, the
    huge builds' entries of the kernels line less their launches)."""
    import numpy as np
    import torch

    from pybulletgym_tpu_torch.envs.base import reset_fn
    from pybulletgym_tpu_torch.ops import cuda_engine as ce

    torch.cuda.reset_peak_memory_stats()
    launches, entries, record = scene_paths(card, "huge", HUGE_ID, 4, HUGE_BALLS, HUGE_PLAIN_AT,
                                            ce.HUGE, build=build, plain_envs=SCENE_PLAIN_ENVS)
    peak = torch.cuda.max_memory_allocated()

    # ---- where the huge kernels' time goes: the physics kernel of the two-
    # and four-Humanoid scenes from a seeded reset and seeded torques, each
    # with and without its PGS sweeps (iterations 0); the two-Humanoid
    # scene's also in the huge class against its large tables (both over
    # root paths, the scratch in global memory: the two classes' caps and
    # mask words apart), in turns L H H L
    dev = torch.device("cuda", 0)
    ids = (torch.full((B,), 3, dtype=torch.uint32, device=dev),
           torch.arange(B, dtype=torch.int32, device=dev), torch.zeros(B, dtype=torch.uint32, device=dev))
    split = {}
    for n in (2, 4):
        task = humanoids_task(humanoids_xml(n), n)
        s0 = reset_fn(task, *ids)
        a = torch.as_tensor(np.random.default_rng(15).uniform(-1, 1, (task.act_dim, B)).astype(
            np.float32), device=dev)
        tau = torch.zeros((task.model.nv, B), device=dev)
        tau[task.act_dofs] = torch.tensor(task.gears, device=dev)[:, None] * a
        steps = {"large" if n == 2 else "huge": ce.make_cuda_physics_step(task.model, task.physics)[0]}
        if n == 2:
            steps["huge"] = step_as(steps["large"], ce.HUGE)
        for cls, st in list(steps.items()):
            st0 = copy.copy(st)
            st0.tables = type(st.tables).from_buffer_copy(st.tables)
            st0.tables.iterations = 0
            st0.device_tables, st0.buffers = {}, {}
            steps[cls + "_no_sweeps"] = st0
        for st in steps.values():
            st.prepare(dev, B)
        outs = {k: st(s0.q, s0.v, tau) for k, st in steps.items()}
        order = ["large", "huge", "huge", "large"] if n == 2 else ["huge", "huge"]
        times = {}
        for k in order + [k for k in steps if k.endswith("_no_sweeps")]:
            times.setdefault(k, []).append(graph_ms(lambda: steps[k](s0.q, s0.v, tau), n=5, reps=2))
        split[f"humanoids{n}"] = {
            "ms": times, "launch": {k: ce.launch_config(st.tables, "physics_step_kernel", B)
                                    for k, st in steps.items() if not k.endswith("_no_sweeps")},
            "huge_bitwise_to_large": (all(torch.equal(x, y) for x, y in zip(outs["large"], outs["huge"]))
                                      if n == 2 else None)}
    emit("huge_model_paths", **record, peak_memory_bytes=peak, time_split=split)
    return launches, entries


def sized_model_paths(card, build=None):
    """Models past the huge class on the card: engine_core.h's sized class
    (-DENG_SIZED_TABLES with caps set from the model's sizes: a root-path
    mask of ceil(nv / 32) words, the huge class's substep, the tables and
    the whole scratch in global memory, the scratch a device buffer of B envs' slices
    allocated when the env is made), through `scene_paths` on
    TenHumanoids-v0 (ten copies of
    humanoid.xml: 180 bodies, nq 240, nv 230, 170 actuators, 290 floor rows,
    340 limit rows; eight mask words, one env's scratch outside Y 260,404 B,
    over a block's 232,448; paths `sized_fused`, `sized_composed`) at
    B=SIZED_B, held to plain at SIZED_PLAIN_AT, and forty free balls (nv
    240, scratch outside Y 250,404 B). `build`: its `scene_build`, if
    started ahead. Returns ({path: launches}, the sized builds' entries of
    the kernels line less their launches)."""
    import torch

    from pybulletgym_tpu_torch.ops import cuda_engine as ce

    emit("sized_batch", B=SIZED_B, why="the other scenes' batch: by root paths the scene's "
         "scratch buffer is 108,928 B an env", card=card)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    launches, entries, record = scene_paths(card, "sized", SIZED_ID, 10, SIZED_BALLS,
                                            SIZED_PLAIN_AT, ce.SIZED, SIZED_B, SIZED_TIMING,
                                            build, plain_envs=SCENE_PLAIN_ENVS)
    emit("sized_model_paths", **record, peak_memory_bytes=torch.cuda.max_memory_allocated(),
         seconds=time.perf_counter() - t0)
    return launches, entries


# ---- the examples' scripts, as a user runs them -----------------------------
EXAMPLES = "pybulletgym_tpu_torch.examples"
# runs one example module as `python -m` does, with the launch counts set to
# 0 just before it and printed, with its seconds, on a JSON line after its own
EXAMPLE_RUNNER = """
import json, runpy, sys, time
from pybulletgym_tpu_torch.ops import cuda_engine as ce
sys.argv = sys.argv[1:]
ce.reset_launch_counts()
t0 = time.perf_counter()
runpy.run_module(sys.argv[0], run_name="__main__", alter_sys=True)
print(json.dumps({"launches": dict(ce.LAUNCHES), "seconds": time.perf_counter() - t0}))
"""
EXAMPLE_TIMEOUT = 300  # seconds a script run may take before it is killed


def examples_paths(card):
    """The three scripts of `pybulletgym_tpu_torch/examples/`, each run as a
    user runs it (`python -m`, in a process of its own, on the card), its
    launch counts set to 0 just before it and read just after. Returns
    ({run: launches}, {run: record}).

    * `train_ppo`: HalfCheetah, B=4096, 3 iterations: env_step_kernel 96
      launches and nothing else; the policy file has the JAX script's keys
      and shapes, finite.
    * `train_loop`, twice: Ant, B=4096, 2 iterations a run, into a fresh
      folder: the first starts fresh, the second prints "resuming from";
      64 launches each. Both checkpoints loaded: Adam's count 64, then 128,
      and the first run's files continued here (`ppo.train(resume_from=,
      resume_env_from=)`) give the second run's TrainState bitwise.
    * `enjoy` with the shipped HalfCheetah weights, one episode: return at
      least the shipped-policy floor (3000), a launch a step; again for 100
      steps with `--render`: a (100, 240, 320, 3) uint8 stack from the
      native renderer; and on the file `train_ppo` wrote: it loads, finite.
    Each run's seconds (the script's, and the process's) and its share in
    env_step_kernel: launches times the kernel's graph-replayed ms at that
    batch, measured here, over the script's time."""
    import re
    import shutil

    import numpy as np
    import torch

    import pybulletgym_tpu_torch as pt
    from pybulletgym_tpu_torch.ops import cuda_engine as ce
    from pybulletgym_tpu_torch.parallel import ppo
    from pybulletgym_tpu_torch.utils import checkpoint

    dev = torch.device("cuda", 0)
    env_kernel_ms = {}
    for env_id, Bk in ((CHEETAH, B), (ANT, B), (CHEETAH, 1)):
        kenv = pt.make_batched(env_id, Bk)
        ks = kenv.reset(seed=1)
        ka = torch.rand((kenv.action_size, Bk), device=dev) * 2 - 1
        env_kernel_ms[env_id, Bk] = graph_ms(lambda: kenv.step_fn(ks, ka))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [HERE] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    launches, records = {}, {}

    def run(name, module, env_id, Bk, *args):
        argv = [sys.executable, "-c", EXAMPLE_RUNNER, f"{EXAMPLES}.{module}", env_id, *args]
        t0 = time.perf_counter()
        out = subprocess.run(argv, cwd=HERE, env=env, capture_output=True, text=True,
                             timeout=EXAMPLE_TIMEOUT)
        wall = time.perf_counter() - t0
        require(out.returncode == 0, f"{name}: exit {out.returncode}\n{out.stdout[-3000:]}\n"
                                     f"{out.stderr[-6000:]}")
        *lines, tail = out.stdout.splitlines()
        rec = json.loads(tail)
        n = rec["launches"]
        kms = env_kernel_ms[env_id, Bk] * n["env_step_kernel"]
        records[name] = dict(module=f"{EXAMPLES}.{module}", args=[env_id, *args],
                             seconds=rec["seconds"], process_seconds=wall, launches=n,
                             env_kernel_ms_per_launch=env_kernel_ms[env_id, Bk],
                             env_kernel_share=kms / (rec["seconds"] * 1e3),
                             output=lines[-4:], card=card)
        emit("examples_run", name=name, **records[name])
        require(n["physics_step_kernel"] == 0 and n["task_step_kernel"] == 0
                and all(v == 0 for k, v in n.items() if k != "env_step_kernel"),
                f"{name} launched other kernels: {n}")
        launches[name] = n
        return lines, n["env_step_kernel"], out.stderr

    def episode(lines):
        m = [re.match(r"episode 0: return ([-+0-9.]+) in (\d+) steps", ln) for ln in lines]
        m = [x for x in m if x]
        require(len(m) == 1, f"enjoy printed no episode: {lines[-5:]}")
        return float(m[0].group(1)), int(m[0].group(2))

    with tempfile.TemporaryDirectory() as tmp:
        # train_ppo: HalfCheetah at full width
        pol = os.path.join(tmp, "cheetah.npz")
        lines, n, _ = run("train_ppo", "train_ppo", CHEETAH, B, "--iters", "3", "--batch",
                          str(B), "--out", pol)
        require(n == 3 * 32, f"train_ppo: {n} env_step_kernel launches, not 96")
        require(lines[-1].startswith(f"saved {pol}"), f"train_ppo: {lines[-1:]}")
        task = pt.make_task(CHEETAH)
        sizes = [task.obs_dim, 64, 64]
        want = {"n_layers": (), "log_std": (task.act_dim,)}
        for i, (a, b) in enumerate(zip(sizes, sizes[1:] + [task.act_dim])):
            want.update({f"w{i}": (a, b), f"b{i}": (b,)})
        for i, (a, b) in enumerate(zip(sizes, sizes[1:] + [1])):
            want.update({f"vw{i}": (a, b), f"vb{i}": (b,)})
        with np.load(pol) as d:
            got = {k: d[k].shape for k in d.files}
            finite = all(np.isfinite(d[k]).all() for k in d.files)
        require(got == want and finite, f"train_ppo's file: {got} (finite {finite})")

        # train_loop twice: Ant at full width, resumed from the first run's files
        wdir = os.path.join(tmp, "weights")
        files = {k: os.path.join(wdir, f"{ANT}.{k}.npz") for k in ("trainstate", f"b{B}.envstate")}
        lines, n1, _ = run("train_loop:1", "train_loop", ANT, B, "--iters", "2", "--batch",
                           str(B), "--weights-dir", wdir)
        require(lines[0].startswith("fresh start"), f"train_loop:1: {lines[:1]}")
        first = {k: shutil.copy(f, os.path.join(tmp, f"first.{k}.npz")) for k, f in files.items()}
        lines, n2, _ = run("train_loop:2", "train_loop", ANT, B, "--iters", "2", "--batch",
                           str(B), "--weights-dir", wdir)
        require(lines[0].startswith("resuming from"), f"train_loop:2: {lines[:1]}")
        require(n1 == n2 == 2 * 32, f"train_loop: {n1}, {n2} env_step_kernel launches, not 64")
        cfg = ppo.PPOConfig(rollout_length=32, learning_rate=3e-4, num_minibatches=8)
        tant = pt.make_task(ANT)
        like = ppo.init_train_state(0, tant.obs_dim, tant.act_dim, cfg)
        ts1 = checkpoint.load(first["trainstate"], like)
        ts2 = checkpoint.load(files["trainstate"], like)
        cont = ppo.train(ANT, B, 2, cfg, resume_from=first["trainstate"],
                         resume_env_from=first[f"b{B}.envstate"])[0]
        l2, lc = checkpoint._flatten(ts2)[0], checkpoint._flatten(cont)[0]
        gens = [(x, y) for x, y in zip(l2, lc) if isinstance(x, torch.Generator)]
        tens = [(x, y) for x, y in zip(l2, lc) if not isinstance(x, torch.Generator)]
        bitwise = (all(torch.equal(x.get_state(), y.get_state()) for x, y in gens)
                   and all(torch.equal(x, y) for x, y in tens))
        max_diff = max(float((x.float() - y.float()).abs().max()) for x, y in tens)
        moved = max(float((x - y).detach().abs().max()) for x, y in
                    zip(ts1.params.leaves(), ts2.params.leaves()))
        records["train_loop:resume"] = dict(
            opt_count=[int(ts1.opt_count), int(ts2.opt_count)], continued_bitwise=bitwise,
            continued_max_abs_diff=max_diff, params_moved_max=moved, card=card)
        emit("examples_resume", env=ANT, B=B, **records["train_loop:resume"])
        require(int(ts1.opt_count) == 64 and int(ts2.opt_count) == 128,
                f"opt_count {int(ts1.opt_count)}, {int(ts2.opt_count)}: not 64, 128")
        require(bitwise, f"the second run is not the first continued (max diff {max_diff})")

        # enjoy: the shipped weights, one episode; then frames; then train_ppo's file
        lines, n, _ = run("enjoy", "enjoy", CHEETAH, 1, "--episodes", "1")
        ret, steps = episode(lines)
        records["enjoy"].update(episode_return=ret, episode_steps=steps,
                                floor=POLICY_FLOOR[CHEETAH])
        require(ret >= POLICY_FLOOR[CHEETAH] and steps == task.max_episode_steps,
                f"enjoy: return {ret} in {steps} steps (floor {POLICY_FLOOR[CHEETAH]})")
        require(n == steps, f"enjoy: {n} launches in {steps} steps")
        frames = os.path.join(tmp, "frames.npy")
        lines, n, err = run("enjoy:render", "enjoy", CHEETAH, 1, "--episodes", "1",
                            "--max-steps", "100", "--render", frames)
        stack = np.load(frames)
        records["enjoy:render"].update(shape=list(stack.shape), dtype=str(stack.dtype))
        require(stack.shape == (100, 240, 320, 3) and stack.dtype == np.uint8,
                f"enjoy --render: {stack.shape} {stack.dtype}")
        require("orthographic" not in err, "enjoy --render fell back to the orthographic view")
        require(bool((stack[0] != stack[-1]).any()), "the frames do not move")
        require(n == 100 and lines[-1] == f"saved 100 frames to {frames}", f"enjoy --render: {n}")
        lines, n, _ = run("enjoy:train_ppo", "enjoy", CHEETAH, 1, "--episodes", "1",
                          "--weights", pol)
        ret, steps = episode(lines)
        records["enjoy:train_ppo"].update(episode_return=ret, episode_steps=steps)
        require(np.isfinite(ret) and n == steps, f"enjoy on train_ppo's file: {ret}, {n}")
    emit("examples", card=card, runs={  # env_step_kernel launches, seconds, the kernel's share
        name: [r["launches"]["env_step_kernel"], r["seconds"], r["process_seconds"],
               r["env_kernel_share"]] for name, r in records.items() if "launches" in r})
    return launches, records


def main():
    t_start = time.perf_counter()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this run needs a CUDA GPU")
    sys.path.insert(0, HERE)
    import pybulletgym_tpu_torch as pt
    from pybulletgym_tpu_torch import make_batched, make_task
    from pybulletgym_tpu_torch.envs.base import env_step_plain
    from pybulletgym_tpu_torch.ops import cuda_engine as ce
    from pybulletgym_tpu_torch.parallel import ppo
    from pybulletgym_tpu_torch.utils.interop import policy_from_npz

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = gpu_name_power()
    emit("device", torch=torch.__version__, cuda=torch.version.cuda,
         kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         nvidia_smi=card)

    # ---- build ---------------------------------------------------------
    t0 = time.perf_counter()
    libs, log = ce.load_cuda_library()
    ptxas = ptxas_report(log)
    emit("build", seconds=time.perf_counter() - t0, nvcc=ce.nvcc_path(), lanes=sorted(libs),
         ptxas=ptxas)
    require(len(ptxas) == 2 * len(ce.LANE_WIDTHS), f"ptxas reported {len(ptxas)} kernels")
    for k in ptxas:
        require(k["spill_stores"] == 0 and k["spill_loads"] == 0 and k["stack_bytes"] < 1024,
                f"ptxas: {k}")
    # the scene phases' libraries (nvcc of the ten-Humanoid hooks alone takes
    # ~100 s) build beside the phases before them; killed at exit if still running
    scene_builds = {tag: scene_build(*args) for tag, args in (
        ("big", (BIG_ID, 2, BALLS, ce.LARGE)), ("huge", (HUGE_ID, 4, HUGE_BALLS, ce.HUGE)),
        ("sized", (SIZED_ID, 10, SIZED_BALLS, ce.SIZED)))}
    for build in scene_builds.values():
        atexit.register(build.builds.stop)

    # ---- each model's launch configuration at B=4096 -------------------------
    configs = {}
    for env_id in (CHEETAH, ANT, HUMANOID, HARDER) + FIXED + MJ + (ATLAS,):
        task = make_task(env_id)
        tabs = {"env_step_kernel": ce.pack_tables(task),
                "physics_step_kernel": ce.pack_physics(task.model, task.physics)}
        configs[env_id] = {k: ce.launch_config(t, k, B) for k, t in tabs.items()}
        for k, cfg in configs[env_id].items():
            emit("launch_config", env=env_id, kernel=k, B=B, nv=task.model.nv, **cfg)

    def torques(task, a):  # (act, B) -> (nv, B): the task's action_tau_scalar
        zero = torch.zeros(a.shape[1], device=dev)
        tau = task.action_tau_scalar(list(torch.clamp(a, -1.0, 1.0)))
        return torch.stack([zero if isinstance(x, float) else x for x in tau], 0)

    def uniform(rng, task, n):
        return torch.as_tensor(rng.uniform(-1, 1, (task.act_dim, n)).astype(np.float32), device=dev)

    # ---- both kernels vs plain, per model -----------------------------------
    def parity(env_id):
        task = make_task(env_id)
        rng = np.random.default_rng(0)
        env = make_batched(env_id, B)
        s0 = env.reset(seed=0)
        tau = torques(task, uniform(rng, task, B))
        phys = ce.make_cuda_physics_step(task.model, task.physics)[0]
        (qk, vk, dk), _ = lmem_delta(lambda: phys(s0.q, s0.v, tau), f"{env_id} physics")
        qp, vp, dp = phys.plain(s0.q, s0.v, tau)
        torch.cuda.synchronize()
        dq = (qk - qp).abs()
        flips = ((dk > 0) != (dp > 0)).float().mean().item()
        phys_err = dq.max().item()
        emit("physics_vs_plain", env=env_id, B=B, mean_dq=dq.mean().item(), max_dq=phys_err,
             max_dv=(vk - vp).abs().max().item(), depth_sign_flip_rate=flips)
        require(dq.mean().item() < 3e-4 and phys_err < 1e-2, "physics kernel q disagrees")
        require(flips < 0.01, "physics kernel depth signs disagree")
        require(torch.isfinite(qk).all().item() and torch.isfinite(vk).all().item(), "non-finite")

        step_k = env.step_fn
        sk = sp = s0
        env_err = 0.0
        nf = len(task.spec.foot_geoms)
        for t in range(3):
            if t == 1:  # force every 3rd env to reset on this step
                forced = torch.zeros(B, dtype=torch.bool, device=dev)
                forced[::3] = True
                sk = sk._replace(terminated=sk.terminated | forced)
                sp = sp._replace(terminated=sp.terminated | forced)
            a = uniform(rng, task, B)
            ins = sk
            sk, _ = lmem_delta(lambda: step_k(ins, a), f"{env_id} env" if t == 0 else None)
            if t == 1:  # bitwise repeatable: same inputs, same outputs
                again = step_k(ins, a)
                for name in ("q", "v", "obs", "reward", "terminated", "truncated",
                             "step_count", "epoch"):
                    require(torch.equal(getattr(sk, name), getattr(again, name)),
                            f"env kernel not repeatable in {name}")
                # the post-reset state, without physics, is bitwise the plain one
                reset_k = ce.make_cuda_env_step(task, frame_skip=0)(ins, a)
                reset_p = env_step_plain(task, ins, a, frame_skip=0)
                require(torch.equal(reset_k.q[:, forced], reset_p.q[:, forced]),
                        "reset q differs from the plain version")
            sp = env_step_plain(task, sp, a)
            torch.cuda.synchronize()
            dq = (sk.q - sp.q).abs()
            dob = (sk.obs - sp.obs).abs()
            dr = (sk.reward - sp.reward).abs()
            env_err = max(env_err, dq.max().item())
            rec = dict(
                step=t + 1, mean_dq=dq.mean().item(), max_dq=dq.max().item(),
                obs_cont_mean=dob[:-nf].mean().item(),
                foot_flip_rate=(dob[-nf:] > 0.5).float().mean().item(),
                median_dreward=dr.median().item(),
                term_flip_rate=(sk.terminated != sp.terminated).float().mean().item(),
            )
            emit("env_vs_plain", env=env_id, B=B, **rec)
            require(rec["mean_dq"] < 3e-4 and rec["max_dq"] < 1e-2, "env kernel q disagrees")
            require(rec["obs_cont_mean"] < 1e-3, "env kernel obs disagree")
            require(rec["foot_flip_rate"] < 0.01, "env kernel foot flags disagree")
            require(rec["median_dreward"] < 5e-3, "env kernel reward disagrees")
            require(rec["term_flip_rate"] < 0.01, "env kernel termination disagrees")
            for name in ("epoch", "step_count", "truncated"):
                require(torch.equal(getattr(sk, name), getattr(sp, name)), f"{name} differs")
        rec = dict(reset_q_bitwise=True, repeat_bitwise=True)
        if task.model.nq != task.model.nv:  # the free root's quaternion
            rec["max_quat_norm_err"] = (1 - sk.q[3:7].norm(dim=0)).abs().max().item()
            require(rec["max_quat_norm_err"] < 1e-5, "quaternion drifted from unit norm")
        emit("reset_and_repeat", env=env_id, **rec)
        return dict(task=task, env=env, s0=s0, tau=tau, phys=phys,
                    phys_err=phys_err, env_err=env_err)

    # ---- the humanoid family: both kernels vs plain, B=4096, one step --------
    # Bounds: the humanoid family's (tests/test_pallas_equivalence.py:80-86).
    def fam_bounds(what, dq, flips=0.0, aux=None):
        require(dq.median().item() < 1.5e-3 and dq.mean().item() < 5e-3
                and dq.max().item() < 8e-2, f"{what}: q disagrees")
        require(flips < 0.01, f"{what}: flips")
        for k, m in (aux or {}).items():
            require(m < 5e-2, f"{what}: aux {k} disagrees")

    def walker_bounds(what, dq, flips, rec=None):
        """The walkers' budget (tests/test_pallas_equivalence.py:38-40): q
        mean and max, flips; an env step's continuous obs, foot flags and
        reward too."""
        require(dq.mean().item() < 3e-4 and dq.max().item() < 1e-2, f"{what}: q disagrees")
        require(flips < 0.01, f"{what}: flips")
        if rec is not None:
            require(rec["obs_cont_mean"] < 1e-3 and rec["foot_flip_rate"] < 0.01
                    and rec["median_dreward"] < 5e-3, f"{what}: obs or reward disagree")

    lmem_log = []

    def lmem_delta(fn, what=None):
        """Run fn; the device memory it took outside torch's allocator: the
        local memory CUDA reserves at a kernel's first launch. Logged with
        the free memory before and after."""
        torch.cuda.synchronize()
        free0, res0 = torch.cuda.mem_get_info()[0], torch.cuda.memory_reserved()
        out = fn()
        torch.cuda.synchronize()
        free1, res1 = torch.cuda.mem_get_info()[0], torch.cuda.memory_reserved()
        delta = (free0 - free1) - (res1 - res0)
        if what is not None:
            lmem_log.append(dict(what=what, free_before=free0, free_after=free1,
                                 torch_reserved_delta=res1 - res0, local_memory_bytes=delta))
        return out, delta

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def parity_humanoid(env_id):
        """Both kernels vs plain on a large model, B=4096: the physics step
        from the reset, and one env step from it with every 3rd env forced
        to reset (bitwise repeatable, the resets bitwise); the humanoid
        family's budget, or the walkers' where the model has no pair rows
        (Atlas). Returns the inputs and plain outputs too, which `ragged`
        holds the kernels to on the first envs."""
        task = make_task(env_id)
        walker = ce.pack_tables(task).npair == 0
        rng = np.random.default_rng(0)
        env = make_batched(env_id, B)
        s0 = env.reset(seed=0)
        tau = torques(task, uniform(rng, task, B))
        phys = ce.make_cuda_physics_step(task.model, task.physics)[0]
        (qk, vk, dk), lmem_phys = lmem_delta(lambda: phys(s0.q, s0.v, tau), f"{env_id} physics")
        (qp, vp, dp), plain_phys_ms = timed(lambda: phys.plain(s0.q, s0.v, tau))
        dq = (qk - qp).abs()
        flips = ((dk > 0) != (dp > 0)).float().mean().item()
        phys_err = dq.max().item()
        emit("physics_vs_plain", env=env_id, B=B, median_dq=dq.median().item(),
             mean_dq=dq.mean().item(), max_dq=phys_err, max_dv=(vk - vp).abs().max().item(),
             depth_sign_flip_rate=flips, local_memory_reserved_bytes=lmem_phys, card=card)
        (walker_bounds if walker else fam_bounds)(f"{env_id} physics kernel", dq, flips)
        require(torch.isfinite(qk).all().item() and torch.isfinite(vk).all().item(), "non-finite")

        # one env step from the reset, every 3rd env forced to reset on it (one
        # step keeps the whole run within its time limit: a plain step of these
        # models takes 20-40 s on the card)
        step_k = env.step_fn
        a = uniform(rng, task, B)
        forced = torch.zeros(B, dtype=torch.bool, device=dev)
        forced[::3] = True
        ins = s0._replace(terminated=s0.terminated | forced)
        sk, lmem_env = lmem_delta(lambda: step_k(ins, a), f"{env_id} env")
        sp, plain_env_ms = timed(lambda: env_step_plain(task, ins, a))
        again = step_k(ins, a)
        for name in ("q", "v", "obs", "reward", "terminated", "truncated", "step_count", "epoch"):
            require(torch.equal(getattr(sk, name), getattr(again, name)),
                    f"env kernel not repeatable in {name}")
        reset_k = ce.make_cuda_env_step(task, frame_skip=0)(ins, a)
        reset_p = env_step_plain(task, ins, a, frame_skip=0)
        require(torch.equal(reset_k.q[:, forced], reset_p.q[:, forced]),
                "reset q differs from the plain version")
        for k in ("target_x", "target_y", "flag_count", "flag_timeout", "frame"):
            if k in reset_p.aux:  # the flag draws and counters
                require(torch.equal(reset_k.aux[k][forced], reset_p.aux[k][forced]),
                        f"reset aux {k} differs")
        torch.cuda.synchronize()
        dq = (sk.q - sp.q).abs()
        dob = (sk.obs - sp.obs).abs()
        nf = len(task.spec.foot_geoms)
        aux = {k: (sk.aux[k] - sp.aux[k]).abs().median().item() for k in sp.aux}
        flips = (sk.terminated != sp.terminated).float().mean().item()
        env_err = dq.max().item()
        rec = dict(median_dq=dq.median().item(), mean_dq=dq.mean().item(),
                   max_dq=dq.max().item(), term_flip_rate=flips,
                   median_dreward=(sk.reward - sp.reward).abs().median().item(),
                   obs_cont_mean=dob[:-nf].mean().item(),
                   foot_flip_rate=(dob[-nf:] > 0.5).float().mean().item(), aux_median=aux)
        emit("env_vs_plain", env=env_id, B=B, step=1, forced_reset_share=1 / 3, **rec,
             local_memory_reserved_bytes=lmem_env)
        if walker:
            walker_bounds(f"{env_id} env kernel", dq, flips, rec)
        else:
            fam_bounds(f"{env_id} env kernel", dq, flips, aux)
        for name in ("epoch", "step_count", "truncated"):
            require(torch.equal(getattr(sk, name), getattr(sp, name)), f"{name} differs")
        quat = (1 - sk.q[3:7].norm(dim=0)).abs().max().item()
        emit("reset_and_repeat", env=env_id, reset_q_bitwise=True, repeat_bitwise=True,
             max_quat_norm_err=quat)
        require(quat < 1e-5, "quaternion drifted from unit norm")
        return dict(task=task, env=env, s0=s0, tau=tau, phys=phys, phys_err=phys_err,
                    env_err=env_err, plain_ms={"physics_step_kernel": plain_phys_ms,
                                               "env_step_kernel": plain_env_ms},
                    ragged=dict(s=ins, a=a, want_env=sp, want_phys=(qp, vp, dp)))

    # ---- FlagrunHarder's cube: a forced throw (frame 120, ground_counter 0) ---
    def cube(p):
        task, env, s0 = p["task"], p["env"], p["s0"]
        aux = dict(s0.aux)
        aux["frame"] = torch.full_like(aux["frame"], 120.0)
        aux["ground_counter"] = torch.zeros_like(aux["ground_counter"])
        s = s0._replace(aux=aux)
        a = uniform(np.random.default_rng(5), task, B)
        cq = slice(task.cube_qadr, task.cube_qadr + 7)
        cv = slice(task.cube_vadr, task.cube_vadr + 6)
        rec = {}
        for fs in (0, None):  # the throw alone, then the throw and 4 substeps
            k = (ce.make_cuda_env_step(task, frame_skip=0) if fs == 0 else env.step_fn)(s, a)
            pl = env_step_plain(task, s, a, frame_skip=fs)
            torch.cuda.synchronize()
            tag = "throw" if fs == 0 else "step"
            rec[f"{tag}_max_dq_cube"] = (k.q[cq] - pl.q[cq]).abs().max().item()
            rec[f"{tag}_max_dv_cube"] = (k.v[cv] - pl.v[cv]).abs().max().item()
            rec[f"{tag}_thrown_share"] = ((k.q[cq][2] - s.q[cq][2]).abs() > 0.5).float().mean().item()
            if fs is None:
                dq = (k.q - pl.q).abs()
                rec.update(step_median_dq=dq.median().item(), step_max_dq=dq.max().item())
                fam_bounds("cube step", dq)
        emit("cube", env=HARDER, B=B, **rec)
        require(rec["throw_thrown_share"] == 1.0, "the cube was not thrown in every env")
        require(rec["throw_max_dq_cube"] < 1e-4 and rec["throw_max_dv_cube"] < 1e-3,
                "the cube throw differs from the plain version")
        require(rec["step_max_dq_cube"] < 1e-3 and rec["step_max_dv_cube"] < 1e-2,
                "the thrown cube's flight differs from the plain version")

    # ---- the fixed-base family: both kernels vs plain, B=4096, 2 steps -------
    # Bounds: the walkers' (tests/test_pallas_equivalence.py:38-51).
    def parity_fixed(env_id):
        task = make_task(env_id)
        rng = np.random.default_rng(0)
        env = make_batched(env_id, B)
        s0 = env.reset(seed=0)
        tau = torques(task, uniform(rng, task, B))
        phys = ce.make_cuda_physics_step(task.model, task.physics)[0]
        (qk, vk, dk), _ = lmem_delta(lambda: phys(s0.q, s0.v, tau), f"{env_id} physics")
        (qp, vp, dp), plain_phys_ms = timed(lambda: phys.plain(s0.q, s0.v, tau))
        dq = (qk - qp).abs()
        flips = ((dk > 0) != (dp > 0)).float().mean().item() if dk.numel() else 0.0
        phys_err = dq.max().item()
        emit("physics_vs_plain", env=env_id, B=B, rows=dk.shape[0], mean_dq=dq.mean().item(),
             max_dq=phys_err, max_dv=(vk - vp).abs().max().item(), depth_sign_flip_rate=flips,
             touching_share=(dp > 0).any(0).float().mean().item() if dp.numel() else 0.0)
        require(dq.mean().item() < 3e-4 and phys_err < 1e-2, f"{env_id} physics kernel q disagrees")
        require(flips < 0.01, f"{env_id} physics kernel depth signs disagree")
        require(torch.isfinite(qk).all().item() and torch.isfinite(vk).all().item(), "non-finite")

        step_k = env.step_fn
        sk = sp = s0
        env_err, plain_env_ms = 0.0, None
        for t in range(2):
            a = uniform(rng, task, B)
            if t == 1:  # force every 3rd env to reset on this step
                forced = torch.zeros(B, dtype=torch.bool, device=dev)
                forced[::3] = True
                sk = sk._replace(terminated=sk.terminated | forced)
                sp = sp._replace(terminated=sp.terminated | forced)
                again = step_k(sk, a)
                reset_k = ce.make_cuda_env_step(task, frame_skip=0)(sk, a)
                reset_p = env_step_plain(task, sk, a, frame_skip=0)
                # ReacherMuJoCo's target, r cos and r sin of a disk draw: 1 ulp
                disk = [task.tx, task.ty] if hasattr(task, "tx") else []
                rest = [j for j in range(task.model.nq) if j not in disk]
                require(torch.equal(reset_k.q[rest][:, forced], reset_p.q[rest][:, forced])
                        and torch.equal(reset_k.v[:, forced], reset_p.v[:, forced]),
                        f"{env_id} reset q, v differ from the plain version")
                if disk:
                    qk_, qp_ = reset_k.q[disk][:, forced], reset_p.q[disk][:, forced]
                    target_ulps = (qk_.view(torch.int32).long() - qp_.view(torch.int32).long()
                                   ).abs().max().item()
                    require(target_ulps <= 1, f"{env_id} reset target {target_ulps} ulp apart")
                # the aux that the output hook leaves after a reset is computed
                # from the pose (distances, the strike and hit flags), not
                # drawn: the flags exact, the distances to float32 round-off
                for k in reset_p.aux:
                    dk_ = (reset_k.aux[k][forced] - reset_p.aux[k][forced]).abs().max().item()
                    require(dk_ == 0.0 if k in ("striked", "hit") else dk_ < 1e-5,
                            f"{env_id} reset aux {k} differs by {dk_}")
                sk = step_k(sk, a)
                for name in ("q", "v", "obs", "reward", "terminated", "truncated",
                             "step_count", "epoch"):
                    require(torch.equal(getattr(sk, name), getattr(again, name)),
                            f"env kernel not repeatable in {name}")
                sp = env_step_plain(task, sp, a)
            else:
                sk, _ = lmem_delta(lambda: step_k(sk, a), f"{env_id} env")
                sp, plain_env_ms = timed(lambda: env_step_plain(task, sp, a))
            torch.cuda.synchronize()
            dq = (sk.q - sp.q).abs()
            rec = dict(step=t + 1, mean_dq=dq.mean().item(), max_dq=dq.max().item(),
                       obs_mean=(sk.obs - sp.obs).abs().mean().item(),
                       median_dreward=(sk.reward - sp.reward).abs().median().item(),
                       term_flip_rate=(sk.terminated != sp.terminated).float().mean().item(),
                       aux_median={k: (sk.aux[k] - sp.aux[k]).abs().median().item()
                                   for k in sp.aux})
            env_err = max(env_err, rec["max_dq"])
            emit("env_vs_plain", env=env_id, B=B, **rec)
            require(rec["mean_dq"] < 3e-4 and rec["max_dq"] < 1e-2, f"{env_id} env kernel q")
            require(rec["obs_mean"] < 1e-3, f"{env_id} env kernel obs disagree")
            require(rec["median_dreward"] < 5e-3, f"{env_id} env kernel reward disagrees")
            require(rec["term_flip_rate"] < 0.01, f"{env_id} env kernel termination disagrees")
            for name in ("epoch", "step_count", "truncated"):
                require(torch.equal(getattr(sk, name), getattr(sp, name)), f"{name} differs")
        rec = dict(reset_qv_bitwise=True, repeat_bitwise=True)
        if disk:
            rec.update(reset_qv_bitwise="all but the disk target", target_max_ulps=target_ulps,
                       target_bitwise=target_ulps == 0)
        emit("reset_and_repeat", env=env_id, **rec)
        return dict(task=task, env=env, s0=s0, tau=tau, phys=phys, phys_err=phys_err,
                    env_err=env_err, plain_ms={"physics_step_kernel": plain_phys_ms,
                                               "env_step_kernel": plain_env_ms})

    # ---- both kernels at ragged batches: B=1, 3E+1, 4097 (4096) ---------------
    def take(st, n):
        """The first n envs of a batch-trailing state, each field contiguous."""
        f = lambda x: x[..., :n].contiguous()  # noqa: E731
        names = ("q", "v", "obs", "reward", "terminated", "truncated", "step_count",
                 "epoch", "env_id", "seed")
        return st._replace(**{k: f(getattr(st, k)) for k in names},
                           aux={k: f(x) for k, x in st.aux.items()},
                           rewards={k: f(x) for k, x in st.rewards.items()})

    def ragged(env_id, parity_run=None):
        """One plain env step and one plain physics step on 4097 envs (every
        3rd due for an auto-reset), or those of the model's `parity_humanoid`
        run (B=4096, the plain steps that dominate a large model's time
        taken once); the kernels on the first n envs of the same inputs are
        held to the first n columns (every env is independent), for n = 1,
        3E+1 (one env into a fourth block) and all of them. The bounds of the
        model's family."""
        task = make_task(env_id)
        humanoid = env_id in (HUMANOID, HARDER)  # else the walkers' budget
        if parity_run is None:
            Br = 4097
            env = make_batched(env_id, Br)
            forced = torch.zeros(Br, dtype=torch.bool, device=dev)
            forced[::3] = True
            s = env.reset(seed=7)._replace(terminated=forced)
            a = uniform(np.random.default_rng(7), task, Br)
            tau = torques(task, a)
            phys = ce.make_cuda_physics_step(task.model, task.physics)[0]
            want_env, want_phys = env_step_plain(task, s, a), phys.plain(s.q, s.v, tau)
            phys_in = (s.q, s.v, tau)
        else:
            r, env, phys = parity_run["ragged"], parity_run["env"], parity_run["phys"]
            s, a, want_env, want_phys = r["s"], r["a"], r["want_env"], r["want_phys"]
            phys_in = (parity_run["s0"].q, parity_run["s0"].v, parity_run["tau"])
            Br = s.q.shape[-1]
        for kernel, tables in (("env_step_kernel", env.step_fn.tables),
                               ("physics_step_kernel", phys.tables)):
            E = ce.launch_config(tables, kernel)["E"]
            for n in (1, 3 * E + 1, Br):
                sn, an = take(s, n), a[:, :n].contiguous()
                if kernel == "env_step_kernel":
                    out, want = env.step_fn(sn, an), take(want_env, n)
                    dq = (out.q - want.q).abs()
                    rec = dict(term_flip_rate=(out.terminated != want.terminated).float().mean().item(),
                               median_dreward=(out.reward - want.reward).abs().median().item())
                    for name in ("epoch", "step_count", "truncated"):
                        require(torch.equal(getattr(out, name), getattr(want, name)),
                                f"{env_id} ragged {n}: {name} differs")
                else:
                    qk, vk, dk = phys(*(x[:, :n].contiguous() for x in phys_in))
                    qp, vp, dp = (x[:, :n] for x in want_phys)
                    dq = (qk - qp).abs()
                    rec = dict(depth_sign_flip_rate=((dk > 0) != (dp > 0)).float().mean().item())
                    require(torch.isfinite(qk).all().item(), f"{env_id} ragged {n}: non-finite")
                torch.cuda.synchronize()
                rec.update(median_dq=dq.median().item(), mean_dq=dq.mean().item(),
                           max_dq=dq.max().item())
                emit("ragged_vs_plain", env=env_id, kernel=kernel, B=n, E=E, **rec)
                flips = rec.get("term_flip_rate", rec.get("depth_sign_flip_rate"))
                if humanoid:
                    fam_bounds(f"{env_id} ragged {kernel} B={n}", dq, flips)
                else:
                    require(rec["mean_dq"] < 3e-4 and rec["max_dq"] < 1e-2 and flips < 0.01,
                            f"{env_id} ragged {kernel} B={n} disagrees")

    # ---- disk rows on the regular branch: HalfCheetah, bthigh a cylinder -----
    def disk_regular():
        """physics_step_kernel vs plain, B=4096, from reset states lowered so
        that the slanted cylinder's deepest rim point is 3 mm into the floor
        (as tests/test_torch_engine.py · disk_touch_state)."""
        import dataclasses

        from pybulletgym_tpu_torch.envs import locomotion as loco
        from pybulletgym_tpu_torch.envs.base import reset_fn
        from pybulletgym_tpu_torch.models.schema import GeomType
        from pybulletgym_tpu_torch.ops import contacts as ct
        from pybulletgym_tpu_torch.ops import dynamics as dyn
        from pybulletgym_tpu_torch.ops.step import sc_rows

        task = loco.WalkerTask(loco.HALF_CHEETAH)
        m = task.model
        g = m.geom_index("bthigh")
        cyl = dataclasses.replace(m.geoms[g], gtype=GeomType.CYLINDER)
        task.model = m.replace(geoms=m.geoms[:g] + (cyl,) + m.geoms[g + 1:])
        plan = ct.build_contact_plan(task.model, task.physics.solver)
        disk = [r for r, c in enumerate(sc_rows(plan)) if getattr(c, "kind", "") == "disk"]
        s = reset_fn(task, torch.zeros(B, dtype=torch.uint32, device=dev),
                     torch.arange(B, dtype=torch.int32, device=dev),
                     torch.zeros(B, dtype=torch.uint32, device=dev))
        fk = dyn.forward_kinematics(task.model, list(s.q), list(s.v), with_inertia=False)
        d0 = torch.stack([ct.narrowphase_scalar(task.model, fk, plan).depth[r] for r in disk])
        q = s.q.clone()
        q[1] -= 3e-3 - d0.max(0).values  # rootz
        tau = torques(task, uniform(np.random.default_rng(7), task, B))
        phys = ce.make_cuda_physics_step(task.model, task.physics)[0]
        qk, vk, dk = phys(q, s.v, tau)
        qp, vp, dp = phys.plain(q, s.v, tau)
        torch.cuda.synchronize()
        dq = (qk - qp).abs()
        flips = ((dk > 0) != (dp > 0)).float().mean().item()
        rec = dict(env="HalfCheetah, bthigh a cylinder", B=B, disk_rows=len(disk),
                   mean_dq=dq.mean().item(), max_dq=dq.max().item(),
                   max_dv=(vk - vp).abs().max().item(), depth_sign_flip_rate=flips,
                   max_ddepth_disk=(dk[disk] - dp[disk]).abs().max().item(),
                   tilted_share=(d0[:4].max(0).values - d0[:4].min(0).values > 1e-3)
                   .float().mean().item())
        emit("disk_physics_vs_plain", **rec)
        require(len(disk) == 8 and rec["tilted_share"] == 1.0, "the rim is not tilted")
        require(rec["mean_dq"] < 3e-4 and rec["max_dq"] < 1e-2 and flips < 0.01,
                "physics kernel disagrees on the disk rows")
        return rec["max_dq"]

    # ---- golden rollouts through the env kernel ------------------------------
    def golden(env_id, tpu=False):
        """The CPU goldens, or the TPU-recorded ones: the TPU's XLA path
        takes its products in bf16 (tools/bf16_probe.py) and the stiff
        rest-pose pair overlaps amplify that from the first step, so those
        are held to median |dobs| < 1e-2 at step 5 (as
        tests/test_torch_humanoid_twin.py). AntMuJoCo's and
        HumanoidMuJoCo's medians over all their obs are their zero blocks',
        so the entries the tasks compute are held too: to the CPU budget,
        and HumanoidMuJoCo's to 3e-2 (tests/test_torch_mujoco_family_twin.py).
        Where the JAX package's float32 rollout of a TPU golden's inputs is
        recorded too (tests/goldens_f32/: Atlas, whose TPU golden that
        rollout itself misses by 2.5e-2 at step 5), the kernel is held to
        it at the CPU budget and to the TPU golden's termination, and the
        TPU golden's drift is printed beside the float32 rollout's."""
        task = make_task(env_id)
        g = np.load(os.path.join(HERE, "tests", "goldens",
                                 f"{env_id}.npz" if tpu else f"{env_id}.cpu.npz"))
        f32_path = os.path.join(HERE, "tests", "goldens_f32", f"{env_id}.npz")
        ref = np.load(f32_path) if tpu and os.path.exists(f32_path) else None
        Bg, n_steps, seed = int(g["batch"]), int(g["n_steps"]), int(g["seed"])
        genv = make_batched(env_id, Bg)
        s = genv.reset(seed=seed)
        acts = np.random.default_rng(seed).uniform(-1, 1, (n_steps, Bg, task.act_dim)).astype(np.float32)
        live = task.obs_dim - getattr(task, "n_zero", 0)  # HumanoidMuJoCo: 45 of 376
        meds, live_meds, ref_meds, ref_tpu = [], [], [], []
        for t in range(n_steps):
            s = genv.step(s, acts[t])
            o = s.obs.cpu().numpy()
            d = np.abs(o - g["obs"][t])
            meds.append(float(np.median(d)))
            live_meds.append(float(np.median(d[:live])))
            require(np.array_equal(s.terminated.cpu().numpy(), g["terminated"][t]),
                    f"{env_id} golden termination differs at step {t}")
            if ref is not None:
                ref_meds.append(float(np.median(np.abs(o - ref["obs"][t]))))
                ref_tpu.append(float(np.median(np.abs(ref["obs"][t] - g["obs"][t]))))
                require(np.array_equal(s.terminated.cpu().numpy(), ref["terminated"][t]),
                        f"{env_id} float32 rollout's termination differs at step {t}")
        emit("golden", env=env_id, recorded_on="tpu" if tpu else "cpu",
             median_dobs_step1=meds[0], median_dobs_step5=meds[4], median_dobs_step20=meds[-1],
             computed_obs=live, computed_median_dobs_step5=live_meds[4],
             computed_median_dobs_step20=live_meds[-1])
        if ref is None:
            require(meds[4] < (1e-2 if tpu else 1e-3) and meds[-1] < 3e-2,
                    f"{env_id} golden rollout drifted")
            require(live_meds[4] < (3e-2 if tpu else 1e-3) and live_meds[-1] < 3e-2,
                    f"{env_id} golden rollout's computed obs drifted")
        else:
            emit("golden_float32", env=env_id, median_dobs_by_step=ref_meds,
                 tpu_golden_median_dobs_by_step=meds, float32_vs_tpu_golden_by_step=ref_tpu,
                 tpu_bound_met=meds[4] < 1e-2 and meds[-1] < 3e-2)
            require(ref_meds[4] < 1e-3 and ref_meds[-1] < 3e-2,
                    f"{env_id} drifted from the float32 rollout")
        require(genv.step_fn.launches == n_steps, "golden replay did not use the env kernel")

    # ---- main path: a shipped policy on BatchedEnv, then the physics entry ----
    def policy_path(env_id, phys_args=None):
        task = make_task(env_id)
        policy = policy_from_npz(os.path.join(HERE, "examples", "weights", f"{env_id}.npz"))
        penv = make_batched(env_id, 8)
        ce.reset_launch_counts()
        s = penv.reset(seed=123)
        rews, dones = [], []
        with torch.no_grad():
            for _ in range(task.max_episode_steps):
                s = penv.step(s, policy(s.obs.T))
                rews.append(s.reward)
                dones.append(s.done)
        q = None
        if phys_args is not None:
            phys, q, v, tau = phys_args
            for _ in range(10):
                q, v, _ = phys(q, v, tau)
        torch.cuda.synchronize()
        launches = dict(ce.LAUNCHES)
        rews = torch.stack(rews)
        alive = torch.cumprod(1.0 - torch.stack(dones).float(), 0)
        prev = torch.cat([torch.ones_like(alive[:1]), alive[:-1]], 0)
        returns = (rews * prev).sum(0).cpu().numpy()
        emit("frozen_policy", env=env_id, B=8, seed=123, returns=returns.tolist(),
             mean=float(returns.mean()), floor=POLICY_FLOOR[env_id], launches=launches)
        require(np.isfinite(returns).all() and returns.mean() >= POLICY_FLOOR[env_id],
                f"{env_id} policy return below {POLICY_FLOOR[env_id]}")
        require(launches["env_step_kernel"] == task.max_episode_steps, f"launches: {launches}")
        if phys_args is not None:
            require(launches["physics_step_kernel"] == 10, f"launches: {launches}")
            require(torch.isfinite(q).all().item() and tuple(q.shape) == (task.model.nq, B),
                    "physics rollout")
        return launches

    # ---- main path: the PPO trainer on Ant, B=4096 ---------------------------
    def trainer():
        cfg = ppo.PPOConfig(normalize_obs=True)
        path = os.path.join(HERE, "examples", "weights", f"{ANT}.trainstate.npz")
        n_iter = 3
        stamps, losses = [], []

        def progress(it, metrics):  # float() of the metrics has synchronised
            stamps.append(time.perf_counter())
            losses.append(metrics["loss"])

        torch.cuda.synchronize()
        ce.reset_launch_counts()
        t0 = time.perf_counter()
        ts, es, metrics = ppo.train(ANT, B, n_iter, cfg, seed=0, progress=progress,
                                    resume_from=path)
        torch.cuda.synchronize()
        launches = dict(ce.LAUNCHES)
        step_ms = np.diff([t0] + stamps) * 1e3
        steady_ms = float(step_ms[1:].mean())
        rec = dict(env=ANT, B=B, rollout_length=cfg.rollout_length, epochs=cfg.num_epochs,
                   minibatches=cfg.num_minibatches, hidden=list(cfg.hidden), train_steps=n_iter,
                   losses=losses, opt_count=int(ts.opt_count), launches=launches,
                   ms_per_train_step=step_ms.tolist(), steady_ms_per_train_step=steady_ms,
                   train_env_steps_per_s=B * cfg.rollout_length * 1e3 / steady_ms, card=card,
                   reward_mean=float(metrics["reward_mean"]))
        emit("ppo_train", **rec)
        require(all(np.isfinite(losses)), "non-finite PPO loss")
        require(int(ts.opt_count) == 22080 + 16 * n_iter, "opt_count did not move by 16 a step")
        require(launches["env_step_kernel"] == n_iter * cfg.rollout_length,
                f"trainer launches: {launches}")
        require(es.q.is_cuda and torch.isfinite(es.q).all().item(), "trainer env state")

        # where one more train step's time goes, by kernel (torch.profiler)
        step = ppo.make_train_step(make_task(ANT), cfg)
        wall_ms, dev_us = profile_ms(lambda: step(ts, es))
        busy_ms = sum(dev_us.values()) / 1e3
        top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:8]
        emit("ppo_profile", env=ANT, B=B, wall_ms=wall_ms, device_busy_ms=busy_ms,
             device_busy_share=busy_ms / wall_ms, card=card,
             env_kernel_ms=sum(us for k, us in dev_us.items() if "env_step_kernel" in k) / 1e3,
             top=[(k[:80], us / 1e3) for k, us in top])
        return launches

    # ---- main path: the SAC learner on HopperMuJoCo, B=4096 -------------------
    def profile_ms(fn):
        """Wall ms of fn() and the device time it gave each kernel
        (torch.profiler): (wall ms, {kernel name: device us})."""
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        dev_us = {}
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", None)
            us = e.self_cuda_time_total if us is None else us
            if us > 0:
                dev_us[e.key] = us
        return wall_ms, dev_us

    def sac_learner():
        """SACConfig defaults, resumed from the shipped learner with an empty
        ring: the collect-only iterations (the ring below warmup_steps after
        their collect), then 3 iterations that learn, timed; then one more
        under torch.profiler."""
        from pybulletgym_tpu_torch.parallel import sac
        from pybulletgym_tpu_torch.utils.interop import sac_state_from_npz

        cfg = sac.SACConfig()
        path = os.path.join(HERE, "examples", "weights", f"{MJ_HOPPER}.saclearner.npz")
        senv = make_batched(MJ_HOPPER, B)
        ss = sac_state_from_npz(path, B, cfg)
        count0 = int(ss.opt_critic[2])
        iterate = sac.make_sac_iteration(senv.task, cfg, step_fn=senv.step_fn)
        n_warm = -(-cfg.warmup_steps // cfg.steps_per_iter) - 1
        torch.cuda.synchronize()
        ce.reset_launch_counts()
        es = senv.reset(seed=0)
        stamps, counts, metrics = [time.perf_counter()], [0], []
        for _ in range(n_warm + 3):
            ss, es, m = iterate(ss, es)
            metrics.append({k: float(x) for k, x in m.items()})  # synchronises
            stamps.append(time.perf_counter())
            counts.append(ce.LAUNCHES["env_step_kernel"])
        launches = dict(ce.LAUNCHES)
        ms = np.diff(stamps) * 1e3
        learn_ms = ms[n_warm:].tolist()
        steady = float(np.mean(learn_ms[1:]))
        wall_ms, dev_us = profile_ms(lambda: iterate(ss, es))
        busy_ms = sum(dev_us.values()) / 1e3
        env_us = sum(us for k, us in dev_us.items() if "env_step_kernel" in k)
        rec = dict(env=MJ_HOPPER, B=B, config=dataclasses.asdict(cfg), warmup_iterations=n_warm,
                   learning_iterations=3, launches=launches, launch_counts=counts,
                   ms_per_iteration=ms.tolist(), learning_ms_per_iteration=learn_ms,
                   steady_ms_per_iteration=steady,
                   trained_env_steps_per_s=B * cfg.steps_per_iter * 1e3 / steady,
                   opt_count=int(ss.opt_critic[2]), metrics=metrics[n_warm:], card=card)
        emit("sac_train", **rec)
        emit("sac_profile", env=MJ_HOPPER, B=B, wall_ms=wall_ms, device_busy_ms=busy_ms,
             device_busy_share=busy_ms / wall_ms, env_kernel_ms=env_us / 1e3,
             env_kernel_share_of_device=env_us / 1e3 / busy_ms, card=card,
             top=[(k[:80], us / 1e3) for k, us in sorted(dev_us.items(), key=lambda kv: -kv[1])[:8]])
        require(all(np.diff(counts) == cfg.steps_per_iter),
                f"env_step_kernel launches did not rise by {cfg.steps_per_iter} an iteration: {counts}")
        require(launches["env_step_kernel"] == (n_warm + 3) * cfg.steps_per_iter, f"{launches}")
        require(int(ss.opt_critic[2]) == int(ss.opt_actor[2]) == count0 + 3 * cfg.updates_per_iter,
                "the learner did not take updates_per_iter updates a learning iteration")
        require(ss.buf_ptr == (n_warm + 3) * cfg.steps_per_iter and es.q.is_cuda, "SAC ring")
        for m in metrics:
            require(all(np.isfinite(list(m.values()))), f"non-finite SAC metrics {m}")
        require(all(m["critic_loss"] > 0.0 for m in metrics[n_warm:]), "no SAC update ran")
        return launches

    def sac_vs_cpu():
        """One learning iteration on 64 envs from the shipped learner, on the
        card (the env kernel) and on the CPU (the plain env step), fed the
        same draws: losses and alpha rtol 1e-3, the actor's weights atol 1e-4
        (the env kernel and the plain version round apart)."""
        from pybulletgym_tpu_torch.parallel import sac
        from pybulletgym_tpu_torch.utils.interop import sac_state_from_npz

        Bs = 64
        cfg = sac.SACConfig(steps_per_iter=2, updates_per_iter=2, batch_size=128, warmup_steps=0)
        path = os.path.join(HERE, "examples", "weights", f"{MJ_HOPPER}.saclearner.npz")
        rng = np.random.default_rng(9)
        act = make_task(MJ_HOPPER).act_dim
        draws = {"pi_eps": rng.normal(size=(2, Bs, act)), "a_rand": rng.uniform(-1, 1, (2, Bs, act)),
                 "slots": rng.integers(0, 2, (2, 128)), "envs": rng.integers(0, Bs, (2, 128)),
                 "next_eps": rng.normal(size=(2, 128, act)),
                 "pi_eps_upd": rng.normal(size=(2, 128, act))}
        out = {}
        for device in ("cuda", "cpu"):
            senv = make_batched(MJ_HOPPER, Bs, device=device)
            ss = sac_state_from_npz(path, Bs, cfg, device=device)
            d = {k: torch.as_tensor(x, dtype=torch.int64 if k in ("slots", "envs") else torch.float32,
                                    device=device) for k, x in draws.items()}
            iterate = sac.make_sac_iteration(senv.task, cfg, step_fn=senv.step_fn)
            ss, es, m = iterate(ss, senv.reset(seed=3), draws=d)
            out[device] = (ss, {k: float(x) for k, x in m.items()})
            if device == "cuda":
                require(senv.step_fn.launches == cfg.steps_per_iter, "SAC on 64 envs: launches")
        (sk, mk), (sp, mp) = out["cuda"], out["cpu"]
        dw = max((a.cpu() - b).abs().max().item()
                 for a, b in zip(sk.actor.leaves(), sp.actor.leaves()))
        rel = {k: abs(mk[k] - mp[k]) / max(abs(mp[k]), 1e-12) for k in mk}
        emit("sac_vs_cpu", env=MJ_HOPPER, B=Bs, metrics_card=mk, metrics_cpu=mp, rel_diff=rel,
             max_actor_dw=dw)
        require(all(r < 1e-3 for r in rel.values()) and dw < 1e-4,
                "the SAC iteration on the card differs from the CPU's")

    # ---- env-steps/s of BatchedEnv.step -------------------------------------
    def throughput(env_id, Bt, steps=200):
        task = make_task(env_id)
        tenv = make_batched(env_id, Bt)
        st = tenv.reset(seed=1)
        at = torch.rand((Bt, task.act_dim), device=dev) * 2 - 1
        st = tenv.step(st, at)  # warm-up
        box = [st]

        def one():
            box[0] = tenv.step(box[0], at)

        ms = host_ms(one, steps)
        emit("throughput", env=env_id, route="cuda", B=Bt, steps=steps, ms_per_step=ms,
             env_steps_per_s=Bt * 1e3 / ms, card=card)
        return task, tenv, st, at

    # ---- times and bounds, per model at B=4096 --------------------------------
    def times(env_id, p):
        """The kernels' times (CUDA events) beside their bound. The plain
        versions' times come from the parity phase where it timed them (the
        humanoid and fixed-base families: one call each), else from two
        calls here."""
        task, tenv, st, at = throughput(env_id, B)
        a_t = at.T.contiguous()
        phys, s0, tau = p["phys"], p["s0"], p["tau"]
        pms = p.get("plain_ms") or {
            "env_step_kernel": host_ms(lambda: env_step_plain(task, st, a_t), 2),
            "physics_step_kernel": host_ms(lambda: phys.plain(s0.q, s0.v, tau), 2)}
        n_plain = 1 if "plain_ms" in p else 2
        emit("throughput", env=env_id, route="plain", B=B, steps=n_plain,
             ms_per_step=pms["env_step_kernel"],
             env_steps_per_s=B * 1e3 / pms["env_step_kernel"], card=card)
        out = {}
        tables = {"env_step_kernel": ce.pack_tables(task),
                  "physics_step_kernel": ce.pack_physics(task.model, task.physics)}
        fns = {"env_step_kernel": lambda: tenv.step_fn(st, a_t),
               "physics_step_kernel": lambda: phys(s0.q, s0.v, tau)}
        kms = {name: graph_ms(fn) for name, fn in fns.items()}
        eager = {name: cuda_ms(fn, 50) for name, fn in fns.items()}
        for name in kms:
            flops, nbytes = ce.work_per_env_step(tables[name], env_step=name == "env_step_kernel")
            t_ops = flops * B / PEAK_FP32_FLOPS * 1e3
            t_bytes = (nbytes * B + ctypes.sizeof(tables[name])) / PEAK_BYTES_PER_S * 1e3
            out[name] = dict(ms=kms[name], eager_ms=eager[name], plain_ms=pms[name],
                             bound_ms=max(t_ops, t_bytes),
                             bound_by="operations" if t_ops >= t_bytes else "bytes",
                             flops_per_env_step=flops, bytes_per_env_step=nbytes,
                             launch=ce.launch_config(tables[name], name, B))
            emit("kernel_time", env=env_id, kernel=name, B=B, card=card, **out[name])
        return out

    # ---- main path: data parallelism over the env axis (parallel.mesh) --------
    def share_off(got, ref, step_bound):
        """The share of a leaf off by more than rtol/atol 1e-5, and whether
        every entry lies within `step_bound` (Adam's steps) of the reference."""
        off = ~np.isclose(got, ref, rtol=1e-5, atol=1e-5)
        return float(off.mean()), bool(np.abs(got.astype(np.float64) - ref).max() < step_bound)

    def mesh_phases():
        """mesh_env, mesh_ppo, mesh_sac (one world of D ranks, `mesh_rank`),
        each against the unsharded port run here; then dryrun_multichip.
        D is the number of cards when there are two or more (NCCL, a card a
        rank), else 2 ranks sharing the one card over gloo."""
        from pybulletgym_tpu_torch import entry
        from pybulletgym_tpu_torch.parallel import mesh as pmesh
        from pybulletgym_tpu_torch.parallel import sac
        from pybulletgym_tpu_torch.utils.interop import (
            env_state_to_numpy, sac_state_from_npz, train_state_from_npz,
        )

        n_cards = torch.cuda.device_count()
        D, backend = (n_cards, "nccl") if n_cards >= 2 else (2, "gloo")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = pmesh.launch(mesh_rank, D, device="cuda", backend=backend)
        common = dict(backend=backend, D=D, devices=[r["device"] for r in ranks], card=card)
        emit("mesh_world", seconds=time.perf_counter() - t0, envs=[r["envs"] for r in ranks],
             **common)
        require(all(r["backend"] == backend for r in ranks), "a rank runs another backend")
        mesh_launches = {"env_step_kernel": {}, "physics_step_kernel": {}, "task_step_kernel": {}}

        def record(path, counts):
            """Each rank's launches of each kernel on `path` (its counts, read
            just after the path); the physics and task kernels must not run
            there (the dry run reports no task-kernel count). Returns the
            env-step kernel's."""
            for name in mesh_launches:
                mesh_launches[name][path] = [c.get(name, 0) for c in counts]
            require(mesh_launches["physics_step_kernel"][path] == [0] * D,
                    f"{path}: physics_step_kernel launched {mesh_launches['physics_step_kernel']}")
            require([c.get("task_step_kernel", 0) for c in counts] == [0] * D,
                    f"{path}: task_step_kernel launched {counts}")
            return mesh_launches["env_step_kernel"][path]

        # mesh_env: the gathered sharded state, bitwise the unsharded BatchedEnv.step's
        for env_id in (CHEETAH, ANT):
            task = make_task(env_id)
            uenv = make_batched(env_id, B)
            acts, forced = mesh_actions(task.act_dim)
            a, f = torch.as_tensor(acts, device=dev), torch.as_tensor(forced, device=dev)
            uenv.step(uenv.reset(seed=1), a[0])  # warm-up, as in the ranks
            s = uenv.reset(seed=0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for t in range(MESH_STEPS):
                if t in MESH_FORCED_AT:
                    s = s._replace(terminated=s.terminated | f)
                s = uenv.step(s, a[t])
            torch.cuda.synchronize()
            ms_u = (time.perf_counter() - t0) * 1e3 / MESH_STEPS
            ref, got = env_state_to_numpy(s), ranks[0][env_id]["state"]
            same = all(np.array_equal(got[k][n], ref[k][n]) for k in ref if isinstance(ref[k], dict)
                       for n in ref[k]) and all(
                got[k].dtype == ref[k].dtype and np.array_equal(got[k], ref[k])
                for k in ref if not isinstance(ref[k], dict))
            ms = [r[env_id]["ms_per_step"] for r in ranks]
            launches = record(f"mesh_env:{env_id}", [r[env_id]["launches"] for r in ranks])
            off = ranks[-1][env_id]["offset_check"]
            emit("mesh_env", env=env_id, B=B, steps=MESH_STEPS, forced_reset_at=MESH_FORCED_AT,
                 bitwise=same, sharded_ms_per_step=ms,
                 sharded_env_steps_per_s=B * 1e3 / max(ms), unsharded_ms_per_step=ms_u,
                 unsharded_env_steps_per_s=B * 1e3 / ms_u, launches_per_rank=launches,
                 offset_shard_vs_plain=off, **common)
            require(same, f"{env_id}: the gathered sharded state differs from the unsharded one")
            require(launches == [MESH_STEPS] * D, f"mesh_env launches {launches}")
            require(off["reset_q_bitwise"] and off["reset_v_bitwise"] and off["counters_bitwise"],
                    f"the offset shard's reset differs from the plain version: {off}")
            require(off["mean_dq"] < 3e-4 and off["max_dq"] < 1e-2,
                    f"the offset shard's step differs from the plain version: {off}")
            require((got["env_id"] == np.arange(B)).all(), "gathered env_ids")

        # mesh_ppo: one sharded train step against one unsharded one, same TrainState
        cfg = ppo.PPOConfig(normalize_obs=True)
        path = os.path.join(HERE, "examples", "weights", f"{ANT}.trainstate.npz")
        ts0, _ = train_state_from_npz(path, device=dev, seed=0)
        uenv = make_batched(ANT, B)
        es0 = uenv.reset(seed=0)
        obs0 = ts0.obs_stats.normalize(es0.obs.T)
        b = B // D
        products_bitwise = {}
        with torch.no_grad():  # a shard's rows alone, and at the global shape (the path's)
            for name, fn in (("policy_mean", ts0.params.policy_mean),
                             ("value", ts0.params.value_apply)):
                whole = fn(obs0)
                for r in (0, D - 1):
                    rows = obs0[r * b:(r + 1) * b]
                    m_r = pmesh.Mesh(D, r, ("env",), (D,), dev)
                    products_bitwise[f"{name}, rank {r}, shard rows"] = bool(
                        torch.equal(fn(rows), whole[r * b:(r + 1) * b]))
                    products_bitwise[f"{name}, rank {r}, global shape"] = bool(torch.equal(
                        fn(pmesh.global_rows(rows, m_r))[r * b:(r + 1) * b],
                        whole[r * b:(r + 1) * b]))
        ustep = ppo.make_train_step(uenv.task, cfg, step_fn=uenv.step_fn)
        ts, es, m = ustep(ts0, es0)
        um = {k: float(x) for k, x in m.items()}
        ref, r0 = ppo_leaves(ts), ranks[0]["ppo"]
        state = env_state_to_numpy(es)
        dobs = float(np.abs(r0["state"]["obs"] - state["obs"]).max())
        dq = float(np.abs(r0["state"]["q"] - state["q"]).max())
        n_upd = cfg.num_epochs * cfg.num_minibatches
        leaves_off = [share_off(g, x, cfg.learning_rate * n_upd)
                      for g, x in zip(r0["leaves"][:-4], ref[:-4])]
        stats_err = max(float(np.abs(g - x).max()) for g, x in zip(r0["leaves"][-3:], ref[-3:]))
        replicated_ok = all(np.array_equal(x, y) for r in ranks[1:]
                            for x, y in zip(r["ppo"]["leaves"], r0["leaves"]))
        ums = []
        for _ in range(3):
            ums.append(timed(lambda: float(ustep(ts, es)[2]["loss"]))[1])
        launches = record("mesh_ppo", [r["ppo"]["launches"] for r in ranks])
        sms = [max(r["ppo"]["ms_per_train_step"][i] for r in ranks) for i in range(3)]
        emit("mesh_ppo", env=ANT, B=B, config="PPOConfig defaults + normalize_obs",
             metrics_sharded=r0["metrics"], metrics_unsharded=um,
             final_state_max_dobs=dobs, final_state_max_dq=dq,
             final_state_bitwise=dobs == 0.0 and dq == 0.0, products_bitwise=products_bitwise,
             leaf_share_off=[x[0] for x in leaves_off], obs_stats_max_err=stats_err,
             params_bitwise_across_ranks=replicated_ok, sharded_ms_per_train_step=sms,
             sharded_train_env_steps_per_s=B * cfg.rollout_length * 1e3 / np.mean(sms),
             unsharded_ms_per_train_step=ums,
             unsharded_train_env_steps_per_s=B * cfg.rollout_length * 1e3 / np.mean(ums),
             launches_per_rank=launches, **common)
        require(dobs < 1e-4, f"mesh_ppo: the rollout's final obs differ by {dobs}")
        require(stats_err < 1e-5, f"mesh_ppo: obs stats differ by {stats_err}")
        require(all(s <= 0.02 and within for s, within in leaves_off),
                f"mesh_ppo: params or moments off: {leaves_off}")
        require(replicated_ok, "mesh_ppo: the ranks' parameters differ")
        require(int(r0["leaves"][-4]) == 22080 + n_upd, "mesh_ppo: Adam count")
        require(launches == [4 * cfg.rollout_length] * D, f"mesh_ppo launches {launches}")

        # mesh_sac: the warm-up and two learning iterations against the unsharded ones
        scfg = sac.SACConfig()
        path = os.path.join(HERE, "examples", "weights", f"{MJ_HOPPER}.saclearner.npz")
        uenv = make_batched(MJ_HOPPER, B)
        ss = sac_state_from_npz(path, B, scfg)
        it = sac.make_sac_iteration(uenv.task, scfg, step_fn=uenv.step_fn)
        es = uenv.reset(seed=0)
        for _ in range(SAC_WARM + SAC_LEARN):
            ss, es, m = it(ss, es)
        um = {k: float(x) for k, x in m.items()}
        ref, r0 = sac_leaves(ss), ranks[0]["sac"]
        n_actor = len(ss.actor.leaves())
        checks = []
        for k, (g, x) in enumerate(zip(r0["leaves"], ref)):
            if x.dtype == np.int32:
                checks.append((0.0, int(g) == int(x)))
            else:
                checks.append(share_off(  # one Adam step an update
                    g, x, scfg.learning_rate * scfg.updates_per_iter * SAC_LEARN))
        rel = {k: abs(r0["metrics"][k] - um[k]) / max(abs(um[k]), 1e-12) for k in um}
        bitwise = all(np.array_equal(g, x) for g, x in zip(r0["leaves"], ref))
        replicated_ok = all(np.array_equal(x, y) for r in ranks[1:]
                            for x, y in zip(r["sac"]["leaves"], r0["leaves"]))
        ums = []
        for _ in range(3):
            ums.append(timed(lambda: float(it(ss, es)[2]["critic_loss"]))[1])
        launches = record("mesh_sac", [r["sac"]["launches"] for r in ranks])
        sms = [max(r["sac"]["ms_per_iteration"][i] for r in ranks) for i in range(3)]
        emit("mesh_sac", env=MJ_HOPPER, B=B, config=dataclasses.asdict(scfg),
             warmup_iterations=SAC_WARM, learning_iterations=SAC_LEARN,
             metrics_sharded=r0["metrics"], metrics_unsharded=um,
             metrics_rel_diff=rel, learner_bitwise_to_unsharded=bitwise,
             leaf_share_off=[c[0] for c in checks], params_bitwise_across_ranks=replicated_ok,
             ring_envs_per_rank=[r["sac"]["ring_envs"] for r in ranks],
             sharded_ms_per_iteration=sms,
             sharded_trained_env_steps_per_s=B * scfg.steps_per_iter * 1e3 / np.mean(sms),
             unsharded_ms_per_iteration=ums,
             unsharded_trained_env_steps_per_s=B * scfg.steps_per_iter * 1e3 / np.mean(ums),
             launches_per_rank=launches, actor_leaves=n_actor, **common)
        require(all(r < 1e-4 for r in rel.values()), f"mesh_sac metrics differ: {rel}")
        require(all(s <= 0.02 and within for s, within in checks),
                f"mesh_sac: learner leaves off: {checks}")
        require(replicated_ok, "mesh_sac: the ranks' learners differ")
        require(all(r["sac"]["ring_envs"] == B // D for r in ranks), "mesh_sac: ring not sharded")
        require(launches == [(SAC_WARM + SAC_LEARN + 3) * scfg.steps_per_iter] * D,
                f"mesh_sac launches {launches}")

        # mesh_task: a user's task by ID, the gathered state bitwise the unsharded one's
        import torch_user_tasks as ut

        uenv = make_batched(ut.SHAPED_ANT_ID, B)
        acts, forced = mesh_actions(uenv.task.act_dim)
        a, f = torch.as_tensor(acts, device=dev), torch.as_tensor(forced, device=dev)
        uenv.step(uenv.reset(seed=1), a[0])
        s = uenv.reset(seed=0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(MESH_TASK_STEPS):
            if t in MESH_FORCED_AT:
                s = s._replace(terminated=s.terminated | f)
            s = uenv.step(s, a[t])
        torch.cuda.synchronize()
        ms_u = (time.perf_counter() - t0) * 1e3 / MESH_TASK_STEPS
        ref, got = env_state_to_numpy(s), ranks[0]["mesh_task"]["state"]
        same = all(np.array_equal(got[k][n], ref[k][n]) for k in ref if isinstance(ref[k], dict)
                   for n in ref[k]) and all(
            got[k].dtype == ref[k].dtype and np.array_equal(got[k], ref[k])
            for k in ref if not isinstance(ref[k], dict))
        counts = [r["mesh_task"]["launches"] for r in ranks]
        for name in mesh_launches:
            mesh_launches[name]["mesh_task"] = [c.get(name, 0) for c in counts]
        ms = [r["mesh_task"]["ms_per_step"] for r in ranks]
        emit("mesh_task", env=ut.SHAPED_ANT_ID, B=B, steps=MESH_TASK_STEPS,
             forced_reset_at=[t for t in MESH_FORCED_AT if t < MESH_TASK_STEPS], bitwise=same,
             kernels=[r["mesh_task"]["kernel"] for r in ranks],
             task_step_kernel_launches_per_rank=mesh_launches["task_step_kernel"]["mesh_task"],
             sharded_ms_per_step=ms, sharded_env_steps_per_s=B * 1e3 / max(ms),
             unsharded_ms_per_step=ms_u, unsharded_env_steps_per_s=B * 1e3 / ms_u, **common)
        require(same, "mesh_task: the gathered sharded state differs from the unsharded one")
        require(all(c == dict(dict.fromkeys(c, 0), task_step_kernel=MESH_TASK_STEPS)
                    for c in counts), f"mesh_task launches {counts}")

        # dryrun_multichip: the port's entry point, over the same D ranks
        rec = entry.dryrun_multichip(D)
        record("dryrun_multichip", [
            {"env_step_kernel": e, "physics_step_kernel": p}
            for e, p in zip(rec["env_step_launches"], rec["physics_step_launches"])])
        emit("dryrun_multichip", **{**rec, **common, "devices": rec["devices"]})
        require(rec["backend"] == backend and rec["env_step_launches"] == [4] * D,
                f"dryrun_multichip: {rec}")
        return mesh_launches

    # HalfCheetah: the phases of the first slice, and its main path
    pc = parity(CHEETAH)
    ragged(CHEETAH)
    golden(CHEETAH)
    main_c = policy_path(CHEETAH, (pc["phys"], pc["s0"].q, pc["s0"].v, pc["tau"]))
    require(main_c["physics_step_kernel"] > 0 and main_c["env_step_kernel"] > 0
            and main_c["task_step_kernel"] == 0, f"the policy path's launches: {main_c}")
    throughput(CHEETAH, 16384)  # B=4096 is timed below, with the kernel times

    # Ant: both kernels, its golden, its policy path, the trainer
    pa = parity(ANT)
    golden(ANT)
    main_a = policy_path(ANT, (pa["phys"], pa["s0"].q, pa["s0"].v, pa["tau"]))
    main_t = trainer()
    # Hopper and Walker2D: the "hopper" alive mode, held by goldens and policies
    for env_id in (HOPPER, WALKER):
        golden(env_id)
        policy_path(env_id)

    # the humanoid family: both kernels, the cube, goldens, the three policies
    ph = parity_humanoid(HUMANOID)
    ragged(HUMANOID, ph)
    golden(HUMANOID, tpu=True)
    main_h = policy_path(HUMANOID, (ph["phys"], ph["s0"].q, ph["s0"].v, ph["tau"]))
    pf = parity_humanoid(HARDER)
    cube(pf)
    golden(HARDER, tpu=True)
    main_f = policy_path(HARDER, (pf["phys"], pf["s0"].q, pf["s0"].v, pf["tau"]))
    golden(FLAGRUN, tpu=True)
    policy_path(FLAGRUN)

    # the fixed-base family: both kernels, the disk rows' regular branch,
    # goldens, the ten policies
    fixed = {env_id: parity_fixed(env_id) for env_id in FIXED}
    disk_err = disk_regular()
    for env_id in (REACHER, PENDULUM, SWINGUP, DOUBLE):
        golden(env_id)
    for env_id in (PUSHER, STRIKER, THROWER) + MIRRORS:
        golden(env_id, tpu=True)
    main_fixed = {}
    for env_id in FIXED + (SWINGUP,) + MIRRORS:
        p = fixed.get(env_id)
        main_fixed[env_id] = policy_path(
            env_id, None if p is None else (p["phys"], p["s0"].q, p["s0"].v, p["tau"]))

    # the Gym-MuJoCo mirrors: both kernels, HumanoidMuJoCo's ragged batches,
    # goldens (HumanoidMuJoCo's recorded on a TPU only), the eight policies,
    # and the SAC learner on HopperMuJoCo
    mj = {env_id: parity_fixed(env_id) for env_id in MJ}
    ragged(MJ_HUMANOID)
    for env_id in MJ:
        golden(env_id, tpu=env_id == MJ_HUMANOID)
    main_mj = {env_id: policy_path(env_id, (p["phys"], p["s0"].q, p["s0"].v, p["tau"]))
               for env_id, p in mj.items()}
    sac_vs_cpu()
    main_s = sac_learner()

    # Atlas: its launch configuration (M factored over root paths, Y's rows
    # over them), both kernels at the walkers' budget (no pair rows), its
    # ragged batches, its TPU golden, its policy
    at_tables = ce.pack_tables(make_task(ATLAS))
    at_layout = ce.scratch_layout(at_tables)
    emit("atlas_launch", B=B, scratch_bytes_per_env=4 * at_tables.sc_stride,
         L_floats=at_layout["L"][1], Y_floats=at_layout["Y"][1], card=card, **configs[ATLAS])
    pat = parity_humanoid(ATLAS)
    ragged(ATLAS, pat)
    golden(ATLAS, tpu=True)
    main_at = policy_path(ATLAS, (pat["phys"], pat["s0"].q, pat["s0"].v, pat["tau"]))

    # ---- main path: the gymnasium API (make, make_vec), EpisodeStats,
    # checkpoints and rendering, each through the env-step kernel -------------
    def leaves(st):  # an EnvState's tensors, its dicts by sorted key
        return [x for f in st for x in ([f[k] for k in sorted(f)] if isinstance(f, dict) else [f])]

    def gym_adapter_path():
        """`pt.make(HalfCheetah)` on the card: its spaces, one episode of the
        shipped policy (on the CPU, as a gym user would run it) through
        reset and step until truncation, and the epoch rule of a reset
        without a seed."""
        from pybulletgym_tpu_torch.api import gym_adapter as ga

        task = make_task(CHEETAH)
        policy = policy_from_npz(os.path.join(HERE, "examples", "weights", f"{CHEETAH}.npz"),
                                 device="cpu")
        torch.cuda.synchronize()
        ce.reset_launch_counts()
        env = pt.make(CHEETAH)
        act_sp, obs_sp = env.action_space, env.observation_space
        require(tuple(act_sp.shape) == (task.act_dim,) and (act_sp.low == -1).all()
                and (act_sp.high == 1).all() and act_sp.dtype == np.float32, "action space")
        require(tuple(obs_sp.shape) == (task.obs_dim,) and np.isinf(obs_sp.high).all()
                and obs_sp.dtype == np.float32, "observation space")
        obs, _ = env.reset(seed=123)
        ret, n, term, trunc = 0.0, 0, False, False
        t0 = time.perf_counter()
        with torch.no_grad():
            while not (term or trunc):
                a = policy(torch.from_numpy(obs)[None])[0].numpy()
                obs, r, term, trunc, info = env.step(a)
                ret += r
                n += 1
        episode_s = time.perf_counter() - t0
        launches = dict(ce.LAUNCHES)
        a0 = np.zeros(task.act_dim, np.float32)
        step_ms = host_ms(lambda: env.step(a0), 200)
        env.reset()  # no seed: epoch 1 of seed 123
        want = make_batched(CHEETAH, 1).reset(seed=123, epoch=1)
        same = all(torch.equal(x, y) for x, y in zip(leaves(env._state), leaves(want)))
        emit("gym_adapter", env=CHEETAH, B=1, device=str(env._env.device),
             gymnasium=None if ga.gymnasium is None else ga.gymnasium.__version__,
             action_shape=list(act_sp.shape), observation_shape=list(obs_sp.shape), episode_steps=n,
             episode_return=ret, floor=POLICY_FLOOR[CHEETAH], terminated=term, truncated=trunc,
             episode_steps_per_s=n / episode_s, step_ms=step_ms, steps_per_s=1e3 / step_ms,
             info_keys=sorted(info), launches=launches, reset_epoch1_bitwise=same, card=card)
        require(np.isfinite(ret) and ret >= POLICY_FLOOR[CHEETAH],
                f"adapter episode return {ret} below {POLICY_FLOOR[CHEETAH]}")
        require(trunc and n == task.max_episode_steps, f"the episode ended at step {n}")
        require(launches["env_step_kernel"] == n, f"adapter launches: {launches}")
        require(same, "reset() without a seed is not epoch 1's state")
        return launches

    def vector_adapter_path(steps=200, warm=10):
        """`pt.make_vec(HalfCheetah, 4096)` against `BatchedEnv.step` on the
        same seeded actions: every step's obs, rewards, flags and reward
        components bitwise; env-steps/s of each."""
        task = make_task(CHEETAH)
        rng = np.random.default_rng(5)
        acts = rng.uniform(-1, 1, (warm + steps, B, task.act_dim)).astype(np.float32)
        acts_dev = torch.from_numpy(acts).to(dev)
        torch.cuda.synchronize()
        ce.reset_launch_counts()
        vec = pt.make_vec(CHEETAH, B)
        obs0, _ = vec.reset(seed=2)
        outs = []
        for a in acts[:warm]:
            outs.append(vec.step(a))
        t0 = time.perf_counter()
        for a in acts[warm:]:
            outs.append(vec.step(a))
        vec_ms = (time.perf_counter() - t0) * 1e3 / steps
        launches = dict(ce.LAUNCHES)
        benv = make_batched(CHEETAH, B)
        st = benv.reset(seed=2)
        states = []
        for t in range(warm):
            st = benv.step(st, acts_dev[t])
            states.append(st)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(warm, warm + steps):
            st = benv.step(st, acts_dev[t])
            states.append(st)
        torch.cuda.synchronize()
        env_ms = (time.perf_counter() - t0) * 1e3 / steps
        # where an adapter step's time goes: 20 steps under torch.profiler
        wall_ms, dev_us = profile_ms(lambda: [vec.step(a) for a in acts[:20]])
        busy_ms = sum(dev_us.values()) / 1e3
        same = bool((obs0 == benv.reset(seed=2).obs.T.cpu().numpy()).all())
        for (obs, r, term, trunc, info), s in zip(outs, states):
            same &= bool((obs == s.obs.T.cpu().numpy()).all() and (r == s.reward.cpu().numpy()).all()
                         and (term == s.terminated.cpu().numpy()).all()
                         and (trunc == s.truncated.cpu().numpy()).all()
                         and sorted(info) == sorted(s.rewards)
                         and all((info[k] == s.rewards[k].cpu().numpy()).all() for k in info))
        emit("vector_adapter", env=CHEETAH, B=B, steps=steps, warmup=warm, bitwise=same,
             ms_per_step=vec_ms, env_steps_per_s=B * 1e3 / vec_ms,
             batched_env_ms_per_step=env_ms, batched_env_steps_per_s=B * 1e3 / env_ms,
             host_bytes_in=acts[0].nbytes, host_bytes_out=sum(
                 x.nbytes for x in outs[0][:4]) + sum(x.nbytes for x in outs[0][4].values()),
             launches=launches, profiled_ms_per_step=wall_ms / 20,
             device_busy_share=busy_ms / wall_ms,
             device_ms_per_step=[(k[:60], us / 1e3 / 20) for k, us in
                                 sorted(dev_us.items(), key=lambda kv: -kv[1])[:6]], card=card)
        require(same, "VectorAdapter differs from BatchedEnv.step")
        require(launches["env_step_kernel"] == warm + steps, f"vector launches: {launches}")
        return launches

    def episode_stats_path(steps=1000):
        """`EpisodeStats` folded through 1000 steps of HalfCheetah at B=4096
        (random actions): every env truncates at step 1000; the sums held to
        a float64 numpy fold of the same rewards and dones (rtol 1e-5)."""
        from pybulletgym_tpu_torch.utils.metrics import EpisodeStats

        task = make_task(CHEETAH)
        gen = torch.Generator(device=dev).manual_seed(8)
        torch.cuda.synchronize()
        ce.reset_launch_counts()
        senv = make_batched(CHEETAH, B)
        s = senv.reset(seed=4)
        stats = EpisodeStats.init(B)
        rews, dones = [], []
        t0 = time.perf_counter()
        for _ in range(steps):
            a = torch.rand((B, task.act_dim), generator=gen, device=dev) * 2 - 1
            s = senv.step(s, a)
            stats = stats.update(s.reward, s.done)
            rews.append(s.reward)
            dones.append(s.done)
        torch.cuda.synchronize()
        loop_ms = (time.perf_counter() - t0) * 1e3 / steps
        launches = dict(ce.LAUNCHES)
        update_ms = cuda_ms(lambda: stats.update(s.reward, s.done), 100)
        R = torch.stack(rews).cpu().numpy().astype(np.float64)  # one copy each, at the end
        D = torch.stack(dones).cpu().numpy()
        run_r, run_l = np.zeros(B), np.zeros(B)
        sum_r = sum_l = 0.0
        for r, d in zip(R, D):
            run_r, run_l = run_r + r, run_l + 1.0
            sum_r += run_r[d].sum()
            sum_l += run_l[d].sum()
            run_r[d], run_l[d] = 0.0, 0.0
        n_ep = int(stats.n_episodes)
        rel = {"sum_returns": abs(float(stats.sum_returns) - sum_r) / max(abs(sum_r), 1e-12),
               "sum_lengths": abs(float(stats.sum_lengths) - sum_l) / max(abs(sum_l), 1e-12)}
        emit("episode_stats", env=CHEETAH, B=B, steps=steps, n_episodes=n_ep,
             n_episodes_float64_fold=int(D.sum()), sum_returns=float(stats.sum_returns),
             sum_returns_float64=sum_r, sum_lengths=float(stats.sum_lengths),
             sum_lengths_float64=sum_l, rel_diff=rel, mean_return=float(stats.mean_return()),
             mean_length=float(stats.mean_length()), update_ms=update_ms,
             ms_per_step_with_update=loop_ms, launches=launches, card=card)
        require(n_ep == int(D.sum()) and n_ep >= B, f"{n_ep} episodes")
        require(all(x < 1e-5 for x in rel.values()), f"EpisodeStats sums differ: {rel}")
        require(launches["env_step_kernel"] == steps, f"episode-stats launches: {launches}")
        return launches

    def checkpoint_path(tmp):
        """Ant at B=4096 saved after 5 steps, loaded into a fresh reset on the
        card, both stepped 5 more times: bitwise. The PPO TrainState of the
        shipped checkpoint saved and loaded: every leaf and the generator."""
        from pybulletgym_tpu_torch.utils import checkpoint
        from pybulletgym_tpu_torch.utils.interop import train_state_from_npz

        task = make_task(ANT)
        acts = torch.from_numpy(np.random.default_rng(6).uniform(
            -1, 1, (10, B, task.act_dim)).astype(np.float32)).to(dev)
        torch.cuda.synchronize()
        ce.reset_launch_counts()
        cenv = make_batched(ANT, B)
        s = cenv.reset(seed=6)
        for a in acts[:5]:
            s = cenv.step(s, a)
        path = os.path.join(tmp, "ant.npz")
        _, save_ms = timed(lambda: checkpoint.save(path, s))
        template = cenv.reset(seed=0)
        s2, load_ms = timed(lambda: checkpoint.load(path, template))
        require(all(x.is_cuda for x in leaves(s2)), "the loaded state is not on the card")
        same_load = all(torch.equal(x, y) for x, y in zip(leaves(s), leaves(s2)))
        for a in acts[5:]:
            s, s2 = cenv.step(s, a), cenv.step(s2, a)
        same = all(torch.equal(x, y) for x, y in zip(leaves(s), leaves(s2)))
        torch.cuda.synchronize()
        launches = dict(ce.LAUNCHES)
        ts_path = os.path.join(HERE, "examples", "weights", f"{ANT}.trainstate.npz")
        ts, _ = train_state_from_npz(ts_path, seed=0)
        torch.randn(8, generator=ts.generator, device=dev)  # the stream has moved
        tpath = os.path.join(tmp, "ts.npz")
        _, ts_save_ms = timed(lambda: checkpoint.save(tpath, ts))
        like = train_state_from_npz(ts_path, seed=1)[0]
        ts2, ts_load_ms = timed(lambda: checkpoint.load(tpath, like))
        differ = [i for i, (x, y) in enumerate(zip(checkpoint._flatten(ts)[0],
                                                   checkpoint._flatten(ts2)[0]))
                  if not (torch.equal(x.get_state(), y.get_state())
                          and x.device == y.device if isinstance(x, torch.Generator)
                          else torch.equal(x, y) and x.device == y.device)]
        ts_same = not differ and ts2.generator.device.type == "cuda"
        emit("checkpoint", env=ANT, B=B, file_bytes=os.path.getsize(path), save_ms=save_ms,
             load_ms=load_ms, loaded_bitwise=same_load, resumed_bitwise=same,
             train_state_leaves=len(checkpoint._flatten(ts)[0]),
             train_state_file_bytes=os.path.getsize(tpath), train_state_save_ms=ts_save_ms,
             train_state_load_ms=ts_load_ms, train_state_bitwise=ts_same,
             train_state_leaves_differ=differ, launches=launches,
             card=card)
        require(same_load and same, "the Ant checkpoint did not resume bitwise")
        require(ts_same, "the TrainState did not round-trip")
        require(launches["env_step_kernel"] == 15, f"checkpoint launches: {launches}")
        return launches

    def render_path():
        """`render_state_native` of a HalfCheetah state on the card (env 0):
        a frame that is not the empty scene's, equal to the frame of the same
        state moved to the CPU."""
        from pybulletgym_tpu_torch.native import load_render_lib
        from pybulletgym_tpu_torch.utils import render

        task = make_task(CHEETAH)
        renv = make_batched(CHEETAH, 4)
        s = renv.reset(seed=0)
        for _ in range(3):
            s = renv.step(s, torch.zeros((4, task.act_dim), device=dev))
        frame, first_ms = timed(lambda: render.render_state_native(task, s))
        require(frame is not None, "no g++ to build the native renderer")
        host = type(s)(*[{k: x.cpu() for k, x in f.items()} if isinstance(f, dict) else f.cpu()
                         for f in s])
        same = bool((frame == render.render_state_native(task, host)).all())
        fk = render._fk(task, s, 0)
        target = np.array([float(x) for x in fk.p[task.model.body_index("torso")]], np.float32)
        empty = np.empty_like(frame)
        fp = ctypes.POINTER(ctypes.c_float)
        load_render_lib().render_rgb(
            np.zeros((1, 24), np.float32).ctypes.data_as(fp), 0, target.ctypes.data_as(fp),
            ctypes.c_float(3.0), ctypes.c_float(0.0), ctypes.c_float(-30.0),
            empty.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), 320, 240)
        robot = float((frame != empty).any(-1).mean())
        ms = host_ms(lambda: render.render_state_native(task, s), 20)
        emit("render", env=CHEETAH, shape=list(frame.shape), dtype=str(frame.dtype),
             geoms=len(render._geom_rows(task, s, 0)), robot_pixel_share=robot,
             equal_to_cpu_state=same, first_call_ms=first_ms, ms_per_frame=ms, card=card)
        require(frame.shape == (240, 320, 3) and frame.dtype == np.uint8, "frame shape")
        require(robot > 0.001, "the frame shows no robot")
        require(same, "the card state's frame differs from the CPU state's")

    # the gymnasium API, EpisodeStats, checkpoints and rendering
    main_api = {"gym_adapter": gym_adapter_path(), "vector_adapter": vector_adapter_path(),
                "episode_stats": episode_stats_path()}
    with tempfile.TemporaryDirectory() as tmp:
        main_api["checkpoint"] = checkpoint_path(tmp)
    render_path()
    main_examples, _ = examples_paths(card)
    main_user, task_entry = user_task_paths(card)
    main_ops, ops_timing = task_ops_paths(card)
    main_big, big_entries = big_model_paths(card, ph, scene_builds["big"])
    main_huge, huge_entries = huge_model_paths(card, scene_builds["huge"])
    main_sized, sized_entries = sized_model_paths(card, scene_builds["sized"])
    main_mesh = mesh_phases()

    # the local memory that the first launch of each kernel on each model
    # took outside torch's allocator (free memory before and after)
    emit("local_memory", first_launches=lmem_log,
         max_bytes=max(r["local_memory_bytes"] for r in lmem_log), card=card)

    t_c, t_a = times(CHEETAH, pc), times(ANT, pa)
    t_h, t_f = times(HUMANOID, ph), times(HARDER, pf)
    throughput(HARDER, 16384)
    t_fixed = {env_id: times(env_id, p) for env_id, p in fixed.items()}
    throughput(PUSHER, 16384)
    t_mj = {env_id: times(env_id, p) for env_id, p in mj.items()}
    t_at = times(ATLAS, pat)
    launches = {"env_step_kernel": main_t["env_step_kernel"],
                "physics_step_kernel": main_a["physics_step_kernel"]}
    err_key = {"env_step_kernel": "env_err", "physics_step_kernel": "phys_err"}
    runs = {CHEETAH: (pc, t_c, main_c), ANT: (pa, t_a, main_a), HUMANOID: (ph, t_h, main_h),
            HARDER: (pf, t_f, main_f)}
    runs.update({env_id: (p, t_fixed[env_id], main_fixed[env_id]) for env_id, p in fixed.items()})
    runs.update({env_id: (p, t_mj[env_id], main_mj[env_id]) for env_id, p in mj.items()})
    runs[ATLAS] = (pat, t_at, main_at)

    # the default class's PGS sweep by each row's own block: one butterfly a
    # contact row and one a limit row or pair (ops/cuda_engine.py ·
    # sweep_group_sums), beside the per-direction sweep's count, each model's
    # kernel times from this run and its launch
    for env_id, (p, t, _) in runs.items():
        tab = ce.pack_tables(p["task"])
        pairs = sum(ce.limit_pairs(tab))
        sums = ce.sweep_group_sums(tab)
        emit("sweep_blocks", env=env_id, B=B, contact_rows=tab.nr, limit_rows=tab.nl,
             limit_pairs=pairs, group_sums_a_sweep=sums,
             per_direction_group_sums_a_sweep=3 * tab.nr + tab.nl,
             env_ms=t["env_step_kernel"]["ms"], physics_ms=t["physics_step_kernel"]["ms"],
             scratch_bytes_per_env=4 * tab.sc_stride, launch=configs[env_id]["env_step_kernel"],
             card=card)
        require(sums == tab.nr + tab.nl - pairs and 2 * pairs <= tab.nl,
                f"{env_id}: {sums} group sums a sweep")
    errs = {k: max(p[e] for p, _, _ in runs.values()) for k, e in err_key.items()}
    errs["physics_step_kernel"] = max(errs["physics_step_kernel"], disk_err)
    kernels = []
    for name in ("physics_step_kernel", "env_step_kernel"):
        a = t_a[name]
        per_model = {env_id: {**t[name], "max_abs_err": p[err_key[name]], "launches": m[name]}
                     for env_id, (p, t, m) in runs.items()}
        per_model[ANT]["launches"] = launches[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": a["ms"], "plain_ms": a["plain_ms"], "bound_ms": a["bound_ms"],
            "bound_by": a["bound_by"], "library_ms": None, "B": B, "timed_on": ANT,
            "models": [CHEETAH, ANT, HUMANOID, HARDER] + list(FIXED) + list(MJ) + [ATLAS] + (
                [HOPPER, WALKER, FLAGRUN, SWINGUP] + list(MIRRORS)
                if name == "env_step_kernel" else ["HalfCheetah, bthigh a cylinder"]),
            "per_model": per_model, "sac_launches": main_s[name],
            "api_launches": {path: m[name] for path, m in main_api.items()},
            "examples_launches": {run: m[name] for run, m in main_examples.items()},
            "mesh_launches": main_mesh[name],
        })
    kernels[0]["composed_launches"] = {
        path: n["physics_step_kernel"] for path, n in {**main_user, **main_ops}.items()
        if "composed" in path}
    task_entry["per_model"].update({env_id: dict(rec, launches=main_ops[f"task_ops:{env_id}"][
        "task_step_kernel"]) for env_id, rec in ops_timing.items()})
    kernels.append(dict(task_entry, launches=main_user["user_task"]["task_step_kernel"],
                        path_launches={path: n["task_step_kernel"]
                                       for path, n in {**main_user, **main_ops}.items()},
                        mesh_launches=main_mesh["task_step_kernel"],
                        models=task_entry["models"] + list(ops_timing)))
    for tag, main_scene, entries in (("big", main_big, big_entries),
                                     ("huge", main_huge, huge_entries),
                                     ("sized", main_sized, sized_entries)):
        for e in entries:  # the large, huge and sized builds, on their own main paths only
            path = f"{tag}_fused" if e["name"].startswith("task") else f"{tag}_composed"
            kernels.append(dict(e, launches=main_scene[path][e["name"]]))
    emit("elapsed", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
