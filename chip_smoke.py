"""GPU smoke run of the PyTorch + CUDA port (pybulletgym_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA GPU (built for sm_90a: an H100), nvcc, and this checkout. It
builds the kernels from `pybulletgym_tpu_torch/csrc/`, holds each kernel
against its plain PyTorch version on the card, replays the CPU golden
rollout and the shipped SAC policy of HalfCheetahPyBulletEnv-v0 through the
kernel, measures env-steps/s, and drives the main path (BatchedEnv on the GPU
plus the physics entry point) with the launch counters reset around it.

Each phase prints one JSON line; any failure raises (non-zero exit). The
last lines are the kernels' summary, the card's name and power limit as
nvidia-smi reports them, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ENV_ID = "HalfCheetahPyBulletEnv-v0"
SOURCE = "pybulletgym_tpu_torch/csrc/engine.cu"
REPLACES = {
    "physics_step_kernel": "pybulletgym_tpu/ops/pallas_engine.py:48",
    "env_step_kernel": "pybulletgym_tpu/ops/pallas_engine.py:123",
}


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


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


def host_ms(fn, n):
    """Mean wall milliseconds per call, synchronised on both ends."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this run needs a CUDA GPU")
    sys.path.insert(0, HERE)
    from pybulletgym_tpu_torch import make_batched, make_task
    from pybulletgym_tpu_torch.envs.base import env_step_plain
    from pybulletgym_tpu_torch.ops import cuda_engine as ce
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
    _, log = ce.load_cuda_library()
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln or "stack frame" in ln]
    emit("build", seconds=time.perf_counter() - t0, nvcc=ce.nvcc_path(), ptxas=ptxas)

    task = make_task(ENV_ID)
    m = task.model
    gains = torch.as_tensor(task.gains[:, 0], device=dev)
    act_dofs = torch.as_tensor(task.act_dofs.astype(np.int64), device=dev)

    def torques(a):  # (act, B) -> (nv, B), as WalkerTask.action_tau_scalar
        tau = torch.zeros((m.nv, a.shape[1]), device=dev)
        tau[act_dofs] = gains[:, None] * torch.clamp(a, -1.0, 1.0)
        return tau

    # ---- physics kernel vs plain ------------------------------------------
    B = 4096
    rng = np.random.default_rng(0)
    env = make_batched(ENV_ID, B, device="cuda")
    s0 = env.reset(seed=0)
    a = torch.as_tensor(rng.uniform(-1, 1, (task.act_dim, B)).astype(np.float32), device=dev)
    tau = torques(a)
    phys, _, n_rows = ce.make_cuda_physics_step(m, task.physics)
    qk, vk, dk = phys(s0.q, s0.v, tau)
    qp, vp, dp = phys.plain(s0.q, s0.v, tau)
    torch.cuda.synchronize()
    dq = (qk - qp).abs()
    flips = ((dk > 0) != (dp > 0)).float().mean().item()
    phys_err = dq.max().item()
    emit("physics_vs_plain", B=B, mean_dq=dq.mean().item(), max_dq=phys_err,
         max_dv=(vk - vp).abs().max().item(), depth_sign_flip_rate=flips)
    require(dq.mean().item() < 3e-4 and phys_err < 1e-2, "physics kernel q disagrees")
    require(flips < 0.01, "physics kernel depth signs disagree")
    require(torch.isfinite(qk).all().item() and torch.isfinite(vk).all().item(), "non-finite")

    # ---- env-step kernel vs plain -----------------------------------------
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
        a = torch.as_tensor(rng.uniform(-1, 1, (task.act_dim, B)).astype(np.float32), device=dev)
        ins = sk
        sk = step_k(ins, a)
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
        emit("env_vs_plain", B=B, **rec)
        require(rec["mean_dq"] < 3e-4 and rec["max_dq"] < 1e-2, "env kernel q disagrees")
        require(rec["obs_cont_mean"] < 1e-3, "env kernel obs disagree")
        require(rec["foot_flip_rate"] < 0.01, "env kernel foot flags disagree")
        require(rec["median_dreward"] < 5e-3, "env kernel reward disagrees")
        require(rec["term_flip_rate"] < 0.01, "env kernel termination disagrees")
        for name in ("epoch", "step_count", "truncated"):
            require(torch.equal(getattr(sk, name), getattr(sp, name)), f"{name} differs")
    emit("reset_and_repeat", reset_q_bitwise=True, repeat_bitwise=True)

    # ---- golden rollout ------------------------------------------------------
    g = np.load(os.path.join(HERE, "tests", "goldens", f"{ENV_ID}.cpu.npz"))
    Bg, n_steps, seed = int(g["batch"]), int(g["n_steps"]), int(g["seed"])
    genv = make_batched(ENV_ID, Bg, device="cuda")
    s = genv.reset(seed=seed)
    acts = np.random.default_rng(seed).uniform(-1, 1, (n_steps, Bg, task.act_dim)).astype(np.float32)
    meds = []
    for t in range(n_steps):
        s = genv.step(s, acts[t])
        d = np.abs(s.obs.cpu().numpy() - g["obs"][t])
        meds.append(float(np.median(d)))
        require(np.array_equal(s.terminated.cpu().numpy(), g["terminated"][t]),
                f"golden termination differs at step {t}")
    emit("golden", median_dobs_step5=meds[4], median_dobs_step20=meds[-1])
    require(meds[4] < 1e-3 and meds[-1] < 3e-2, "golden rollout drifted")

    # ---- main path: frozen SAC policy on BatchedEnv + the physics entry ---
    policy = policy_from_npz(os.path.join(HERE, "examples", "weights", f"{ENV_ID}.npz"), dev)
    penv = make_batched(ENV_ID, 8, device="cuda")
    penv.step_fn.launches = 0
    phys.launches = 0
    s = penv.reset(seed=123)
    rews, dones = [], []
    with torch.no_grad():
        for _ in range(task.max_episode_steps):
            s = penv.step(s, policy(s.obs.T))
            rews.append(s.reward)
            dones.append(s.done)
    q, v = s0.q, s0.v
    for _ in range(10):
        q, v, _ = phys(q, v, tau)
    torch.cuda.synchronize()
    launches = {"env_step_kernel": penv.step_fn.launches, "physics_step_kernel": phys.launches}
    rews = torch.stack(rews)
    alive = torch.cumprod(1.0 - torch.stack(dones).float(), 0)
    prev = torch.cat([torch.ones_like(alive[:1]), alive[:-1]], 0)
    returns = (rews * prev).sum(0).cpu().numpy()
    emit("frozen_policy", B=8, seed=123, returns=returns.tolist(), mean=float(returns.mean()),
         launches=launches)
    require(np.isfinite(returns).all() and returns.mean() >= 3000.0, "SAC return below 3000")
    require(torch.isfinite(q).all().item() and tuple(q.shape) == (m.nq, B), "physics rollout")
    require(all(n > 0 for n in launches.values()), f"a kernel was not launched: {launches}")

    # ---- throughput ---------------------------------------------------------
    rates = {}
    for Bt in (4096, 16384):
        tenv = make_batched(ENV_ID, Bt, device="cuda")
        st = tenv.reset(seed=1)
        at = torch.rand((Bt, task.act_dim), device=dev) * 2 - 1
        st = tenv.step(st, at)  # warm-up
        box = [st]

        def one():
            box[0] = tenv.step(box[0], at)

        ms = host_ms(one, 200)
        rates[Bt] = Bt * 1e3 / ms
        emit("throughput", route="cuda", B=Bt, steps=200, ms_per_step=ms,
             env_steps_per_s=rates[Bt], card=card)
    tenv = make_batched(ENV_ID, 4096, device="cuda")
    st = tenv.reset(seed=1)
    at = (torch.rand((4096, task.act_dim), device=dev) * 2 - 1).T.contiguous()
    plain_env_ms = host_ms(lambda: env_step_plain(task, st, at), 3)
    emit("throughput", route="plain", B=4096, steps=3, ms_per_step=plain_env_ms,
         env_steps_per_s=4096 * 1e3 / plain_env_ms, card=card)
    env_ms = cuda_ms(lambda: tenv.step_fn(st, at), 50)
    phys_ms = cuda_ms(lambda: phys(s0.q, s0.v, tau), 50)
    plain_phys_ms = host_ms(lambda: phys.plain(s0.q, s0.v, tau), 3)

    print(json.dumps({"kernels": [
        {"name": "physics_step_kernel", "route": "cuda", "source": SOURCE,
         "replaces": REPLACES["physics_step_kernel"],
         "launches": launches["physics_step_kernel"], "max_abs_err": phys_err,
         "ms": phys_ms, "plain_ms": plain_phys_ms},
        {"name": "env_step_kernel", "route": "cuda", "source": SOURCE,
         "replaces": REPLACES["env_step_kernel"],
         "launches": launches["env_step_kernel"], "max_abs_err": env_err,
         "ms": env_ms, "plain_ms": plain_env_ms},
    ]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
