"""GPU smoke run of the PyTorch + CUDA port (pybulletgym_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA GPU (built for sm_90a: an H100), nvcc, and this checkout. It
builds the kernels from `pybulletgym_tpu_torch/csrc/` and, for HalfCheetah
(hinge and slide joints) and Ant (a free root joint):
  * holds both kernels against their plain PyTorch versions on the card at
    B=4096 (forced resets, reset q bitwise, bitwise repeatable launches;
    Ant's quaternion stays a unit one);
  * replays the CPU golden rollouts (plus Hopper's and Walker2D's);
  * drives each main path with the launch counts reset just before it and
    read just after: the shipped policy on `BatchedEnv` (HalfCheetah's SAC
    policy, Ant's, and Hopper's and Walker2D's) followed by the physics
    entry point, and the PPO trainer (`parallel.ppo.train`) on Ant at
    B=4096 resumed from the JAX checkpoint, whose rollout launches the
    env-step kernel 32 times a train step;
  * times the kernels, the plain versions and the env-steps/s.

Each phase prints one JSON line; any failure raises (non-zero exit). The
last lines are the kernels' summary, the card's name and power limit as
nvidia-smi reports them, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CHEETAH = "HalfCheetahPyBulletEnv-v0"
ANT = "AntPyBulletEnv-v0"
HOPPER = "HopperPyBulletEnv-v0"
WALKER = "Walker2DPyBulletEnv-v0"
SOURCE = "pybulletgym_tpu_torch/csrc/engine.cu"
REPLACES = {
    "physics_step_kernel": "pybulletgym_tpu/ops/pallas_engine.py:48",
    "env_step_kernel": "pybulletgym_tpu/ops/pallas_engine.py:123",
}
# shipped-policy floors, tests/test_frozen_policy.py:29-41
POLICY_FLOOR = {CHEETAH: 3000.0, ANT: 2000.0, HOPPER: 2000.0, WALKER: 750.0}
# H100 SXM data sheet: float32 outside the tensor cores, and HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
B = 4096


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
    _, log = ce.load_cuda_library()
    ptxas = [ln.strip() for ln in log.splitlines()
             if "entry function" in ln or "registers" in ln or "spill" in ln]
    emit("build", seconds=time.perf_counter() - t0, nvcc=ce.nvcc_path(), ptxas=ptxas)

    def torques(task, a):  # (act, B) -> (nv, B), as WalkerTask.action_tau_scalar
        tau = torch.zeros((task.model.nv, a.shape[1]), device=dev)
        act_dofs = torch.as_tensor(task.act_dofs.astype(np.int64), device=dev)
        tau[act_dofs] = torch.as_tensor(task.gains, device=dev) * torch.clamp(a, -1.0, 1.0)
        return tau

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
        qk, vk, dk = phys(s0.q, s0.v, tau)
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

    # ---- golden rollouts through the env kernel ------------------------------
    def golden(env_id):
        task = make_task(env_id)
        g = np.load(os.path.join(HERE, "tests", "goldens", f"{env_id}.cpu.npz"))
        Bg, n_steps, seed = int(g["batch"]), int(g["n_steps"]), int(g["seed"])
        genv = make_batched(env_id, Bg)
        s = genv.reset(seed=seed)
        acts = np.random.default_rng(seed).uniform(-1, 1, (n_steps, Bg, task.act_dim)).astype(np.float32)
        meds = []
        for t in range(n_steps):
            s = genv.step(s, acts[t])
            d = np.abs(s.obs.cpu().numpy() - g["obs"][t])
            meds.append(float(np.median(d)))
            require(np.array_equal(s.terminated.cpu().numpy(), g["terminated"][t]),
                    f"{env_id} golden termination differs at step {t}")
        emit("golden", env=env_id, median_dobs_step5=meds[4], median_dobs_step20=meds[-1])
        require(meds[4] < 1e-3 and meds[-1] < 3e-2, f"{env_id} golden rollout drifted")
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
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            step(ts, es)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        dev_us = {}
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", None)
            us = e.self_cuda_time_total if us is None else us
            if us > 0:
                dev_us[e.key] = us
        busy_ms = sum(dev_us.values()) / 1e3
        top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:8]
        emit("ppo_profile", env=ANT, B=B, wall_ms=wall_ms, device_busy_ms=busy_ms,
             device_busy_share=busy_ms / wall_ms, card=card,
             env_kernel_ms=sum(us for k, us in dev_us.items() if "env_step_kernel" in k) / 1e3,
             top=[(k[:80], us / 1e3) for k, us in top])
        return launches

    # ---- times and bounds, per model at B=4096 --------------------------------
    def times(env_id, p):
        task = make_task(env_id)
        tenv = make_batched(env_id, B)
        st = tenv.reset(seed=1)
        at = (torch.rand((B, task.act_dim), device=dev) * 2 - 1)
        st = tenv.step(st, at)  # warm-up
        box = [st]

        def one():
            box[0] = tenv.step(box[0], at)

        ms = host_ms(one, 200)
        emit("throughput", env=env_id, route="cuda", B=B, steps=200, ms_per_step=ms,
             env_steps_per_s=B * 1e3 / ms, card=card)
        a_t = at.T.contiguous()
        plain_env_ms = host_ms(lambda: env_step_plain(task, st, a_t), 2)
        emit("throughput", env=env_id, route="plain", B=B, steps=2, ms_per_step=plain_env_ms,
             env_steps_per_s=B * 1e3 / plain_env_ms, card=card)
        phys, s0, tau = p["phys"], p["s0"], p["tau"]
        out = {}
        tables = {"env_step_kernel": ce.pack_tables(task),
                  "physics_step_kernel": ce.pack_physics(task.model, task.physics)}
        kms = {"env_step_kernel": cuda_ms(lambda: tenv.step_fn(st, a_t), 50),
               "physics_step_kernel": cuda_ms(lambda: phys(s0.q, s0.v, tau), 50)}
        pms = {"env_step_kernel": plain_env_ms,
               "physics_step_kernel": host_ms(lambda: phys.plain(s0.q, s0.v, tau), 2)}
        for name in kms:
            flops, nbytes = ce.work_per_env_step(tables[name], env_step=name == "env_step_kernel")
            t_ops = flops * B / PEAK_FP32_FLOPS * 1e3
            t_bytes = (nbytes * B + ctypes.sizeof(tables[name])) / PEAK_BYTES_PER_S * 1e3
            out[name] = dict(ms=kms[name], plain_ms=pms[name], bound_ms=max(t_ops, t_bytes),
                             bound_by="operations" if t_ops >= t_bytes else "bytes",
                             flops_per_env_step=flops, bytes_per_env_step=nbytes)
            emit("kernel_time", env=env_id, kernel=name, B=B, card=card, **out[name])
        return out

    # HalfCheetah: the phases of the first slice, and its main path
    pc = parity(CHEETAH)
    golden(CHEETAH)
    main_c = policy_path(CHEETAH, (pc["phys"], pc["s0"].q, pc["s0"].v, pc["tau"]))
    require(all(n > 0 for n in main_c.values()), f"a kernel was not launched: {main_c}")
    for Bt in (16384,):  # B=4096 is timed below, with the kernel times
        tenv = make_batched(CHEETAH, Bt)
        st = tenv.reset(seed=1)
        at = torch.rand((Bt, pc["task"].act_dim), device=dev) * 2 - 1
        st = tenv.step(st, at)
        box = [st]

        def one():
            box[0] = tenv.step(box[0], at)

        ms = host_ms(one, 200)
        emit("throughput", env=CHEETAH, route="cuda", B=Bt, steps=200, ms_per_step=ms,
             env_steps_per_s=Bt * 1e3 / ms, card=card)

    # Ant: both kernels, its golden, its policy path, the trainer
    pa = parity(ANT)
    golden(ANT)
    main_a = policy_path(ANT, (pa["phys"], pa["s0"].q, pa["s0"].v, pa["tau"]))
    main_t = trainer()
    # Hopper and Walker2D: the "hopper" alive mode, held by goldens and policies
    for env_id in (HOPPER, WALKER):
        golden(env_id)
        policy_path(env_id)

    t_c, t_a = times(CHEETAH, pc), times(ANT, pa)
    launches = {"env_step_kernel": main_t["env_step_kernel"],
                "physics_step_kernel": main_a["physics_step_kernel"]}
    err_key = {"env_step_kernel": "env_err", "physics_step_kernel": "phys_err"}
    errs = {k: max(pc[e], pa[e]) for k, e in err_key.items()}
    kernels = []
    for name in ("physics_step_kernel", "env_step_kernel"):
        a = t_a[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": a["ms"], "plain_ms": a["plain_ms"], "bound_ms": a["bound_ms"],
            "bound_by": a["bound_by"], "library_ms": None, "B": B, "timed_on": ANT,
            "models": [CHEETAH, ANT] + ([HOPPER, WALKER] if name == "env_step_kernel" else []),
            "per_model": {
                CHEETAH: {**t_c[name], "max_abs_err": pc[err_key[name]], "launches": main_c[name]},
                ANT: {**a, "max_abs_err": pa[err_key[name]], "launches": launches[name]},
            },
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
