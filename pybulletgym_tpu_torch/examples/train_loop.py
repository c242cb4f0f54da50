"""Resumable PPO training, the port of `examples/train_loop.py`: checkpoints
the TrainState every run so long trainings survive interruptions. Usage:
    python -m pybulletgym_tpu_torch.examples.train_loop HopperPyBulletEnv-v0 --iters 150 --batch 4096
Re-running continues from the saved checkpoint.

The files are the JAX script's, in `--weights-dir`: `<env>.trainstate.npz`
(`utils/checkpoint.py`'s npz of the `TrainState`, which either package's
`train_loop` resumes from) and `<env>.npz` (the policy, what `enjoy` reads).
Beside them goes `<env>.b<batch>.envstate.npz`, the env batch, which a
re-run with the same `--batch` continues instead of resetting it: two runs
of N and M iterations then end where one run of N + M ends (bitwise on one
device). The sampling stream continues from the checkpoint too.
"""

import argparse
import os
import time

from pybulletgym_tpu_torch.examples import WEIGHTS

# the JAX script's --backend values, as the port's `backend=` choices
BACKENDS = {"pallas": "fused", "xla": "composed"}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("env_id")
    ap.add_argument("--iters", type=int, default=150)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--backend", default="pallas", choices=sorted(BACKENDS),
                    help="pallas (default) runs the port's 'fused' backend, one env step "
                    "kernel launch a step; xla runs 'composed', the task's hooks in torch "
                    "around the physics kernel")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--entropy", type=float, default=0.0)
    ap.add_argument("--normalize", action="store_true",
                    help="running observation normalization")
    ap.add_argument("--rollout", type=int, default=32)
    ap.add_argument("--weights-dir", default=WEIGHTS,
                    help="where the checkpoints and the policy are read and written")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain version)")
    args = ap.parse_args(argv)

    from pybulletgym_tpu_torch.parallel import ppo
    from pybulletgym_tpu_torch.utils import checkpoint
    from pybulletgym_tpu_torch.utils.interop import policy_to_npz

    ck = os.path.join(args.weights_dir, args.env_id + ".trainstate.npz")
    env_ck = os.path.join(args.weights_dir, f"{args.env_id}.b{args.batch}.envstate.npz")
    cfg = ppo.PPOConfig(rollout_length=args.rollout, learning_rate=args.lr,
                        num_minibatches=8, entropy_coef=args.entropy,
                        normalize_obs=args.normalize)
    t0 = time.time()

    def progress(it, m):
        if it % 10 == 0:
            print(f"iter {it} reward {m['reward_mean']:+.3f} "
                  f"done_frac {m['done_frac']:.3f} "
                  f"{(it+1)*cfg.rollout_length*args.batch/(time.time()-t0):,.0f} steps/s",
                  flush=True)

    def train(resume):
        env_resume = env_ck if resume and os.path.exists(env_ck) else None
        return ppo.train(args.env_id, args.batch, args.iters, cfg=cfg, device=args.device,
                         backend=BACKENDS[args.backend], progress=progress,
                         resume_from=resume, resume_env_from=env_resume)

    resume = ck if os.path.exists(ck) else None
    print("resuming from" if resume else "fresh start", resume or "", flush=True)
    try:
        ts, es, m = train(resume)
    except ValueError as e:
        if resume is None:
            raise
        print(f"checkpoint incompatible ({e}); starting fresh", flush=True)
        ts, es, m = train(None)
    os.makedirs(args.weights_dir, exist_ok=True)
    checkpoint.save(ck, ts)
    checkpoint.save(env_ck, es)

    out = os.path.join(args.weights_dir, args.env_id + ".npz")
    policy_to_npz(out, ts, normalized=args.normalize)
    print("saved", out, "and", ck, flush=True)


if __name__ == "__main__":
    main()
