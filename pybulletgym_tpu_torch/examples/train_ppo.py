"""Train a PPO policy on any registered env and save the weights: the port
of `examples/train_ppo.py`.

Usage:
    python -m pybulletgym_tpu_torch.examples.train_ppo HopperPyBulletEnv-v0 --iters 300 --batch 2048

The saved .npz has the JAX script's keys (`n_layers`, `log_std`, `w{i}`,
`b{i}`, `vw{i}`, `vb{i}`) and is what `examples.enjoy`, of either package,
reads. On the card (the default) each rollout step is one launch of the env
step kernel; without a card, `--device cuda` raises (RuntimeError).
"""

import argparse
import os
import time

from pybulletgym_tpu_torch.examples import WEIGHTS


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("env_id")
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--rollout", type=int, default=32)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the env step kernel) or cpu (the plain version)")
    args = ap.parse_args(argv)

    from pybulletgym_tpu_torch.parallel import ppo
    from pybulletgym_tpu_torch.utils.interop import policy_to_npz

    cfg = ppo.PPOConfig(rollout_length=args.rollout, learning_rate=args.lr)
    t0 = time.time()

    def progress(it, metrics):
        if it % 10 == 0:
            sps = (it + 1) * args.rollout * args.batch / (time.time() - t0)
            print(f"iter {it:4d}  reward/step {metrics['reward_mean']:+.3f}  "
                  f"loss {metrics['loss']:+.4f}  {sps:,.0f} env-steps/s",
                  flush=True)

    ts, es, metrics = ppo.train(
        args.env_id, args.batch, args.iters, cfg=cfg, seed=args.seed,
        device=args.device, progress=progress,
    )

    out = args.out or os.path.join(WEIGHTS, args.env_id + ".npz")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    policy_to_npz(out, ts)
    print(f"saved {out}  (final reward/step {float(metrics['reward_mean']):+.3f})")


if __name__ == "__main__":
    main()
