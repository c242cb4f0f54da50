"""Roll out a saved policy, the port of `examples/enjoy.py`: load frozen
weights (the shipped `examples/weights/<env>.npz`, or a file that
`train_ppo` or `train_loop` of either package wrote), run the deterministic
policy (tanh MLP mean action, `utils.interop.policy_from_npz`) through the
single-env gymnasium adapter, report episode returns.

Usage:
    python -m pybulletgym_tpu_torch.examples.enjoy HopperPyBulletEnv-v0 [--episodes 5] [--render out.npy]

On the card (the default) each step is one launch of the env step kernel at
B=1; the frames come from the native ray tracer (`utils.render`).
"""

import argparse
import os

from pybulletgym_tpu_torch.examples import WEIGHTS


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("env_id")
    ap.add_argument("--episodes", type=int, default=5)
    ap.add_argument("--weights", default=None)
    ap.add_argument("--render", default=None,
                    help="save frames of the first episode to this .npy")
    ap.add_argument("--gif", default=None,
                    help="save the first episode as an animated GIF "
                    "(every --gif-stride-th frame)")
    ap.add_argument("--gif-stride", type=int, default=4)
    ap.add_argument("--max-steps", type=int, default=0,
                    help="cap rollout length (0 = episode limit)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the env step kernel) or cpu (the plain version)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    import pybulletgym_tpu_torch as pt
    from pybulletgym_tpu_torch.utils.interop import policy_from_npz

    path = args.weights or os.path.join(WEIGHTS, args.env_id + ".npz")
    env = pt.make(args.env_id, device=args.device)
    pi = policy_from_npz(path, device=args.device)

    @torch.no_grad()
    def act(obs):
        return pi(torch.as_tensor(obs, device=args.device)[None])[0].cpu().numpy()

    frames = []
    capture = args.render or args.gif
    stride = args.gif_stride if args.gif else 1  # --render keeps every frame
    for ep in range(args.episodes):
        obs, _ = env.reset(seed=ep)
        total, steps = 0.0, 0
        while True:
            obs, r, term, trunc, _ = env.step(act(obs))
            total += r
            steps += 1
            if capture and ep == 0 and steps % stride == 0:
                frames.append(env.render())
            if term or trunc or (args.max_steps and steps >= args.max_steps):
                break
        print(f"episode {ep}: return {total:+.1f} in {steps} steps")

    if args.render and frames:
        np.save(args.render, np.stack(frames))
        print(f"saved {len(frames)} frames to {args.render}")
    if args.gif and frames:
        from PIL import Image

        ims = [Image.fromarray(f) for f in frames]
        ims[0].save(args.gif, save_all=True, append_images=ims[1:],
                    duration=int(1000 * args.gif_stride / 60), loop=0,
                    optimize=True)
        print(f"saved {len(ims)}-frame gif to {args.gif}")


if __name__ == "__main__":
    main()
