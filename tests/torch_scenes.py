"""Scenes of the large and huge classes' rarer paths, written here without
JAX so that the CPU tests (tests/test_torch_tree_paths.py) and the GPU
tests (tests/test_torch_cuda.py) share them: a chain whose supports pass
PATH_CAP (engine_core.h · path_solve_mem) and a pair row over three mask
words (the sweep's further windows, win_step)."""


def wide_xml(n_balls: int = 11) -> str:
    """Two overlapping free spheres A and C with `n_balls` free balls
    between them in dof order (A dofs 0-5, the balls 6 .. 6 n_balls + 5, C
    after them: at 11 balls dofs 72-77, mask word 2), all on the floor."""
    ball = ('<body name="{n}" pos="{x} {y} 0.09"><joint name="{n}j" type="free"/>'
            '<geom name="{n}s" type="sphere" size="0.1"/></body>')
    balls = "".join(ball.format(n=f"b{i}", x=0.3 * i, y=2) for i in range(n_balls))
    return ('<mujoco model="wide"><worldbody><geom name="floor" type="plane" size="10 10 0.1"/>'
            + ball.format(n="A", x=0, y=0) + balls + ball.format(n="C", x=0.15, y=0)
            + '</worldbody></mujoco>')


def chain_xml(n: int = 26) -> str:
    """A chain of n hinged links (axis z, every third limited to +-20
    degrees) lying on the floor from a fixed base, a sphere at each link's
    end: the last link's floor row is over all n dofs."""
    body = ""
    for k in reversed(range(n)):
        lim = ' limited="true" range="-20 20"' if k % 3 == 2 else ""
        body = (f'<body name="l{k}" pos="0.05 0 0"><joint name="j{k}" type="hinge" axis="0 0 1"'
                f'{lim}/><geom name="s{k}" type="sphere" size="0.02" pos="0.05 0 0"/>'
                f'{body}</body>')
    return ('<mujoco model="chain"><worldbody><geom name="floor" type="plane" size="10 10 0.1"/>'
            f'<body name="base" pos="0 0 0.015">{body}</body></worldbody></mujoco>')


WIDE_PAIRS = (("As", "Cs"),)
