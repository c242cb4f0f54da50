"""User tasks shared by the CPU tests, the mesh workers and chip_smoke.py.
Nothing here imports JAX: each task is written once over an array namespace.

`shaped_ant(loco, xp, nn)` is ShapedAnt for the package of `loco` (its
locomotion module), with `xp` its array namespace (jax.numpy or torch) and
`nn` the namespace of `NN_TORCH` or the JAX tests' `NN_JAX` (the functions
whose names or defaults differ between the libraries, written with torch's
formula on both sides). It is Ant (`AntPyBulletEnv-v0`'s model, nv 14, 8
actuators, a free root) with WalkerTask's hooks and, on top:

* a per-env target heading from env_id (floor_divide and fmod: one of four
  directions), the torso's heading error to it wrapped into [-pi, pi) with
  remainder, and again with round for the obs;
* the torso's planar speed as hypot of the root's body-frame velocity, a
  new aux key `speed_avg` (its running mean) and, before the physics, the
  root's angular velocity damped by lerp with a weight from that mean;
* the torso-up vector as a stacked (3, B) value: its norm
  (linalg.vector_norm over the leading axis) and a dot product with the
  world's up axis ((u * w).sum(0));
* a shaped reward term of softplus, sigmoid, relu and a tensor power, with
  its own NaN guard (isnan, nan_to_num), as the reward component `shaped`;
* three more obs entries before the foot flags: the rounded heading error,
  the uprightness and the mean speed.

`OpProbe` (torch only) is a toy task on InvertedPendulum's model whose obs
are the translated ops' results, one entry each (`OP_ENTRIES` names them
and says how the CPU test holds each); its three actions make each env's
inputs (see `op_inputs`).
"""

import math

import numpy as np

SHAPED_ANT_ID = "ShapedAnt-v0"
SHAPED_ANT_STEPS = 1000
OP_PROBE_ID = "OpProbe-v0"


class NN_TORCH:
    """The torch side of `nn` (torch's own functions)."""

    @staticmethod
    def softplus(x):
        import torch.nn.functional as F
        return F.softplus(x)

    @staticmethod
    def sigmoid(x):
        import torch
        return torch.sigmoid(x)

    @staticmethod
    def relu(x):
        import torch
        return torch.relu(x)

    @staticmethod
    def lerp(a, b, w):
        import torch
        return torch.lerp(a, b, w)

    @staticmethod
    def norm0(u):
        import torch
        return torch.linalg.vector_norm(u, dim=0)


def shaped_ant(loco, xp, nn):
    """ShapedAnt's class for the package of `loco` (see the module's
    docstring)."""

    class ShapedAnt(loco.WalkerTask):
        HEADINGS = 4  # target headings, a quarter turn apart
        DAMP = 0.02  # the most of the root's angular velocity lerp takes away

        def __init__(self):
            super().__init__(loco.ANT)
            self.obs_dim += 3

        def initial_state_scalar(self, seed, env_id, epoch):
            q, v, aux = super().initial_state_scalar(seed, env_id, epoch)
            return q, v, dict(aux, speed_avg=xp.zeros_like(aux["potential"]))

        def pre_physics_scalar(self, q, v, aux, ids=None):
            w = xp.clip(aux["speed_avg"] * self.DAMP, 0.0, self.DAMP)
            v = list(v)
            for k in range(3):  # the free root's angular velocity, body frame
                v[k] = nn.lerp(v[k], xp.zeros_like(v[k]), w)
            return q, v, aux

        def heading(self, env_id):
            """Each env's target heading: a quarter turn times
            (env_id + env_id // 4) mod 4."""
            d = xp.fmod(env_id + xp.floor_divide(env_id, self.HEADINGS), self.HEADINGS)
            return d * (0.5 * math.pi)

        def output_scalar(self, q, v, depths, a, aux, ids=None):
            obs, reward, term, aux2, comps = super().output_scalar(q, v, depths, a, aux, ids)
            qw, qx, qy, qz = q[3], q[4], q[5], q[6]
            yaw = xp.arctan2(2.0 * (qw * qz + qx * qy), 1.0 - 2.0 * (qy * qy + qz * qz))
            target = self.heading(ids[1]) if ids is not None else xp.zeros_like(yaw)
            err = xp.remainder(yaw - target + math.pi, 2.0 * math.pi) - math.pi
            turns = (yaw - target) / (2.0 * math.pi)
            err_round = (turns - xp.round(turns)) * 2.0
            speed = xp.hypot(v[3], v[4])
            up = xp.stack([2.0 * (qx * qz + qw * qy), 2.0 * (qy * qz - qw * qx),
                           1.0 - 2.0 * (qx * qx + qy * qy)])
            zero = xp.zeros_like(qw)
            world_up = xp.stack([zero, zero, xp.ones_like(qw)])
            upright = (up * world_up).sum(0) / nn.norm0(up)
            power = (1.0 + nn.relu(speed - 0.5)) ** (0.5 + xp.clip(upright, 0.0, 1.0))
            shaped = (0.5 * nn.softplus(4.0 * (upright - 0.5)) + 0.3 * nn.sigmoid(-xp.abs(err))
                      + 0.1 * (power - 1.0))
            shaped = xp.where(xp.isnan(shaped), 0.0, xp.nan_to_num(shaped, posinf=2.0,
                                                                  neginf=-2.0))
            speed_avg = 0.9 * aux["speed_avg"] + 0.1 * speed
            nf = len(self.foot_rows)  # the foot flags stay last
            obs = list(obs[:-nf]) + [err_round, upright, speed_avg] + list(obs[-nf:])
            return (obs, reward + shaped, term, dict(aux2, speed_avg=speed_avg),
                    dict(comps, shaped=shaped))

    return ShapedAnt


# ---- the op probe ----------------------------------------------------------
# Each entry's name and how the CPU test holds the host twin's value to the
# plain step's: "bits" (bit for bit: the same IEEE operations in the same
# order on both); an ulp count (int: a libm function, or an op whose torch
# CPU kernel takes another order or precision than its CUDA kernel, which
# the translation follows; a sign of zero counts no ulp); or, where such an
# op ends in a sum that may cancel, |twin - plain| <= tol max(1, |plain|)
# (float: gelu and its tanh form, whose 1 + erf or 1 + tanh cancels for
# x < -1, an ulp of erf near -1 times |x| / 2 <= 16; logaddexp, whose
# max + log1p(...) cancels; addcmul and addcdiv with a value, which torch's
# CPU kernel rounds otherwise; cumsum, which it accumulates in double).
# relu, fmax, fmin: a tie of zeros may give either (IEEE maxNum; torch's
# CPU kernel takes the first, glibc the second; torch's CUDA relu is
# fmaxf(x, 0), +0 at -0). FINITE_ONLY entries the CPU
# test holds where the inputs are finite only.
OP_ENTRIES = (
    # activations
    ("relu", 0), ("sigmoid", 4), ("softplus", 2), ("softplus_beta", 2),
    ("logsigmoid", 2), ("silu", 4), ("elu", 2), ("leaky_relu", "bits"),
    ("hardtanh", "bits"), ("gelu", 4e-6), ("gelu_tanh", 1e-6), ("mish", 4), ("logit", 2),
    ("logit_eps", 2), ("logaddexp", 1e-6),
    # rounding and integer division
    ("div_floor", "bits"), ("div_trunc", "bits"), ("div_floor_scalar", "bits"),
    ("div_trunc_scalar", "bits"), ("floor_divide", "bits"), ("floor_divide_int", "bits"),
    ("floor_divide_int_scalar", "bits"), ("div_trunc_int", "bits"), ("fmod", "bits"),
    ("fmod_scalar", "bits"), ("fmod_int", "bits"), ("remainder", "bits"), ("round", "bits"),
    ("round_decimals", "bits"), ("round_negative_decimals", "bits"), ("frac", "bits"),
    ("copysign", "bits"), ("signbit", "bits"), ("sgn", "bits"),
    # powers
    ("pow_tensor_tensor", 2), ("pow_scalar_base", 2), ("pow_int", "bits"),
    ("pow_int_tensor", "bits"), ("pow_int_negative", "bits"),
    ("pow_float64", 1),
    # composites
    ("hypot", 1), ("lerp_scalar", "bits"), ("lerp_tensor", "bits"), ("addcmul", "bits"),
    ("addcmul_value", 1e-6), ("addcdiv", "bits"), ("addcdiv_value", 1e-6), ("xlogy", 2),
    ("xlogy_scalar", 2), ("deg2rad", "bits"), ("rad2deg", "bits"), ("sinc", 2),
    # special functions
    ("erfc", 2), ("erfinv", 2), ("asinh", 2), ("acosh", 2), ("atanh", 2),
    # NaN and infinity
    ("isnan", "bits"), ("isinf", "bits"), ("isposinf", "bits"), ("isneginf", "bits"),
    ("isfinite", "bits"),
    ("nan_to_num", "bits"), ("nan_to_num_default", "bits"), ("fmax", 0), ("fmin", 0),
    ("heaviside", "bits"), ("masked_fill", "bits"),
    # float64
    ("sin_f64", 1), ("exp_f64", 1), ("log1p_f64", 1), ("sigmoid_f64", 1),
    ("atan2_f64", 1), ("sqrt_f64", 1), ("rsqrt_f64", 1), ("square_f64", "bits"),
    ("remainder_f64", 1),
    # per-env vectors
    ("stack_sum", "bits"), ("stack_prod", "bits"), ("stack_mean", 1), ("amax", "bits"),
    ("amin", "bits"), ("max_values", "bits"), ("max_indices", "bits"),
    ("min_values", "bits"), ("min_indices", "bits"), ("all", "bits"), ("any", "bits"),
    ("norm2", 1), ("norm1", "bits"), ("norm_inf", "bits"), ("norm_neg_inf", "bits"),
    ("norm0", "bits"), ("norm3", 2), ("logsumexp", 2),
    ("cumsum_last", 1e-6), ("cumprod_last", 2), ("select", "bits"), ("slice_sum", "bits"),
    ("cat_unbind", "bits"), ("index_const", "bits"), ("unsqueeze_squeeze", "bits"),
    ("transpose_sum", "bits"), ("dot_const", "bits"), ("keepdim_sum", "bits"),
    ("split_sum", "bits"), ("flip_first", "bits"), ("index_select_sum", "bits"),
    ("permute_sum", "bits"), ("expand_sum", "bits"), ("reshape_select", "bits"),
    # ties of zeros (x and y are -0.0 and +0.0 in env 0, +0.0 and -0.0 in env
    # 1): torch's CUDA kernels order -0.0 below +0.0 (::max, ::min) and its
    # reductions keep the later of a tie, where its CPU kernels keep the
    # first; the translation follows the CUDA kernels, so the CPU test holds
    # the sign apart (TIE_BITS, tests/test_torch_tree_blocks.py) and
    # chip_smoke.py bit for bit against the card
    ("maximum_tie", 0), ("minimum_tie", 0), ("clamp_tie", 0), ("clamp_min_tie", 0),
    ("clamp_max_tie", 0), ("amax_tie", 0), ("amin_tie", 0),
)
# The ties' results on torch's CUDA kernels, (env 0, env 1), True for -0.0
TIE_BITS = {"maximum_tie": (False, False), "minimum_tie": (True, True),
            "clamp_tie": (False, False), "clamp_min_tie": (False, False),
            "clamp_max_tie": (True, True), "amax_tie": (False, True), "amin_tie": (False, True)}
# gelu(+inf): torch's CPU kernel gives NaN, its CUDA kernel's formula (which
# the translation follows) +inf; chip_smoke.py holds it there against the card
FINITE_ONLY = ("gelu",)
# NaN and the infinities of the probe's outputs become these finite values
NAN_OUT, POSINF_OUT, NEGINF_OUT = -123.0, 456.0, -789.0


# x = 32 a[0] on these edge values (exact products) in the first envs, and
# a[2] putting x on NaN (two envs), +inf (two) and -inf (two) in the last six
PROBE_EDGES = (-0.0, 0.0, 0.5, -0.5, 1.5, -1.5, 2.5, -2.5, 3.5, 25.0, -25.0, 21.0, -21.0,
               20.0, 32.0, -32.0, 0.25, 7.0, -7.0, 1.0)
PROBE_SPECIAL = (0.9, 0.8, -0.9, -0.8, -0.6, -0.55)


def probe_actions(n, seed):
    """The op probe's actions (3, n) for n envs (n >= 26): seeded, with x on
    PROBE_EDGES in the first envs, y = 4 a[1] on 0.0, -0.0, 2.0 and -2.5 in
    the first four, and PROBE_SPECIAL's a[2] in the last six."""
    rng = np.random.default_rng(seed)
    a = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n), rng.uniform(-0.5, 0.75, n)])
    a[0, :len(PROBE_EDGES)] = np.array(PROBE_EDGES) / 32.0
    a[1, :4] = [0.0, -0.0, 0.5, -0.625]
    a[2, n - len(PROBE_SPECIAL):] = PROBE_SPECIAL
    return a.astype(np.float32)


def ulps(a, b):
    """|a - b| of two float32 numpy arrays in ulps, elementwise (both zeros 0;
    NaN against a number, or across the float range, huge)."""
    def ordered(x):
        i = np.ascontiguousarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)

    return np.abs(ordered(a) - ordered(b))


def op_inputs(a, torch):
    """The probe's per-env inputs from its clipped actions (a[0], a[1],
    a[2]): x = 32 a[0], which a test's actions put on -0.0, halfway values
    and |x| > 20 (the product is exact); y = 4 a[1]; and, where a[2] > 0.75,
    < -0.75 or < -0.5, x becomes NaN, +inf or -inf (`xs`)."""
    x = 32.0 * a[0]
    y = 4.0 * a[1]
    nan = torch.full_like(x, float("nan"))
    inf = torch.full_like(x, float("inf"))
    xs = torch.where(a[2] > 0.75, nan, torch.where(a[2] < -0.75, inf,
                                                   torch.where(a[2] < -0.5, -inf, x)))
    return x, y, xs


def tie_values(x, y, torch):
    """{entry name: value} of the ties of zeros of OP_ENTRIES (TIE_BITS)."""
    return {"maximum_tie": torch.maximum(x, y), "minimum_tie": torch.minimum(x, y),
            "clamp_tie": torch.clamp(x, min=0.0, max=1.0),
            "clamp_min_tie": torch.clamp_min(x, 0.0), "clamp_max_tie": torch.clamp_max(x, -0.0),
            "amax_tie": torch.stack([x, y]).amax(0), "amin_tie": torch.stack([x, y]).amin(0)}


def op_values(x, y, xs, env_id, torch):
    """{entry name: value} of every op of OP_ENTRIES on per-env (B,) inputs."""
    F = torch.nn.functional
    k = x.to(torch.int64)  # finite: x itself
    j = env_id.to(torch.int64) - 3
    y0 = torch.where(y == 0.0, torch.ones_like(y), y)  # a divisor
    u = torch.stack([xs, y, x * 0.25 - 1.0, -y])  # (4, B)
    w = torch.stack([y, xs, -x, x * 0.5])
    xd, yd = xs.to(torch.float64), y.to(torch.float64)
    mx, mi = torch.max(u, 0), u.min(dim=0)
    out = {
        "relu": torch.relu(xs), "sigmoid": torch.sigmoid(xs), "softplus": F.softplus(xs),
        "softplus_beta": F.softplus(xs, beta=2.0, threshold=10.0),
        "logsigmoid": F.logsigmoid(xs), "silu": F.silu(xs), "elu": F.elu(xs, 0.7),
        "leaky_relu": F.leaky_relu(xs, 0.1), "hardtanh": F.hardtanh(xs, -2.0, 3.0),
        "gelu": F.gelu(xs), "gelu_tanh": F.gelu(xs, approximate="tanh"), "mish": F.mish(xs),
        "logit": torch.logit(y * 0.125 + 0.5),
        "logit_eps": torch.logit(y * 0.25 + 0.5, eps=0.01),
        "logaddexp": torch.logaddexp(xs, y),
        "div_floor": torch.div(xs, y0, rounding_mode="floor"),
        "div_trunc": torch.div(xs, y0, rounding_mode="trunc"),
        "div_floor_scalar": torch.div(xs, 0.25, rounding_mode="floor"),
        "div_trunc_scalar": torch.div(xs, -4.0, rounding_mode="trunc"),
        "floor_divide": xs // y0, "floor_divide_int": k // (j + (j == 0).to(torch.int64)),
        "floor_divide_int_scalar": k // -3,
        "div_trunc_int": torch.div(k, 5, rounding_mode="trunc"),
        "fmod": torch.fmod(xs, y0), "fmod_scalar": torch.fmod(xs, 2.5),
        "fmod_int": torch.fmod(k, 7), "remainder": torch.remainder(xs, y0),
        "round": torch.round(xs), "round_decimals": torch.round(xs * 0.01, decimals=2),
        "round_negative_decimals": torch.round(xs * 10.0, decimals=-1),
        "frac": torch.frac(xs), "copysign": torch.copysign(y, xs),
        "signbit": torch.signbit(xs), "sgn": torch.sgn(xs),
        "pow_tensor_tensor": torch.pow(torch.abs(y) + 0.5, xs * 0.125),
        "pow_scalar_base": 2.0 ** (xs * 0.25), "pow_int": k ** 3,
        "pow_int_tensor": j ** (k % 5), "pow_int_negative": j ** (k % 5 - 2),
        "pow_float64": (xd * 0.125).abs() ** 1.7,
        "hypot": torch.hypot(xs, y), "lerp_scalar": torch.lerp(xs, y, 0.3),
        "lerp_tensor": torch.lerp(xs, y, y * 0.25),
        "addcmul": torch.addcmul(y, xs, y), "addcmul_value": torch.addcmul(y, xs, y, value=0.3),
        "addcdiv": torch.addcdiv(y, xs, y0), "addcdiv_value": torch.addcdiv(y, xs, y0, value=-2.0),
        "xlogy": torch.xlogy(xs, torch.abs(y)), "xlogy_scalar": torch.xlogy(2.0, torch.abs(xs)),
        "deg2rad": torch.deg2rad(xs), "rad2deg": torch.rad2deg(xs), "sinc": torch.sinc(xs * 0.125),
        "erfc": torch.erfc(xs * 0.125), "erfinv": torch.erfinv(xs * 0.03125),
        "asinh": torch.asinh(xs), "acosh": torch.acosh(torch.abs(xs) + 1.0),
        "atanh": torch.atanh(xs * 0.03125),
        "isnan": torch.isnan(xs), "isinf": torch.isinf(xs), "isposinf": torch.isposinf(xs),
        "isneginf": torch.isneginf(xs), "isfinite": torch.isfinite(xs),
        "nan_to_num": torch.nan_to_num(xs, nan=1.5, posinf=2.5, neginf=-3.5),
        "nan_to_num_default": torch.nan_to_num(xs) * 1e-30,  # the float32 extremes, scaled
        "fmax": torch.fmax(xs, y), "fmin": torch.fmin(xs, y),
        "heaviside": torch.heaviside(xs, y), "masked_fill": xs.masked_fill(y > 1.0, -2.5),
        "sin_f64": torch.sin(xd), "exp_f64": torch.exp(xd * 0.25),
        "log1p_f64": torch.log1p(yd.abs()),
        "sigmoid_f64": torch.sigmoid(xd), "atan2_f64": torch.atan2(xd, yd),
        "sqrt_f64": torch.sqrt(xd.abs()), "rsqrt_f64": torch.rsqrt(yd.abs()),
        "square_f64": xd ** 2, "remainder_f64": torch.remainder(xd, yd + 4.5),
        "stack_sum": u.sum(0), "stack_prod": u.prod(0), "stack_mean": u.mean(0),
        "amax": u.amax(0), "amin": torch.amin(u, 0), "max_values": mx.values,
        "max_indices": mx.indices, "min_values": mi.values, "min_indices": mi.indices,
        "all": (u > -1.0).all(0), "any": (u > 5.0).any(0),
        "norm2": torch.linalg.vector_norm(u, dim=0),
        "norm1": torch.linalg.vector_norm(u, ord=1, dim=0),
        "norm_inf": torch.linalg.vector_norm(u, ord=float("inf"), dim=0),
        "norm_neg_inf": torch.linalg.vector_norm(u, ord=-float("inf"), dim=0),
        "norm0": torch.linalg.vector_norm(u, ord=0, dim=0),
        "norm3": torch.linalg.vector_norm(u * 0.125, ord=3, dim=0),
        "logsumexp": torch.logsumexp(u * 0.125, 0),
        "cumsum_last": u.cumsum(0)[-1], "cumprod_last": (u * 0.125).cumprod(0)[-1], "select": u[2],
        "slice_sum": u[1:3].sum(0), "cat_unbind": torch.cat([u[:2], w[2:]]).unbind(0)[3],
        "index_const": u[torch.tensor([3, 0, 3], device=u.device)].sum(0),
        "unsqueeze_squeeze": (x.unsqueeze(0) * 2.0).squeeze(0),
        "transpose_sum": torch.stack([u, w]).transpose(0, 1)[1].sum(0),
        "dot_const": (u * torch.tensor([1.0, -2.0, 0.5, 0.0], device=u.device)[:, None]).sum(0),
        "keepdim_sum": (u * w).sum(0, keepdim=True)[0],
        "split_sum": torch.split(u, [1, 3])[1].sum(0), "flip_first": u.flip(0)[0],
        "index_select_sum": torch.index_select(
            u, 0, torch.tensor([2, 2, 1], device=u.device)).sum(0),
        "permute_sum": torch.stack([u, w]).permute(1, 0, 2)[2].sum(0),
        "expand_sum": (x.expand(3, -1) * torch.stack([y, x, y])).sum(0),
        "reshape_select": u.reshape(2, 2, -1)[1, 0],
        **tie_values(x, y, torch),
    }
    assert list(out) == [n for n, _ in OP_ENTRIES]
    return out


def op_probe(pendula, torch):
    """The op probe's class over the port's `envs.pendula` module."""

    class OpProbe(pendula.InvertedPendulumTask):
        def __init__(self):
            super().__init__()
            self.act_dim = 3
            self.obs_dim = len(OP_ENTRIES)

        def action_tau_scalar(self, a):
            return super().action_tau_scalar(a[:1])

        def output_scalar(self, q, v, depths, a, aux, ids=None):
            _, reward, term, aux2, comps = super().output_scalar(q, v, depths, a[:1], aux, ids)
            env_id = ids[1] if ids is not None else torch.zeros_like(q[0]).to(torch.int32)
            vals = op_values(*op_inputs(a, torch), env_id, torch)
            obs = [torch.nan_to_num(vals[n].to(torch.float32), nan=NAN_OUT, posinf=POSINF_OUT,
                                    neginf=NEGINF_OUT) for n, _ in OP_ENTRIES]
            return obs, reward, term, aux2, comps

    return OpProbe
