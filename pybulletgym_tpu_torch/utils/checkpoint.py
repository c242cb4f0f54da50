"""Checkpoint/resume for env batches and training state: counterpart of
the JAX package's `utils/checkpoint.py`, in the same npz format.

A tree (an `EnvState`, a PPO `TrainState`, a SAC `SACState`, or any nest
of NamedTuples, dicts, lists and tuples) is flattened as `jax.tree.flatten`
flattens its JAX twin: NamedTuples in field order, dicts by sorted key,
lists and tuples in order. Tensors, numpy arrays and Python scalars are
leaves; so is a `torch.Generator`, which holds the port's random stream
where the JAX package keeps a key. An `nn.Module` contributes its
`state_dict()` entries, in its `leaves()` order where it has one
(`ActorCritic`). Leaf i is saved as `leaf_{i}`, so the JAX package's
`checkpoint.load` reads an `EnvState` or a PPO `TrainState` this module
wrote, and this module reads the JAX package's.

A generator's leaf is a JAX key's uint32[2]: the two words of its initial
seed, high word first (the seed `interop.sac_state_from_npz` makes of a
JAX key). Its exact place in the stream, the `get_state()` bytes, is saved
beside the leaves under `__torch_generator_{i}__`, which the JAX package
does not read. `load` restores the stream from those bytes, or, from a
JAX package's file, seeds the generator with the key's words.

The structure is recorded under `__torch_tree__` (JAX's `__treedef__` is a
string only JAX can make; `load` here ignores it).
"""

from __future__ import annotations

import copy
from typing import Any, List, Tuple

import numpy as np
import torch
from torch import nn

STRUCTURE_KEY = "__torch_tree__"
GENERATOR_KEY = "__torch_generator_{}__"


def _module_keys(module: nn.Module) -> List[str]:
    """A module's `state_dict()` keys in its `leaves()` order where it has
    one (`ActorCritic`: the JAX pytree's order), else in their own order."""
    if not hasattr(module, "leaves"):
        return list(module.state_dict())
    name = {id(t): k for k, t in module.state_dict(keep_vars=True).items()}
    return [name[id(t)] for t in module.leaves()]


def _flatten(tree) -> Tuple[List[Any], str]:
    """(leaves, structure string) of `tree`."""
    if isinstance(tree, torch.Generator):
        return [tree], "G"
    if isinstance(tree, (torch.Tensor, np.ndarray, np.generic, bool, int, float)):
        return [tree], "*"
    if isinstance(tree, nn.Module):
        keys = _module_keys(tree)
        sd = tree.state_dict()
        return [sd[k] for k in keys], f"{type(tree).__name__}<{','.join(keys)}>"
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        keys, children = tree._fields, list(tree)
        head, tail = f"{type(tree).__name__}(", ")"
    elif isinstance(tree, dict):
        keys = sorted(tree)
        children = [tree[k] for k in keys]
        head, tail = "{", "}"
    elif isinstance(tree, (list, tuple)):
        keys, children = [""] * len(tree), list(tree)
        head, tail = ("[", "]") if isinstance(tree, list) else ("(", ")")
    else:
        raise TypeError(f"cannot checkpoint a {type(tree).__name__}")
    leaves, parts = [], []
    for k, c in zip(keys, children):
        ls, s = _flatten(c)
        leaves += ls
        parts.append(f"{k}={s}" if k else s)
    return leaves, head + ",".join(parts) + tail


def _unflatten(like, leaves):
    """`like`'s structure with its leaves taken, in order, from the iterator
    `leaves`."""
    if isinstance(like, (torch.Generator, torch.Tensor, np.ndarray, np.generic, bool, int,
                         float)):
        return next(leaves)
    if isinstance(like, nn.Module):
        out = copy.deepcopy(like)
        out.load_state_dict({k: next(leaves) for k in _module_keys(like)})
        return out
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*[_unflatten(c, leaves) for c in like])
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    return type(like)(_unflatten(c, leaves) for c in like)


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Generator):
        seed = x.initial_seed()
        return np.array([seed >> 32, seed & 0xFFFFFFFF], np.uint32)
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save(path: str, tree: Any) -> None:
    """Save a tree (EnvState, TrainState, SACState, ...) to one .npz file."""
    leaves, structure = _flatten(tree)
    np.savez_compressed(
        path,
        **{STRUCTURE_KEY: np.frombuffer(structure.encode(), dtype=np.uint8)},
        **{f"leaf_{i}": _to_numpy(x) for i, x in enumerate(leaves)},
        **{GENERATOR_KEY.format(i): x.get_state().numpy() for i, x in enumerate(leaves)
           if isinstance(x, torch.Generator)},
    )


def _like(saved: np.ndarray, like, state=None):
    """A saved leaf as the template leaf's type, dtype and device; a
    generator from its saved `state` bytes, else seeded with the key's
    words."""
    if isinstance(like, torch.Generator):
        gen = torch.Generator(device=like.device)
        if state is None:
            gen.manual_seed((int(saved[0]) << 32) | int(saved[1]))
        else:
            gen.set_state(torch.from_numpy(state.astype(np.uint8)))
        return gen
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.array(saved)).to(like.dtype).to(like.device)
    if isinstance(like, (bool, int, float)):
        return type(like)(saved.item())
    return saved.astype(np.asarray(like).dtype)


def load(path: str, like: Any) -> Any:
    """Load a tree saved by `save` (or by the JAX package's `save`). `like`
    supplies the structure, and each leaf's dtype and device: a template on
    the GPU gives a state on the GPU. Raises ValueError where the file has
    fewer or more leaves than the template, a different structure, or a
    leaf of another shape."""
    leaves_like, structure = _flatten(like)
    n = len(leaves_like)
    with np.load(path) as data:
        missing = [i for i in range(n) if f"leaf_{i}" not in data]
        if missing:
            raise ValueError(
                f"checkpoint has fewer leaves than the template "
                f"(missing leaf_{missing[0]} of {n}) ({path})"
            )
        if f"leaf_{n}" in data:
            raise ValueError(f"checkpoint has more leaves than the template ({path})")
        if STRUCTURE_KEY in data:
            saved_structure = bytes(data[STRUCTURE_KEY]).decode()
            if saved_structure != structure:
                raise ValueError(
                    f"checkpoint tree structure differs from the template ({path}): "
                    f"saved {saved_structure[:120]}... != {structure[:120]}..."
                )
        saved = [data[f"leaf_{i}"] for i in range(n)]
        states = [data[GENERATOR_KEY.format(i)] if GENERATOR_KEY.format(i) in data else None
                  for i in range(n)]
    for i, (s, l) in enumerate(zip(saved, leaves_like)):
        shape = (2,) if isinstance(l, torch.Generator) else tuple(np.shape(l))
        if tuple(s.shape) != shape:
            raise ValueError(f"leaf {i}: checkpoint shape {s.shape} != template {shape} ({path})")
    return _unflatten(like, iter([_like(s, l, g) for s, l, g in zip(saved, leaves_like, states)]))
