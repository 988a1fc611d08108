"""State and data carried over from the JAX package, as numpy.

The JAX package's `StageQP` and `ControllerState`, and the examples' rollout
and env carries, are trees of arrays. A caller turns their leaves into numpy
(`jax.tree.map(np.asarray, tree)`) and these functions build the port's
dataclasses from them, matching fields by name. This module takes numpy only
and never imports jax.
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch

from biped_pympc_tpu_torch.control.controller import ControllerState
from biped_pympc_tpu_torch.models.srbd import AffineDynamics
from biped_pympc_tpu_torch.ops.qp import StageQP


def _tensor(a, dtype, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.bool_:
        return torch.tensor(a, dtype=torch.bool, device=device)
    if np.issubdtype(a.dtype, np.integer):
        return torch.tensor(a, dtype=torch.int32, device=device)
    return torch.tensor(a, dtype=dtype, device=device)


def _from_tree(cls, tree, dtype, device):
    """Build dataclass `cls` from an object with same-named numpy fields."""
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        value = getattr(tree, f.name)
        if value is None:
            kwargs[f.name] = None
        elif dataclasses.is_dataclass(hints[f.name]):
            kwargs[f.name] = _from_tree(hints[f.name], value, dtype, device)
        else:
            kwargs[f.name] = _tensor(value, dtype, device)
    return cls(**kwargs)


def stage_qp_from_numpy(qp, dtype=torch.float64, device="cpu") -> StageQP:
    """A JAX `StageQP` with numpy leaves, batched (leading axis) or one env,
    as the port's batched `StageQP`."""
    batched = np.asarray(qp.d).ndim == 3
    t = lambda a: _tensor(a if batched else np.asarray(a)[None], dtype, device)
    return StageQP(q_diag=t(qp.q_diag), r_diag=t(qp.r_diag), f=t(qp.f),
                   dyn=AffineDynamics(t(qp.dyn.A), t(qp.dyn.B), t(qp.dyn.c)),
                   b0=t(qp.b0), g_u=t(qp.g_u), d=t(qp.d))


def controller_state_from_numpy(state, dtype=torch.float32, device="cpu") -> ControllerState:
    """A JAX `ControllerState` with numpy leaves as the port's
    `ControllerState`, the learned residual matrices (None or (B, 12, 12))
    included."""
    return _from_tree(ControllerState, state, dtype, device)


def rollout_carry_from_numpy(carry, dtype=torch.float32, device="cpu") -> tuple:
    """The JAX rollout's carry (state, x, foot_w) (`examples/tpu_rollout.py:190`)
    with numpy leaves as the port's (`examples/tpu_rollout.init_carry`)."""
    state, x, foot_w = carry
    return (controller_state_from_numpy(state, dtype, device), _tensor(x, dtype, device),
            _tensor(foot_w, dtype, device))


def env_carry_from_numpy(carry, dtype=torch.float32, device="cpu"):
    """The JAX device env's `EnvCarry` (`examples/rl_env_tpu.py:50`) with numpy
    leaves as the port's `examples.rl_env_tpu.EnvCarry`."""
    from biped_pympc_tpu_torch.examples.rl_env_tpu import EnvCarry

    return EnvCarry(*rollout_carry_from_numpy((carry.state, carry.x, carry.foot_w), dtype,
                                              device))
