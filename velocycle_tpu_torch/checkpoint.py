"""Training checkpoint and resume (port of `velocycle_tpu/checkpoint.py`).

The full SVI state (`infer.svi.SVIState`: the step, the unconstrained
params, the ClippedAdam state ``{count, m, v}`` and the integer key) goes
into one ``.npz`` of named leaves, in a fixed order::

    step, key, opt/count, params/<name>..., opt/m/<name>..., opt/v/<name>...

with the names in the order of the state's params.  A step's guide noise
depends only on ``state.key`` (`SVI.update` folds it), so restoring at
step k and taking N - k updates gives N uninterrupted updates bit for bit.

Usage::

    ckpt = Checkpointer("/path/run1")
    ckpt.save(step, state)                  # during the fit
    state = ckpt.restore(state_like=state)  # resume

The JAX package saves through orbax when it imports; this package has
the ``.npz`` backend only.  Container CSVs (Cycle/Phases/AngularSpeed
``.save``/``.load``) stay the interchange format for fitted results.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .infer.svi import SVIState

__all__ = ["Checkpointer", "save_state", "load_state"]


def _leaves(state):
    """(name, host array) of every leaf of ``state``, in the file's order."""
    out = [("step", np.int64(state.step)), ("key", np.int64(state.key)),
           ("opt/count", np.int64(state.opt_state["count"]))]
    for group, tensors in (("params", state.params),
                           ("opt/m", state.opt_state["m"]),
                           ("opt/v", state.opt_state["v"])):
        out += [(f"{group}/{name}", t.detach().cpu().numpy())
                for name, t in tensors.items()]
    return out


def save_state(path, state):
    """`SVIState` -> one ``.npz`` (host-side, synchronous)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **dict(_leaves(state)))


def load_state(path, state_like):
    """The state saved at ``path``, shaped as ``state_like``: each tensor on
    ``state_like``'s device with its dtype, the params as leaf tensors that
    require grad (`SVI.update` continues from them)."""
    data = np.load(path if path.endswith(".npz") else path + ".npz")

    def like(group, tensors, grad):
        out = {}
        for name, t in tensors.items():
            v = torch.as_tensor(data[f"{group}/{name}"], dtype=t.dtype,
                                device=t.device)
            out[name] = v.requires_grad_(True) if grad else v
        return out

    opt_like = state_like.opt_state
    return SVIState(
        step=int(data["step"]),
        params=like("params", state_like.params, True),
        opt_state={"count": int(data["opt/count"]),
                   "m": like("opt/m", opt_like["m"], False),
                   "v": like("opt/v", opt_like["v"], False)},
        key=int(data["key"]),
    )


class Checkpointer:
    """Checkpoints of one run under ``directory``, one ``ckpt_<step>.npz``
    each.

    Args:
      directory: checkpoint root.
      max_to_keep: accepted for the JAX package's callers; as its ``.npz``
        backend does, this one keeps every checkpoint.
      use_orbax: ``None`` or False: the ``.npz`` backend.  True raises: this
        package has no orbax backend.
    """

    def __init__(self, directory, max_to_keep=3, use_orbax=None):
        if use_orbax:
            raise ValueError(
                "velocycle_tpu_torch checkpoints through its .npz backend "
                "only; pass use_orbax=None or False")
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.use_orbax = False

    def _path(self, step):
        return os.path.join(self.directory, f"ckpt_{int(step)}.npz")

    def save(self, step, state):
        save_state(self._path(step), state)

    def latest_step(self):
        steps = [
            int(f[5:-4])
            for f in os.listdir(self.directory)
            if f.startswith("ckpt_") and f.endswith(".npz")
        ]
        return max(steps) if steps else None

    def restore(self, state_like, step=None):
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        return load_state(self._path(step), state_like)
