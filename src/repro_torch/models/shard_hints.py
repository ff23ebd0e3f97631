"""Where model code learns the intra-pod layout
(``repro.models.shard_hints``).

The train and serve steps run the model inside
``activation_sharding(mesh)``: a rank of a ``launch.mesh.Mesh`` whose
``data`` or ``model`` axis spans more than one rank.  The model
functions read ``current_mesh()`` there and compute on the rank's
blocks: weights gathered over ``data`` before use (FSDP), heads, FFN
columns, experts and vocabulary split over ``model`` (tensor and expert
parallelism, ``launch.collectives``).  Outside the context
``current_mesh()`` is None and ``axis_env_size`` is 1, so the one-device
paths (the CPU tests, a mesh of pods alone) are untouched.
Nothing here reads an environment variable.

The reference also has ``hint(x, *axes)``, a ``with_sharding_constraint``
that tells GSPMD how to lay out a global array.  Eager PyTorch holds each
rank's block itself and has no layout to constrain, so the port has no
``hint``: the model code takes its local head count from
``axis_env_size("model")`` instead.

The context is a ``contextvars`` variable, which a thread does not
inherit: code that runs the model again on another thread (the
autograd engine's device thread recomputing a checkpointed cycle)
re-enters ``activation_sharding`` with the mesh it read in the forward
(``transformer.lm_apply``).
"""
from __future__ import annotations

import contextlib
import contextvars

_MESH: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_mesh", default=None)


@contextlib.contextmanager
def activation_sharding(mesh):
    """Model code inside sees ``mesh`` (a ``launch.mesh.Mesh``, or None:
    no layout) as ``current_mesh()``."""
    tok = _MESH.set(mesh)
    try:
        yield
    finally:
        _MESH.reset(tok)


def current_mesh():
    """The mesh of the active ``activation_sharding`` context, or None."""
    return _MESH.get()


def axis_env_size(name: str) -> int:
    """The size of mesh axis ``name`` under the active context, else 1:
    model code picks its shard-local sizes (a rank's query and KV heads)
    without importing the mesh."""
    mesh = current_mesh()
    return 1 if mesh is None else int(mesh.shape.get(name, 1))
