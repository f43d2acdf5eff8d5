"""Device meshes and the placement of solver state on them (counterpart of
paropt_tpu/parallel/sharding.py).

The reference distributes the design vector in 1-D blocks over MPI ranks
(`ParOptVec.{h,cpp}`).  The JAX package shards the design axis ``n`` over a
mesh axis named ``"d"`` with a `NamedSharding` and lets GSPMD insert the
collectives.  The port's counterpart is a
``torch.distributed.tensor.DTensor`` over a ``DeviceMesh``: every rank runs
the same solver code on global-shaped tensors, and a reduction over a
sharded axis comes out ``Partial`` and takes one all-reduce.

=====================  =====================================
JAX                    port
=====================  =====================================
``P("d")``             ``[Shard(0)]`` (`design_sharding`)
``P(None, "d")``       ``[Shard(1)]`` (`row_sharding`)
``P()``                ``[Replicate()]``
``P(("host", "d"))``   ``[Shard(0), Shard(0)]`` on the 2-D
                       ("host", "d") mesh
=====================  =====================================

`shard_tree` places a whole state by the JAX tests' rule: a leaf whose last
axis has length n is sharded on that axis, every other leaf (the
nwcon-sized state and the sparse Jacobian's values included) is
replicated.  Host branches read replicated scalars only, so every rank
branches alike.

A sharded solve runs with PyTorch's implicit replication on (`spmd`):
a plain tensor that meets a DTensor counts as replicated, as a JAX array
without a sharding does under ``jit``.

The FEM and frequency models do not run their stencils and multigrid on
DTensors: their evaluations take each rank's x-strip of the mesh under
``local_map``, with explicit halo exchanges (`halo`), where GSPMD derives
the exchanges itself.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import threading
import warnings
from typing import Optional

import torch

from . import collectives

__all__ = ["DESIGN_AXIS", "HOST_AXIS", "init_distributed", "design_mesh",
           "hybrid_design_mesh", "design_sharding", "row_sharding",
           "replicated_sharding", "shard_design", "replicate", "shard_tree",
           "place_like", "shard_like", "is_sharded", "tree_is_sharded",
           "mesh_size", "spmd", "settle"]

# Name of the mesh axis over which design-dimension arrays are sharded.
DESIGN_AXIS = "d"
# Outer (cross-host) mesh axis of the hybrid multi-host mesh.
HOST_AXIS = "host"


def _dist_ok() -> bool:
    return torch.distributed.is_available()


def is_sharded(t) -> bool:
    """True for a DTensor (state distributed over a device mesh), also
    seen through ``torch.func``'s wrappers."""
    if not _dist_ok():
        return False
    from torch.distributed.tensor import DTensor
    func = torch._C._functorch
    while (isinstance(t, torch.Tensor)
           and func.is_functorch_wrapped_tensor(t)):
        t = func.get_unwrapped(t)
    return isinstance(t, DTensor)


def init_distributed(backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> None:
    """Join the process group, the counterpart of ``MPI_Init``: every rank
    runs the same program.

    The arguments default to torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``); ``init_method`` may
    be a ``file://`` or ``tcp://`` address instead.  ``backend`` None takes
    NCCL when a card is present and gloo on the CPU.  With a card, the rank
    is bound to ``cuda:LOCAL_RANK`` (modulo the cards).  A no-op when a
    group already exists."""
    import torch.distributed as dist
    if dist.is_initialized():
        return
    cuda = torch.cuda.is_available()
    if backend is None:
        backend = "nccl" if cuda else "gloo"
    if rank is None and "RANK" in os.environ:
        rank = int(os.environ["RANK"])
    if world_size is None and "WORLD_SIZE" in os.environ:
        world_size = int(os.environ["WORLD_SIZE"])
    if init_method is None:
        init_method = "env://"
    if cuda:
        # more ranks than cards share them round robin
        local = int(os.environ.get("LOCAL_RANK", rank or 0))
        torch.cuda.set_device(local % torch.cuda.device_count())
    kwargs = {}
    if rank is not None:
        kwargs.update(rank=rank, world_size=world_size)
    dist.init_process_group(backend, init_method=init_method, **kwargs)


def design_mesh(device_type: str = "cuda",
                n_devices: Optional[int] = None):
    """A 1-D ("d",) mesh over the group's ranks (default: all of them)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    n = dist.get_world_size() if n_devices is None else int(n_devices)
    return DeviceMesh(device_type, torch.arange(n),
                      mesh_dim_names=(DESIGN_AXIS,))


def hybrid_design_mesh(n_hosts: Optional[int] = None,
                       local_devices: Optional[int] = None,
                       device_type: str = "cuda"):
    """The 2-D ("host", "d") mesh of a multi-host run: the outer axis
    crosses hosts, the inner axis stays among one host's cards (row h of
    the mesh is ranks h·local .. h·local + local − 1, torchrun's order).
    Design arrays shard over both axes, so each rank owns one contiguous
    block of the design vector and an all-reduce can ride the fast links
    within a host first.  ``local_devices`` defaults to torchrun's
    ``LOCAL_WORLD_SIZE``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    world = dist.get_world_size()
    if local_devices is None:
        local_devices = (world // n_hosts if n_hosts else
                         int(os.environ.get("LOCAL_WORLD_SIZE", world)))
    if n_hosts is None:
        n_hosts = world // local_devices
    if n_hosts * local_devices != world:
        raise ValueError(f"a {n_hosts} x {local_devices} mesh does not "
                         f"cover the {world} ranks")
    return DeviceMesh(device_type,
                      torch.arange(world).reshape(n_hosts, local_devices),
                      mesh_dim_names=(HOST_AXIS, DESIGN_AXIS))


def mesh_size(t) -> int:
    """Ranks of a DTensor's mesh (1 for a plain tensor)."""
    return t.device_mesh.size() if is_sharded(t) else 1


def design_sharding(mesh):
    """Placements of a [n] design array: sharded over every mesh axis."""
    if mesh is None:
        return None
    from torch.distributed.tensor import Shard
    return [Shard(0)] * mesh.ndim


def row_sharding(mesh):
    """Placements of a [k, n] stack of design vectors: axis 1 sharded."""
    if mesh is None:
        return None
    from torch.distributed.tensor import Shard
    return [Shard(1)] * mesh.ndim


def replicated_sharding(mesh):
    if mesh is None:
        return None
    from torch.distributed.tensor import Replicate
    return [Replicate()] * mesh.ndim


def _place(x: torch.Tensor, mesh, placements):
    from torch.distributed.tensor import distribute_tensor
    if is_sharded(x):
        return x.redistribute(mesh, placements)
    return distribute_tensor(x.detach().to(mesh.device_type), mesh,
                             placements)


def place_like(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``t`` (plain, the whole array on every rank) placed on ``ref``'s
    mesh with ``ref``'s placements."""
    return _place(t, ref.device_mesh, ref.placements)


def shard_like(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``t``, whose last axis is design-sized, sharded on that axis over
    the mesh of the sharded design vector ``x`` (a replicated ``t`` is cut
    locally, with no communication)."""
    from torch.distributed.tensor import Shard
    return _place(t, x.device_mesh, [Shard(t.dim() - 1)] * x.device_mesh.ndim)


def shard_design(x: torch.Tensor, mesh) -> torch.Tensor:
    """A design array in 1-D blocks: [n] on axis 0, a [k, n] stack on
    axis 1."""
    if mesh is None:
        return x
    return _place(x, mesh, design_sharding(mesh) if x.dim() == 1
                  else row_sharding(mesh))


def replicate(x: torch.Tensor, mesh) -> torch.Tensor:
    if mesh is None:
        return x
    return _place(x, mesh, replicated_sharding(mesh))


def _tree_map(fn, tree):
    """``fn`` on every tensor of a tree of dataclasses (their static fields
    kept), NamedTuples, tuples, lists and dicts; other leaves pass."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        out = {f.name: _tree_map(fn, getattr(tree, f.name))
               for f in dataclasses.fields(tree)
               if not f.metadata.get("static")}
        return dataclasses.replace(tree, **out)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, a) for a in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, a) for a in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return tree


def _leaves(tree):
    out = []
    _tree_map(lambda t: out.append(t) or t, tree)
    return out


def shard_tree(tree, mesh, n: int):
    """Place every tensor of a state: a leaf whose last axis is n is
    sharded on that axis (`shard_design`), every other leaf replicated.
    Walks the port's state dataclasses, NamedTuples, tuples and dicts."""
    if mesh is None:
        return tree

    def place(leaf):
        if leaf.dim() >= 1 and leaf.shape[-1] == n:
            from torch.distributed.tensor import Shard
            return _place(leaf, mesh, [Shard(leaf.dim() - 1)] * mesh.ndim)
        return _place(leaf, mesh, replicated_sharding(mesh))

    return _tree_map(place, tree)


def tree_is_sharded(*trees) -> bool:
    """True when some tensor of the trees is a DTensor."""
    if not _dist_ok():
        return False
    return any(is_sharded(t) for tree in trees for t in _leaves(tree))


class _SettleReductions:
    """A ``TorchFunctionMode`` (built on first use) that all-reduces every
    pending sum a torch function returns (`settle`), so no ``Partial``
    DTensor outlives the reduction that made it.  A partial sum combined
    with a Python scalar is not safe in DTensor: ``count + 2.0`` on a
    Partial(sum) count was seen to add 2.0 on every rank and so P times.

    An op for which this PyTorch's DTensor has no sharding rule (older
    releases lack some: ``linalg_inv_ex`` in 2.11) runs on the ranks'
    local copies when every DTensor operand is replicated (`_on_replicas`),
    which is what a replicate-only rule would do; on a sharded operand
    the error stands."""

    mode = None

    @classmethod
    def make(cls):
        if cls.mode is None:
            from torch.overrides import TorchFunctionMode

            class Mode(TorchFunctionMode):
                def __torch_function__(self, func, types, args=(),
                                       kwargs=None):
                    kwargs = kwargs or {}
                    try:
                        out = func(*args, **kwargs)
                    except NotImplementedError as exc:
                        out = _on_replicas(func, args, kwargs, exc)
                    return settle(out)

            cls.mode = Mode
        return cls.mode()


def _on_replicas(func, args, kwargs, exc):
    """``func`` on the local copies of replicated DTensor operands, its
    tensor results replicated on their mesh; re-raises ``exc`` when an
    operand is sharded or the error is not a missing sharding rule."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.utils import _pytree as pt
    if "sharding strategy" not in str(exc):
        raise exc
    flat, spec = pt.tree_flatten((args, kwargs))
    dts = [settle(a) for a in flat if isinstance(a, DTensor)]
    if not dts or not all(
            all(isinstance(p, Replicate) for p in t.placements)
            and t.device_mesh == dts[0].device_mesh for t in dts):
        raise exc
    mesh = dts[0].device_mesh
    local = [settle(a).to_local() if isinstance(a, DTensor) else a
             for a in flat]
    a2, k2 = pt.tree_unflatten(local, spec)
    out = func(*a2, **k2)
    rep = [Replicate()] * mesh.ndim
    return pt.tree_map(
        lambda t: DTensor.from_local(t, mesh, rep, run_check=False)
        if isinstance(t, torch.Tensor) else t, out)


def spmd(fn=None, *, probe=None):
    """Decorator of a solver entry point that may see sharded state.

    The call runs with PyTorch's implicit replication on, so a plain
    tensor that meets a DTensor counts as replicated, as a JAX array
    without a sharding does under ``jit``.  When its arguments (or
    ``probe(*args)``, e.g. a solver's own state) hold a DTensor, every
    reduction's result is also all-reduced at once (`_SettleReductions`),
    and the collectives the call issues are counted (`collectives`).
    Nested entry points enter each context once; a call on plain tensors
    pays one walk of its arguments."""
    if fn is None:
        return functools.partial(spmd, probe=probe)

    @functools.wraps(fn)
    def run(*args, **kwargs):
        if not _dist_ok():
            return fn(*args, **kwargs)
        with contextlib.ExitStack() as stack:
            if not getattr(_SPMD, "implicit", False):
                from torch.distributed.tensor.experimental import \
                    implicit_replication
                stack.enter_context(implicit_replication())
                _SPMD.implicit = True
                stack.callback(setattr, _SPMD, "implicit", False)
            if not getattr(_SPMD, "settle", False) and tree_is_sharded(
                    args, kwargs, probe(*args) if probe else None):
                stack.enter_context(_SettleReductions.make())
                stack.enter_context(collectives.counting())
                # an ncon = 1 array meeting a DTensor is replicated on
                # purpose; DTensor warns about each such [1] tensor
                stack.enter_context(warnings.catch_warnings())
                warnings.filterwarnings(
                    "ignore", message="Found a non-scalar tensor with numel=1")
                _SPMD.settle = True
                stack.callback(setattr, _SPMD, "settle", False)
            return fn(*args, **kwargs)
    return run


_SPMD = threading.local()


def settle(tree):
    """Every DTensor that holds a pending sum (``Partial``) all-reduced to
    ``Replicate``, so a stored state keeps the placement rule of
    `shard_tree` and a host read sees the whole value."""
    if not _dist_ok():
        return tree
    from torch.distributed.tensor import DTensor, Partial, Replicate

    def fix(t):
        if isinstance(t, DTensor) and any(isinstance(p, Partial)
                                          for p in t.placements):
            return t.redistribute(t.device_mesh, [
                Replicate() if isinstance(p, Partial) else p
                for p in t.placements])
        return t

    if isinstance(tree, torch.Tensor):
        return fix(tree)
    return _tree_map(fix, tree) if tree_is_sharded(tree) else tree
