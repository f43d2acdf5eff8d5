"""X-strips of the FEM grids on sharded state, and their halos.

The design vector of a FEM model is sharded in contiguous chunks
(`sharding.shard_tree`), and its element grid is x-major, so rank r's
chunk is the element rows ``[r·m, (r+1)·m)`` with ``m = nex / P``.  Rank r
keeps the node rows of the same range and one ghost row, ``(r+1)·m``: its
nodal vectors hold ``m + 1`` node rows.  The last rank owns its last row;
every other rank's last row is owned by the next rank.  Nodal vectors stay
consistent: a ghost row always holds its owner's value.

The JAX package lets GSPMD turn the stencils' slices and pads into these
exchanges; the port runs them explicitly on local tensors (inside
``local_map``) with ``torch.distributed`` point-to-point calls:

- `halo_add`: after a local scatter, each node row that two ranks share
  holds a partial sum on both; one exchange with each neighbour adds the
  other side's part on both ranks (``a + b`` on one, ``b + a`` on the
  other, equal in floating point), so the shared row comes out whole and
  consistent in one round: a reverse halo add and a halo exchange at once;
- `wrap_rows`: the element rows before and after the strip, periodic in x
  (the filter's ``torch.roll``), the last rank and rank 0 neighbours across
  the wrap; its adjoint sends the gradients of those rows back and adds
  them there;
- `allreduce`: the owned rows' partial dots summed over the ranks;
- `gather_rows`: a coarse multigrid level's strips gathered whole on every
  rank (the V-cycle's gather point).

Each is a ``torch.library.custom_op`` with a vmap rule (the eigensolve's
CG runs vmapped over columns); the two a gradient passes through (the
filter's wrap, the all-reduce) go through ``torch.autograd.Function``s
that ``torch.func`` accepts.  On one rank there is no neighbour: the
wrappers return their input, and the models take their plain code.
Every exchange is recorded (`record`) for `worker.CollectiveBytes`.
"""

from __future__ import annotations

import functools
from typing import List

import torch

__all__ = ["Strips", "halo_add", "wrap_rows", "allreduce", "gather_rows",
           "owned_dot", "RECORDERS", "strip_evaluations", "run_on_strips"]

# every recorder in this list gets (helper, elements per peer, peers) of
# each exchange (`worker.CollectiveBytes` enters itself here)
RECORDERS: List = []


def record(kind: str, elements: int, peers: int) -> None:
    for r in RECORDERS:
        r.add(kind, elements, peers)


class Strips:
    """The x-strip layout of ``nex`` element rows over the ranks of a
    device mesh, seen from this rank.  The mesh must span the whole
    process group, and its ranks in order (the flattened mesh, the order
    of a ``Shard(0)`` design vector's chunks) must divide ``nex``: a strip
    is whole element rows, so uneven strips are refused (GSPMD pads them;
    ROADMAP queue 3)."""

    def __init__(self, mesh, nex: int, what: str = "the model"):
        import torch.distributed as dist
        ranks = [int(r) for r in mesh.mesh.flatten().tolist()]
        if sorted(ranks) != list(range(dist.get_world_size())):
            raise ValueError(f"{what} on sharded state needs a mesh over "
                             f"every rank of the process group: the mesh "
                             f"holds ranks {ranks}")
        P = len(ranks)
        if nex % P:
            raise ValueError(
                f"{what} on sharded state needs the {P} ranks of the mesh "
                f"to divide nex = {nex}: each rank holds whole element "
                f"rows of the x-strips (uneven strips are not supported)")
        self.P = P
        self.index = ranks.index(dist.get_rank())
        self.m = nex // P
        self.nex = nex
        self.row0 = self.index * self.m
        self.last = self.index == P - 1
        # the strip's neighbours (-1: none), and across the periodic wrap
        self.left = ranks[self.index - 1] if self.index > 0 else -1
        self.right = ranks[self.index + 1] if not self.last else -1
        self.wrap_left = ranks[(self.index - 1) % P]
        self.wrap_right = ranks[(self.index + 1) % P]

    def level(self, nex_l: int) -> "Strips":
        """The same ranks' strips of a coarser grid of ``nex_l`` element
        rows (``P`` must divide it)."""
        out = object.__new__(Strips)
        out.__dict__.update(self.__dict__)
        out.nex, out.m = nex_l, nex_l // self.P
        out.row0 = self.index * out.m
        return out

    def owned(self, t: torch.Tensor, axis: int) -> torch.Tensor:
        """The rows of ``t`` along ``axis`` this rank owns: all but the
        ghost row, which the last rank owns."""
        if self.last:
            return t
        return t.narrow(axis, 0, t.shape[axis] - 1)

    def owned_flat(self, t: torch.Tensor) -> torch.Tensor:
        """The owned prefix of a flat node-major strip vector [..., (m+1)
        · row]."""
        if self.last:
            return t
        n = t.shape[-1]
        return t.narrow(-1, 0, n - n // (self.m + 1))

    def node_rows(self, t: torch.Tensor, row: int, axis: int = 0):
        """This rank's strip (its m + 1 node rows) of a whole node-major
        flat array along ``axis``, ``row`` entries per node row."""
        return t.narrow(axis, self.row0 * row, (self.m + 1) * row)

    def zero_ghost(self, t: torch.Tensor, axis: int) -> torch.Tensor:
        """``t`` with its ghost row zeroed (the last rank's is its own):
        a sum over node rows then counts each shared row once."""
        if self.last:
            return t
        keep = torch.ones(t.shape[axis], dtype=t.dtype, device=t.device)
        keep[-1] = 0.0
        shape = [1] * t.dim()
        shape[axis] = -1
        return t * keep.reshape(shape)


def halo_add(t: torch.Tensor, axis: int, s: Strips) -> torch.Tensor:
    """``t`` (node rows along ``axis``, a negative axis) with each row it
    shares with a neighbour summed over both ranks."""
    if s.P == 1:
        return t
    return torch.ops.paropt.halo_add(t, axis, s.left, s.right)


def wrap_rows(t: torch.Tensor, axis: int, s: Strips) -> torch.Tensor:
    """``t`` (element rows along ``axis``) with the periodic neighbours'
    adjacent rows on either side: [row before; t; row after].  For two
    ranks or more (one rank rolls its own grid)."""
    return _WrapRows.apply(t, axis, s.wrap_left, s.wrap_right)


def allreduce(t: torch.Tensor, s: Strips) -> torch.Tensor:
    """The sum of ``t`` over the ranks (a small tensor: a dot's partial
    sums), identical on every rank."""
    if s.P == 1:
        return t
    return _AllReduce.apply(t)


def owned_dot(a: torch.Tensor, b: torch.Tensor, axis: int,
              s: Strips) -> torch.Tensor:
    """<a, b> over the whole grid: the owned rows' sum, all-reduced."""
    return allreduce(torch.sum(s.owned(a, axis) * s.owned(b, axis)), s)


def gather_rows(t: torch.Tensor, axis: int, s: Strips,
                ghost: bool = True) -> torch.Tensor:
    """The strips' rows along ``axis`` gathered whole on every rank: node
    rows of a consistent strip (``ghost``: each but the last rank's last
    row dropped) or element rows (no ghost row)."""
    if s.P == 1:
        return t
    return torch.ops.paropt.gather_rows(t, axis, s.P, ghost)


# ---------------------------------------------------------------------------
# the exchanges, as custom ops (vmap and autograd rules below)
# ---------------------------------------------------------------------------


def _exchange(sends, recvs) -> None:
    """One round of point-to-point messages: ``sends`` and ``recvs`` are
    (tensor, peer, tag) in an order both sides of every pair share."""
    import torch.distributed as dist
    ops = [dist.P2POp(dist.isend, t, peer, tag=tag) for t, peer, tag in sends]
    ops += [dist.P2POp(dist.irecv, t, peer, tag=tag)
            for t, peer, tag in recvs]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


def _row(t, axis, i):
    return t.select(axis, i).contiguous()


@torch.library.custom_op("paropt::halo_add", mutates_args=())
def _halo_add(t: torch.Tensor, axis: int, left: int,
              right: int) -> torch.Tensor:
    out = t.clone()
    sends, recvs, adds = [], [], []
    if right >= 0:
        sends.append((_row(t, axis, -1), right, 1))
    if left >= 0:
        sends.append((_row(t, axis, 0), left, 2))
    for i, peer, tag in ((0, left, 1), (-1, right, 2)):
        if peer >= 0:
            buf = torch.empty_like(sends[0][0])
            recvs.append((buf, peer, tag))
            adds.append((i, buf))
    _exchange(sends, recvs)
    for i, buf in adds:
        out.select(axis, i).add_(buf)
    record("halo_add", sends[0][0].numel() if sends else 0, len(sends))
    return out


@_halo_add.register_fake
def _(t, axis, left, right):
    return torch.empty_like(t)


@torch.library.custom_op("paropt::wrap_rows", mutates_args=())
def _wrap_rows(t: torch.Tensor, axis: int, left: int,
               right: int) -> torch.Tensor:
    last, first = _row(t, axis, -1), _row(t, axis, 0)
    before, after = torch.empty_like(last), torch.empty_like(first)
    _exchange([(last, right, 3), (first, left, 4)],
              [(before, left, 3), (after, right, 4)])
    record("wrap_rows", last.numel(), 2)
    return torch.cat([before.unsqueeze(axis), t, after.unsqueeze(axis)],
                     dim=axis)


@_wrap_rows.register_fake
def _(t, axis, left, right):
    shape = list(t.shape)
    shape[axis] += 2
    return t.new_empty(shape)


@torch.library.custom_op("paropt::wrap_rows_t", mutates_args=())
def _wrap_rows_t(g: torch.Tensor, axis: int, left: int,
                 right: int) -> torch.Tensor:
    """The adjoint of wrap_rows: the gradients of the borrowed rows go
    back to their owners and are added there."""
    n = g.shape[axis] - 2
    out = g.narrow(axis, 1, n).clone()
    before, after = _row(g, axis, 0), _row(g, axis, -1)
    to_last, to_first = torch.empty_like(before), torch.empty_like(after)
    _exchange([(before, left, 5), (after, right, 6)],
              [(to_last, right, 5), (to_first, left, 6)])
    out.select(axis, -1).add_(to_last)
    out.select(axis, 0).add_(to_first)
    record("wrap_rows_t", before.numel(), 2)
    return out


@_wrap_rows_t.register_fake
def _(g, axis, left, right):
    shape = list(g.shape)
    shape[axis] -= 2
    return g.new_empty(shape)


@torch.library.custom_op("paropt::allreduce_sum", mutates_args=())
def _allreduce_sum(t: torch.Tensor) -> torch.Tensor:
    import torch.distributed as dist
    out = t.clone()
    dist.all_reduce(out)
    record("allreduce", out.numel(), 1)
    return out


@_allreduce_sum.register_fake
def _(t):
    return torch.empty_like(t)


@torch.library.custom_op("paropt::gather_rows", mutates_args=())
def _gather_rows(t: torch.Tensor, axis: int, P: int,
                 ghost: bool) -> torch.Tensor:
    import torch.distributed as dist
    t = t.contiguous()
    buf = t.new_empty((P * t.shape[0],) + tuple(t.shape[1:]))
    # all_gather_single replaces all_gather_into_tensor in newer releases
    gather = (getattr(dist, "all_gather_single", None)
              or dist.all_gather_into_tensor)
    gather(buf, t)
    buf = buf.view((P,) + tuple(t.shape))
    record("gather_rows", t.numel(), P - 1)
    m = t.shape[axis] - int(ghost)
    parts = [buf[i].narrow(axis, 0, m) for i in range(P - 1)] + [buf[-1]]
    return torch.cat(parts, dim=axis)


@_gather_rows.register_fake
def _(t, axis, P, ghost):
    shape = list(t.shape)
    shape[axis] = P * (shape[axis] - int(ghost)) + int(ghost)
    return t.new_empty(shape)


class _WrapRows(torch.autograd.Function):
    """`wrap_rows` with its adjoint as the backward, in the form the
    ``torch.func`` transforms accept (the filter's vjp runs under them)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(t, axis, left, right):
        return torch.ops.paropt.wrap_rows(t, axis, left, right)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.args = inputs[1:]

    @staticmethod
    def backward(ctx, g):
        return (_WrapRowsT.apply(g, *ctx.args), None, None, None)


class _WrapRowsT(torch.autograd.Function):
    """The adjoint of `_WrapRows`, whose backward is `_WrapRows`."""

    generate_vmap_rule = True

    @staticmethod
    def forward(g, axis, left, right):
        return torch.ops.paropt.wrap_rows_t(g, axis, left, right)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.args = inputs[1:]

    @staticmethod
    def backward(ctx, g):
        return (_WrapRows.apply(g, *ctx.args), None, None, None)


class _AllReduce(torch.autograd.Function):
    """The all-reduce of a partial sum; its backward is the identity, since
    every rank's loss is the same total and d total / d part = 1."""

    generate_vmap_rule = True

    @staticmethod
    def forward(t):
        return torch.ops.paropt.allreduce_sum(t)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return g


def _front(x, bdim):
    return x if bdim is None else x.movedim(bdim, 0)


@torch.library.register_vmap("paropt::halo_add")
def _(info, in_dims, t, axis, left, right):
    return torch.ops.paropt.halo_add(_front(t, in_dims[0]), axis, left,
                                     right), 0


@torch.library.register_vmap("paropt::wrap_rows")
def _(info, in_dims, t, axis, left, right):
    return torch.ops.paropt.wrap_rows(_front(t, in_dims[0]), axis, left,
                                      right), 0


@torch.library.register_vmap("paropt::wrap_rows_t")
def _(info, in_dims, g, axis, left, right):
    return torch.ops.paropt.wrap_rows_t(_front(g, in_dims[0]), axis, left,
                                        right), 0


@torch.library.register_vmap("paropt::allreduce_sum")
def _(info, in_dims, t):
    return torch.ops.paropt.allreduce_sum(_front(t, in_dims[0])), 0


@torch.library.register_vmap("paropt::gather_rows")
def _(info, in_dims, t, axis, P, ghost):
    return torch.ops.paropt.gather_rows(_front(t, in_dims[0]), axis, P,
                                        ghost), 0


# ---------------------------------------------------------------------------
# a model's evaluations on its x-strips (the counterpart of shard_map)
# ---------------------------------------------------------------------------

# the evaluations of the Problem surface that run on strips, with their
# outputs' placements: r replicated, d a design vector's (Shard(0)), w a
# [k, n] stack's (Shard(1))
EVALUATIONS = {"objective": "r", "constraints": "r", "eval_obj_con": "rr",
               "eval_obj_con_gradient": "dw", "eval_full": "rrdwrrwr"}


def strip_evaluations(cls):
    """Class decorator of a FEM model: each evaluation in `EVALUATIONS`
    that the class has, given a sharded design vector, runs on this
    rank's x-strip (`run_on_strips`)."""
    for name in EVALUATIONS:
        fn = getattr(cls, name, None)
        if fn is not None and not getattr(fn, "on_strips", False):
            setattr(cls, name, _on_strips(name, fn))
    return cls


def _on_strips(name, fn):
    @functools.wraps(fn)
    def run(self, x, *args):
        from .sharding import is_sharded
        if not is_sharded(x):
            return fn(self, x, *args)
        return run_on_strips(self, name, x, *args)
    run.on_strips = True
    return run


def run_on_strips(model, name, x, *args):
    """``model.name(x, *args)`` for a DTensor ``x``: under ``local_map``,
    the model's strip view (``model._strip_view(mesh)``, built once per
    mesh: the same model on this rank's x-strip, its halos and reductions
    explicit) evaluates on the local chunk of x, and the outputs come back
    as DTensors placed as `EVALUATIONS` says.  Other DTensor arguments (a
    warm-start basis) are replicated and passed as local copies."""
    from torch.distributed.tensor.experimental import local_map
    from .sharding import (design_sharding, is_sharded, replicated_sharding,
                           row_sharding)
    mesh = x.device_mesh
    views = model.__dict__.setdefault("_strip_views", {})
    view = views.get(mesh)
    if view is None:
        view = views[mesh] = model._strip_view(mesh)
    rep = replicated_sharding(mesh)
    place = {"r": rep, "d": design_sharding(mesh), "w": row_sharding(mesh)}
    if list(x.placements) != place["d"]:
        x = x.redistribute(mesh, place["d"])
    args = [a.redistribute(mesh, rep) if is_sharded(a) else a for a in args]
    outs = tuple(place[c] for c in EVALUATIONS[name])

    def body(xl, *al):
        # every tensor here is a local one: a solver's DTensor mode
        # (`sharding.spmd`) has nothing to do, and would only add its
        # dispatch to each op of the strip's CG
        with torch._C.DisableTorchFunction():
            return getattr(view, name)(xl, *al)

    return local_map(body, out_placements=outs if len(outs) > 1
                     else outs[0], device_mesh=mesh)(x, *args)
