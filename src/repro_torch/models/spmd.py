"""SPMD on ``torch.distributed``: the port's counterparts of
``jax.sharding.PartitionSpec``, ``NamedSharding`` and ``shard_map``.

* ``PartitionSpec`` (``P``) is a tuple with one entry per tensor dim: an
  axis name, a tuple of axis names, or None (replicated), as JAX's.
* ``to_placements(spec, mesh)`` gives DTensor's placements, one per mesh
  dim: ``Shard(i)`` where the spec names that mesh axis at tensor dim
  ``i``, ``Replicate()`` otherwise.  A dim sharded over two axes splits in
  the mesh's axis order (``("pod", "data")``: pod-major), as JAX splits
  ``P(("pod", "data"))``; a spec that names them in another order raises.
* ``place(t, spec, mesh)`` makes a DTensor of a tensor every rank holds
  whole, each rank keeping its own shard (no communication).
* ``region(mi, fn, args, in_specs, out_specs)`` is ``shard_map``, on
  torch's ``local_map``: each DTensor argument is redistributed to its
  spec, ``fn`` runs on the local tensors, and its outputs become DTensors
  again.  The hand-written kernels are opaque to DTensor, so the model
  calls them in such regions.
* ``psum(t, mi, axes)`` all-reduces a local tensor over mesh axes inside a
  region (``jax.lax.psum``).

Nothing here imports ``torch.distributed`` at module import: the port's
single-device paths never load it.
"""
from __future__ import annotations

from typing import Any, Callable, Sequence, Tuple


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``: one entry per tensor dim."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


P = PartitionSpec


class AbstractMesh:
    """A mesh of axis names and sizes only (``jax.sharding.AbstractMesh``):
    enough for the spec rules, with no process group behind it."""

    def __init__(self, shape: Sequence[int], names: Sequence[str]):
        self.shape = tuple(shape)
        self.mesh_dim_names = tuple(names)

    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape}, {self.mesh_dim_names})"


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes one spec entry names."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def to_placements(spec: Sequence, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh`` (``to_named``'s
    counterpart)."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    where = {}
    for i, entry in enumerate(spec):
        axes = spec_axes(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: a dim sharded over {axes} must name "
                             f"them in the mesh's order {names}")
        for a in axes:
            if a in where:
                raise ValueError(f"{spec}: axis {a!r} named twice")
            where[a] = i
    return tuple(Shard(where[n]) if n in where else Replicate()
                 for n in names)


def is_dtensor(x) -> bool:
    if not hasattr(x, "placements"):
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def local_shard(t, mesh, placements):
    """This rank's shard of ``t`` (held whole on every rank): mesh dims
    split in order, so two mesh dims on one tensor dim split it major
    first.  A view where it can be one."""
    from torch.distributed.tensor import Shard
    local = t
    coord = mesh.get_coordinate()
    for mdim, pl in enumerate(placements):
        if isinstance(pl, Shard):
            n = mesh.shape[mdim]
            if local.shape[pl.dim] % n:
                raise ValueError(f"dim {pl.dim} of {tuple(t.shape)} does "
                                 f"not divide over {n}")
            size = local.shape[pl.dim] // n
            local = local.narrow(pl.dim, coord[mdim] * size, size)
    return local


def place(t, spec, mesh):
    """A DTensor of ``t`` at ``spec``; every rank holds ``t`` whole and
    keeps its shard (contiguous; ``t``'s own storage where nothing
    splits), a leaf with no autograd history."""
    from torch.distributed.tensor import DTensor
    pl = to_placements(spec, mesh)
    local = local_shard(t.detach(), mesh, pl).contiguous()
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=t.shape, stride=t.stride())


def _placements(spec, mesh):
    if spec is None:
        return None
    if isinstance(spec, PartitionSpec):
        return to_placements(spec, mesh)
    return tuple(spec)               # placements given directly


def region(mi, fn: Callable, args: Sequence, in_specs: Sequence,
           out_specs):
    """``shard_map(fn, in_specs, out_specs)(*args)`` on ``mi.mesh``:
    torch's ``local_map``, with what it leaves to its caller.  An entry of
    ``in_specs`` is a ``P``, a tuple of placements, or None for an
    argument passed as it is (not a tensor, or None); a DTensor argument
    is redistributed to its spec first.  ``out_specs`` is one spec
    (``fn`` returns one tensor) or a list of them; an output whose spec
    is None is returned as it is (a None, or a cache ``fn`` wrote in
    place).  An input's gradient is Partial along each mesh dim where the
    input is replicated but an output is not (shard_map's rule: each
    shard's gradient is its part of the sum); ``local_map`` needs these
    given.  An argument already at its spec reaches ``fn`` as its own
    local tensor, so ``fn`` may write into it in place."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = mesh_of(mi)
    many = isinstance(out_specs, list)
    out_pls = [_placements(s, mesh)
               for s in (out_specs if many else [out_specs])]
    varies = [any(pl is not None and not isinstance(pl[i], Replicate)
                  for pl in out_pls) for i in range(len(mesh.shape))]
    mapped, in_pls = [], []          # local_map maps the DTensors only
    for i, (a, s) in enumerate(zip(args, in_specs)):
        pl = _placements(s, mesh)
        if pl is None or a is None:
            continue
        if not is_dtensor(a):
            raise TypeError(f"region: a {type(a).__name__} where a DTensor "
                            f"at {s} was expected")
        if tuple(a.placements) != pl:
            a = a.redistribute(mesh, pl)
        mapped.append((i, a))
        in_pls.append(pl)
    grad_pls = [tuple(Partial() if isinstance(x, Replicate) and v else x
                      for x, v in zip(pl, varies)) for pl in in_pls]
    kept = [j for j, pl in enumerate(out_pls) if pl is not None]
    as_is = {}

    def local(*xs):
        full_args = list(args)
        for (i, _), x in zip(mapped, xs):
            full_args[i] = x
        outs = fn(*full_args)
        outs = list(outs) if many else [outs]
        as_is.update((j, o) for j, o in enumerate(outs) if j not in kept)
        return tuple(outs[j] for j in kept)

    got = local_map(local, out_placements=tuple(out_pls[j] for j in kept),
                    in_placements=tuple(in_pls),
                    in_grad_placements=tuple(grad_pls),
                    device_mesh=mesh)(*[a for _, a in mapped])
    outs = [as_is.get(j) for j in range(len(out_pls))]
    for j, o in zip(kept, got):
        outs[j] = o
    return tuple(outs) if many else outs[0]


def partial_on(placements, mesh, axis, reduce_op: str = "sum") -> tuple:
    """``placements`` with mesh axis ``axis`` made Partial(``reduce_op``):
    a region's output whose shards along that axis are parts of a sum (or
    a max) still to be reduced.  ``axis`` None leaves them as they are."""
    if axis is None:
        return tuple(placements)
    from torch.distributed.tensor import Partial
    i = tuple(mesh.mesh_dim_names).index(axis)
    return tuple(placements[:i]) + (Partial(reduce_op),) + tuple(
        placements[i + 1:])


def mesh_of(mi):
    """The mesh of a MeshInfo, or a DeviceMesh itself."""
    return mi.mesh if hasattr(mi, "batch_axes") else mi


def matmul_placements(x, w):
    """Placements (x's, w's, the output's) of a Megatron product x @ w
    (x (..., K), w (K, N)) on w's mesh, one mesh dim at a time: where x's
    batch dim is sharded, w is gathered there (FSDP) and the output keeps
    the batch shard; else where w shards N (column parallel), x is
    replicated and the output shards N; where w shards K (row parallel),
    x shards K and the output is partial; where w is replicated, x keeps
    a shard of a leading dim or a partial sum, else is replicated."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    last = x.ndim - 1
    xs, ws, outs = [], [], []
    for xp, wp in zip(x.placements, w.placements):
        if isinstance(xp, Shard) and xp.dim < last:
            xs.append(xp), ws.append(Replicate()), outs.append(xp)
        elif isinstance(wp, Shard) and wp.dim == 1:
            xs.append(Replicate()), ws.append(wp), outs.append(Shard(last))
        elif isinstance(wp, Shard) and wp.dim == 0:
            xs.append(Shard(last)), ws.append(wp), outs.append(Partial())
        elif isinstance(xp, Partial):
            xs.append(xp), ws.append(Replicate()), outs.append(Partial())
        else:
            xs.append(Replicate()), ws.append(Replicate())
            outs.append(Replicate())
    return tuple(xs), tuple(ws), tuple(outs)


def psum(t, mi, axes: Sequence[str]):
    """Sum of the local ``t`` over the mesh ``axes`` (inside a region)."""
    import torch.distributed._functional_collectives as funcol
    names = tuple(mi.mesh.mesh_dim_names)
    for a in axes:
        t = funcol.all_reduce(t, "sum", (mi.mesh, names.index(a)))
    return funcol.wait_tensor(t) if hasattr(funcol, "wait_tensor") else t


def full(x) -> Any:
    """A DTensor's global value as a plain tensor (all-gathers), or x."""
    return x.full_tensor() if is_dtensor(x) else x
