"""Partitioning context: activation sharding hints for model code (port
of ``repro.models.pctx``).

The model layer is mesh-agnostic; the distributed step builders install
a dict of ``distributed.sharding.NamedSharding`` (a mesh and a spec)
here.  Keys (the reference's, but for its "moe_dispatch" and
"moe_group_buf", which place buffers inside the MoE dispatch):
    moe_expert_in  (E, G, C, d) expert input buffers
    attn_q, attn_kv (B, S, H, D) post-projection activations
    activations    (B, S, d) residual-stream activations
    ffn_hidden(_2d), logits

A mesh step's blocks (attention, MLA, RG-LRU, SSD, the MLP, MoE, the
embedding) run on each rank's shards behind :func:`local_call` /
:func:`local_block`: no DTensor reaches a kernel's wrapper (they launch
on ``data_ptr()``).  So the hints are applied in two ways.  Between
blocks, :func:`constrain` redistributes a DTensor to its hint
("activations" at each block's input, the loss's hidden states and
"logits"); it is the identity on plain tensors and with no hints.
Inside a block the placements are set by the block's ``local_block``
specs, read from the hints with :func:`spec_of`: "activations" for the
batch rows, "attn_q" / "attn_kv" for the heads, "ffn_hidden(_2d)" for the
MLP's hidden width, "moe_expert_in" for the MoE groups and experts.  The
reference's ``constrain`` calls inside blocks (q, k, v, the attention
output, the MLP hidden, the MoE buffers) have no counterpart, since
nothing there is a DTensor.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, Optional

import torch

_SPECS: Dict[str, object] = {}


@contextmanager
def sharding_hints(specs: Optional[Dict[str, object]]):
    global _SPECS
    old = _SPECS
    _SPECS = dict(specs or {})
    try:
        yield
    finally:
        _SPECS = old


def is_dtensor(x) -> bool:
    """Whether `x` is a DTensor (without importing torch.distributed
    for a plain tensor's sake)."""
    if x is None or type(x).__name__ != "DTensor":
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def constrain(x, key: str):
    """`x` redistributed to the hint installed for `key`: the identity on
    a plain tensor, for a key with no hint, and at a rank-mismatched call
    site (a hint of more dimensions than `x` has)."""
    s = _SPECS.get(key)
    if s is None or not is_dtensor(x):
        return x
    if len(s.spec) > x.ndim:
        return x  # rank-mismatched call site (e.g. flattened tokens)
    want = s.placements
    if tuple(x.placements) == want:
        return x
    return x.redistribute(s.mesh, want)


def hint(key: str):
    return _SPECS.get(key)


def spec_of(key: str, ndim: int) -> tuple:
    """The installed hint's spec for `key`, padded with None to `ndim`
    entries (all None without a hint)."""
    s = _SPECS.get(key)
    spec = tuple(s.spec) if s is not None else ()
    return spec[:ndim] + (None,) * (ndim - len(spec))


def redistribute(x, spec):
    """DTensor `x` redistributed to `spec` on its own mesh."""
    from ..distributed.sharding import placements
    want = placements(spec, x.device_mesh)
    return x if tuple(x.placements) == want else \
        x.redistribute(x.device_mesh, want)


def local_call(fn, args, in_specs, out_specs, partial=()):
    """`fn` run on each rank's shards, the kernel boundary of a mesh step
    (``torch.distributed.tensor.experimental.local_map``): each DTensor
    of `args` is redistributed to its spec of `in_specs` and handed to
    `fn` as its local tensor (a plain tensor taken as replicated, None
    passed through);
    `fn`'s outputs are wrapped back as DTensors with `out_specs` (a list
    of specs for several outputs, or one spec), partial sums over the
    mesh axes named in `partial` (a tuple for every output, or a list of
    tuples, one an output).  No DTensor reaches `fn`, so a kernel there
    sees its local shapes and pointers.

    Gradients flow through: an input replicated along a mesh dimension
    over which the work is split (some input or output sharded along it)
    gets a partial gradient there (each rank's covers its shards only),
    which autograd then sums.  ``local_map`` takes those gradient
    placements as given; this is where they are worked out."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    from ..distributed.sharding import placements
    mesh = next(a.device_mesh for a in args if is_dtensor(a))
    args = [DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
            if isinstance(a, torch.Tensor) and not is_dtensor(a) else a
            for a in args]
    pin = [None if a is None else placements(sp, mesh)
           for a, sp in zip(args, in_specs)]
    single = not isinstance(out_specs, list)
    outs_specs = [out_specs] if single else out_specs
    parts = (partial if isinstance(partial, list)
             else [partial] * len(outs_specs))
    pout = []
    for sp, axes in zip(outs_specs, parts):
        part = {i for i, a in enumerate(mesh.mesh_dim_names) if a in axes}
        pout.append(tuple(Partial() if i in part else p for i, p in
                          enumerate(placements(sp, mesh))))
    split = {i for pl in pin + pout if pl
             for i, p in enumerate(pl) if isinstance(p, Shard)}
    pgrad = [pl and tuple(Partial() if i in split and isinstance(p, Replicate)
                          else p for i, p in enumerate(pl)) for pl in pin]
    # one output's placements as a list: a tuple there means several
    return local_map(fn, out_placements=list(pout[0]) if single
                     else tuple(pout),
                     in_placements=tuple(pin),
                     in_grad_placements=tuple(pgrad), device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def axes_of(entry) -> tuple:
    """A spec entry's mesh axes: () for None, one name, or a tuple."""
    return (entry,) if isinstance(entry, str) else tuple(entry or ())


def axes_rank(mesh, entry) -> int:
    """This rank's index along the mesh axes of spec entry `entry` (the
    first axis the slowest), as ``Shard`` numbers a dimension's pieces."""
    from ..distributed.sharding import axis_size
    r = 0
    for a in axes_of(entry):
        r = r * axis_size(mesh, a) + mesh.get_local_rank(a)
    return r


def _all_reduce(x, mesh, axis: str, op: str = "sum"):
    """Local tensor `x` reduced by `op` over the ranks of mesh axis
    `axis`."""
    import torch.distributed._functional_collectives as funcol
    return funcol.wait_tensor(funcol.all_reduce(
        x, op, (mesh, mesh.mesh_dim_names.index(axis))))


class _SumOverRanks(torch.autograd.Function):
    """The sum of a local tensor over the ranks of a mesh axis; its
    gradient passes through as it is, since every rank uses the sum alike
    and holds the whole gradient (Megatron's reduce from the
    tensor-parallel region)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _all_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def sum_over(x, mesh, axis: str):
    """`x` summed over the ranks of mesh axis `axis` (inside a
    ``local_call``), the gradient the identity."""
    return _SumOverRanks.apply(x, mesh, axis)


class _CopyOverRanks(torch.autograd.Function):
    """The identity on a local tensor alike on the ranks of a mesh axis,
    which each rank then uses on its own slice of the work; the gradients
    the ranks take are partial and are summed over the axis (Megatron's
    copy to the tensor-parallel region, the conjugate of
    ``_SumOverRanks``)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh, ctx.axis), None, None


def copy_over(x, mesh, axis: str):
    """`x` as it is (inside a ``local_call``), its gradient summed over
    the ranks of mesh axis `axis`."""
    return _CopyOverRanks.apply(x, mesh, axis)


def max_over(x, mesh, axis: str):
    """`x` (no gradient) maxed over the ranks of mesh axis `axis`."""
    return _all_reduce(x.detach(), mesh, axis, "max")


def heads_picker(mesh, entry, H: int, G: int, device):
    """For H query heads split over the mesh axes of `entry` and G kv
    heads left whole: a function that takes the kv heads (dimension 2 of
    a local (B, S, G, D) tensor) this rank's query heads read, one a head
    or a contiguous run that keeps the kernel's h // (H / G) mapping."""
    from ..distributed.sharding import axis_size
    hl = H // axis_size(mesh, axes_of(entry))
    r = axes_rank(mesh, entry)
    idx = [(r * hl + j) // (H // G) for j in range(hl)]
    lo, n = idx[0], idx[-1] - idx[0] + 1
    if hl % n == 0 and idx == [lo + j // (hl // n) for j in range(hl)]:
        return lambda t: t.narrow(2, lo, n)
    sel = torch.tensor(idx, device=device)
    return lambda t: t.index_select(2, sel)


def _flat(tree, path=()):
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in _flat(tree[k], path + (k,))]
    return [(path, tree)]


def _unflat(items):
    out: dict = {}
    for path, t in items:
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = t
    return out


def activation_rows(ndim: int = 3) -> tuple:
    """The spec of a block's input rows: the batch on the DP axes as the
    "activations" hint places it, every other dimension whole (a block
    that runs on each rank's shards needs its whole sequence)."""
    return (spec_of("activations", 3)[0],) + (None,) * (ndim - 1)


def local_block(fn, params: dict, x, param_spec, out_spec, partial=(),
                extra=(), extra_specs=()):
    """A whole block ``fn(params, x, *extra)`` run on each rank's shards
    (``local_call``): `x` as ``activation_rows`` places it, each
    parameter leaf as ``param_spec(path, leaf)`` gives (entries other
    than the tensor-parallel ones gathered), `extra` tensors by
    `extra_specs`; the block's output(s) by `out_spec`, partial sums over
    the axes in `partial` (as ``local_call``).  Inside, the block sees
    plain local tensors, so DTensor places nothing within it: the forward
    and its gradient keep the placements the block names."""
    items = _flat(params)
    paths = [p for p, _ in items]
    leaves = [t for _, t in items]

    def run(x, *rest):
        local = _unflat(list(zip(paths, rest[:len(leaves)])))
        return fn(local, x, *rest[len(leaves):])
    specs = ((activation_rows(x.ndim),)
             + tuple(param_spec("/".join(p), t) for p, t in items)
             + tuple(extra_specs))
    return local_call(run, (x, *leaves, *extra), specs, out_spec,
                      partial=partial)
