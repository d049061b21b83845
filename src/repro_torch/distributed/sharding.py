"""Sharding rules: logical axes -> mesh axes, with divisibility fallback
(port of ``repro.distributed.sharding``).

Scheme (Megatron/FSDP hybrid):
  * "model" mesh axis:  tensor parallelism — attention heads, FFN hidden,
    vocab, MoE experts (expert parallelism), SSM/LRU inner width.
  * "data" mesh axis:   FSDP — parameters (and Adam moments, which are
    congruent trees) additionally sharded on a non-TP dimension.
  * "pod"  mesh axis:   pure data parallelism across pods — batch only.
    Parameters are not sharded across pods; gradients reduce across pods
    once per step.

Every rule is sanitized: a mesh axis is dropped (dimension replicated)
whenever it does not evenly divide the dimension — e.g. gemma2's 8 query
heads on a 16-way model axis fall back to replicated attention weights
while its 9216 FFN still gets 16-way TP.

A spec is a :class:`P`: one entry per tensor dimension, each None, a mesh
axis name or a tuple of them, as the reference's ``PartitionSpec``.
``placements(spec, mesh)`` turns it into DTensor placements, one per mesh
dimension (``Shard(d)`` where the dimension's axis names it, else
``Replicate()``).  The rule functions read only a mesh's axis names and
sizes, so they take a ``DeviceMesh`` (``mesh_dim_names``) or any object
with the reference's ``axis_names`` and ``shape`` mapping.

The port keeps one parameter dict per layer (``layers/<i>/...``) where
the reference stacks the periodic body on a leading axis
(``body/p<j>/...``); a layer's leaf has the reference's leaf shape
without that axis, and its spec is the reference's without the leading
None.  Caches are per-layer lists in the same way.
"""
from __future__ import annotations

import math
import re
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

from ..configs.base import InputShape, ModelConfig

# ---------------------------------------------------------------------------
# Specs and mesh helpers
# ---------------------------------------------------------------------------


class P(tuple):
    """A partition spec: a tuple of per-dimension entries.  Two specs are
    equal when they agree after trailing Nones are dropped (``P(None) ==
    P()``, both replicated)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def _trimmed(self) -> tuple:
        out = list(self)
        while out and out[-1] is None:
            out.pop()
        return tuple(out)

    def __eq__(self, other):
        if not isinstance(other, tuple):
            return NotImplemented
        o = list(other)
        while o and o[-1] is None:
            o.pop()
        return self._trimmed() == tuple(o)

    def __ne__(self, other):
        eq = self.__eq__(other)
        return eq if eq is NotImplemented else not eq

    def __hash__(self):
        return hash(self._trimmed())

    def __repr__(self):
        return "P(" + ", ".join(repr(e) for e in self) + ")"


class NamedSharding(NamedTuple):
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``):
    what ``models.pctx`` hints and the step builders' state hold."""
    mesh: Any
    spec: P

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        names = mesh.axis_names
    return tuple(names)


def _sizes(mesh) -> Dict[str, int]:
    names = axis_names(mesh)
    shape = mesh.shape
    if isinstance(shape, dict):
        return {a: int(shape[a]) for a in names}
    return dict(zip(names, (int(s) for s in shape)))


def dp_axes(mesh) -> Tuple[str, ...]:
    """Batch-parallel axes: ("pod", "data") when the pod axis exists."""
    return tuple(a for a in ("pod", "data") if a in axis_names(mesh))


def axis_size(mesh, axes) -> int:
    """The number of devices along `axes` (a name or a tuple of names);
    an axis the mesh lacks counts 1."""
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = _sizes(mesh)
    return int(math.prod(sizes.get(a, 1) for a in axes))


def dp_entry(mesh, batch: int):
    """The spec entry of a batch dimension of `batch` rows: the DP axes
    (one name, or a tuple of two) when they divide it, else None."""
    dp = dp_axes(mesh)
    if dp and batch % axis_size(mesh, dp) == 0:
        return dp if len(dp) > 1 else dp[0]
    return None


def placements(spec, mesh) -> tuple:
    """DTensor placements of `spec` on `mesh`: for each mesh dimension,
    ``Shard(d)`` if tensor dimension d's entry names it, else
    ``Replicate()``.  A dimension split over two axes (("pod", "data"))
    is sharded over both, the first the outer, as in the reference."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in axis_names(mesh):
        dim = None
        for d, entry in enumerate(spec):
            names = (entry,) if isinstance(entry, str) else (entry or ())
            if name in names:
                dim = d
                break
        out.append(Shard(dim) if dim is not None else Replicate())
    return tuple(out)


# ---------------------------------------------------------------------------
# Logical axes -> mesh axes
# ---------------------------------------------------------------------------

# logical axis name -> mesh axes (None = replicated)
LOGICAL_TO_MESH = {
    "batch": ("pod", "data"),
    "fsdp": ("data",),
    "tensor": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "vocab": ("model",),
    "expert": ("model",),
    "seq": ("data",),       # sequence parallelism (long-context decode)
    None: None,
}


def logical_rules() -> dict:
    return dict(LOGICAL_TO_MESH)


# (path regex, logical axes per dim).  First match wins; matched against
# the "/"-joined param path (a layer's leaf: no stacked period axis).
_PARAM_RULES: Sequence[Tuple[str, Optional[Tuple[Optional[str], ...]]]] = (
    # embeddings: vocab-parallel (Megatron).  As in the reference, the
    # pattern names the subtree, not its "table" leaf, so the tables of
    # the models' trees fall through to replicated
    (r"(embed|lm_head)$", ("vocab", None)),
    (r"frontend_proj$", ("fsdp", None)),
    # MLA (must precede generic attention: names overlap)
    (r"mla/w_dq$", ("fsdp", "tensor")),
    (r"mla/w_uq$", ("fsdp", "heads", None)),
    (r"mla/w_dkv$", ("fsdp", None)),
    (r"mla/w_ukv$", ("fsdp", "heads", None)),
    (r"mla/w_o$", ("heads", None, "fsdp")),
    # attention
    (r"attn/w_q$", ("fsdp", "heads", None)),
    (r"attn/w_[kv]$", ("fsdp", "kv_heads", None)),
    (r"attn/w_o$", ("heads", None, "fsdp")),
    (r"attn/b_q$", ("heads", None)),
    (r"attn/b_[kv]$", ("kv_heads", None)),
    # MoE experts: expert-parallel + FSDP
    (r"moe/w_router$", (None, None)),
    (r"moe/(w_gate|w_up)$", ("expert", "fsdp", None)),
    (r"moe/w_down$", ("expert", None, "fsdp")),
    (r"moe/shared/(w_gate|w_up)$", ("fsdp", "tensor")),
    (r"moe/shared/w_down$", ("tensor", "fsdp")),
    # dense MLP
    (r"mlp/(w_gate|w_up)$", ("fsdp", "tensor")),
    (r"mlp/w_down$", ("tensor", "fsdp")),
    # RG-LRU
    (r"rglru/(w_x|w_gate_branch)$", ("fsdp", "tensor")),
    (r"rglru/w_out$", ("tensor", "fsdp")),
    (r"rglru/conv_w$", (None, "tensor")),
    (r"rglru/(w_r|w_i)$", (None, None, None)),
    (r"rglru/a_param$", ("tensor",)),
    # Mamba-2 SSD
    (r"ssd/w_in$", ("fsdp", None)),
    (r"ssd/w_out$", ("tensor", "fsdp")),
    (r"ssd/conv_w$", (None, None)),
    # everything else (norm scales, small biases, A_log, D, dt_bias...)
    (r".", None),
)


def path_str(path) -> str:
    """A leaf path as "/"-joined keys: a string stays as it is; a
    sequence may hold plain keys, JAX-style key entries (``.key`` /
    ``.idx``) or the ``"['key']"`` / ``"[i]"`` strings of
    ``optim.adamw.leaves_with_path``."""
    if isinstance(path, str):
        return path
    parts = []
    for k in path:
        if hasattr(k, "key"):
            parts.append(str(k.key))
        elif hasattr(k, "idx"):
            parts.append(str(k.idx))
        else:
            s = str(k)
            m = re.fullmatch(r"\[(?:'(.*)'|(\d+))\]", s)
            parts.append((m.group(1) if m.group(1) is not None
                          else m.group(2)) if m else s)
    return "/".join(parts)


def _sanitize(spec: Tuple, shape: Tuple[int, ...], mesh) -> P:
    """Drop mesh axes that don't divide their dimension; drop axes not in
    the mesh (e.g. "pod" on the single-pod mesh)."""
    names = axis_names(mesh)
    out = []
    for dim, axes in zip(shape, spec):
        if axes is None:
            out.append(None)
            continue
        if isinstance(axes, str):
            axes = (axes,)
        axes = tuple(a for a in axes if a in names)
        if axes and dim % axis_size(mesh, axes) == 0:
            out.append(axes if len(axes) > 1 else axes[0])
        else:
            out.append(None)
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def pspec_for_param(path, leaf, mesh, rules=None) -> P:
    """Spec for one parameter leaf (anything with a ``.shape``)."""
    ps = path_str(path)
    shape = tuple(leaf.shape)
    table = rules or LOGICAL_TO_MESH
    spec: Tuple = ()
    for pat, logical in _PARAM_RULES:
        if re.search(pat, ps):
            if logical is None:
                spec = (None,) * len(shape)
            else:
                assert len(logical) == len(shape), (ps, logical, shape)
                spec = tuple(table.get(ax) for ax in logical)
            break
    return _sanitize(spec, shape, mesh)


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return [_map_with_path(fn, v, path + (str(i),))
                for i, v in enumerate(tree)]
    if hasattr(tree, "_fields"):            # NamedTuple (AdamW's OptState)
        return type(tree)(*(_map_with_path(fn, getattr(tree, f),
                                           path + (f,))
                            for f in tree._fields))
    return fn(path, tree)


def param_shardings(params_or_shapes, mesh, rules=None):
    """Tree of specs congruent with the params tree (tensors, meta
    tensors or anything with a ``.shape``; also the AdamW state, whose
    moments are congruent with the parameters and whose step is
    replicated)."""
    def one(path, leaf):
        # an OptState's m / v subtrees: the parameter path without m / v
        if path and path[0] in ("params",):
            path = path[1:]
        if path[:2] in (("opt", "m"), ("opt", "v")):
            path = path[2:]
        elif path[:1] in (("m",), ("v",)):
            path = path[1:]
        if not getattr(leaf, "shape", ()):
            return P()
        return pspec_for_param(path, leaf, mesh, rules)
    return _map_with_path(one, params_or_shapes)


# ---------------------------------------------------------------------------
# Batch / cache specs
# ---------------------------------------------------------------------------


def batch_pspecs(cfg: ModelConfig, shape: InputShape, mesh) -> dict:
    """Specs for the input batch dict of this (arch, shape)."""
    b = shape.global_batch
    dp = dp_entry(mesh, b)
    if shape.kind == "decode":
        return {"tokens": P(dp), "pos": P(dp)}
    specs = {}
    if cfg.frontend == "audio":
        specs["frames"] = P(dp, None, None)
    elif cfg.frontend == "vision":
        specs["patch_embeds"] = P(dp, None, None)
        specs["tokens"] = P(dp, None)
    else:
        specs["tokens"] = P(dp, None)
    if shape.kind == "train":
        specs["targets"] = P(dp, None)
    return specs


def cache_pspec_for(path, leaf, cfg: ModelConfig, mesh, batch: int,
                    l_model: bool = False) -> P:
    """Spec for one KV/state cache leaf of one layer.

    Layouts: attention k/v (B, L, Hkv, D); MLA c_kv (B, L, r) and k_rope
    (B, L, dr); rglru h (B, W), conv (B, w-1, W); ssd h (B, H, P, N),
    conv (B, w-1, C).  If the batch is shardable it goes on the DP axes;
    otherwise (long-context, batch=1) the cache *sequence* dim is sharded
    on "data" — sequence parallelism for decode.  `l_model` shards the
    cache length on the "model" axis instead (flash-decoding).
    """
    ps = path_str(path)
    shape = tuple(leaf.shape)
    dp = dp_entry(mesh, batch)
    name = ps.rsplit("/", 1)[-1]
    seq_shard = dp is None  # batch not shardable -> shard sequence instead
    l_ax = "model" if l_model else ("data" if seq_shard else None)

    if name in ("k", "v"):                       # (B, L, Hkv, D)
        return _sanitize(
            (dp, l_ax, None if l_model else "model", None), shape, mesh)
    if name in ("c_kv", "k_rope"):               # (B, L, r)
        return _sanitize((dp, l_ax, None), shape, mesh)
    if name == "h" and len(shape) == 4:          # ssd state (B, H, P, N)
        return _sanitize((dp, "model", None, None), shape, mesh)
    if name == "h":                              # rglru state (B, W)
        return _sanitize((dp, "model"), shape, mesh)
    if name == "conv":                           # (B, w-1, C)
        return _sanitize((dp, None, "model"), shape, mesh)
    return _sanitize((dp,) + (None,) * (len(shape) - 1), shape, mesh)


def cache_shardings(cache_shapes, cfg: ModelConfig, mesh, batch: int,
                    l_model: bool = False):
    """Specs congruent with a cache (the per-layer list of dicts)."""
    return _map_with_path(
        lambda path, leaf: cache_pspec_for(path, leaf, cfg, mesh, batch,
                                           l_model), cache_shapes)


def replicated(mesh) -> P:
    """The replicated spec (``placements`` gives all ``Replicate()``)."""
    return P()
