"""Step builders: the train / prefill / decode steps, on one device or on
a (pod, data, model) ``DeviceMesh`` (port of ``repro.distributed.steps``).

Each builder returns a :class:`StepBundle`: the step function, its
abstract arguments (``args``: fake tensors, or fake DTensors with the
step's placements, built under ``FakeTensorMode`` and never allocated,
so a dry run can trace the step on a production mesh), the mesh and the
shardings.  PyTorch runs eagerly, so there is nothing to jit or lower:
the step is the function itself.

With ``mesh=None`` a step runs on one device (the card unless the
caller names another).  With a mesh, parameters, AdamW moments, batches
and caches are DTensors placed by ``sharding.param_shardings``,
``batch_pspecs`` and ``cache_shardings``; the step installs the
activation hints of ``_model_hints`` (``models.pctx``), runs the model on
the DTensors (plain tensors it is handed are distributed first, each
rank keeping its own slice of the same global tensor), and every kernel
runs on each rank's shards behind ``pctx.local_call``.  Gradients are
redistributed to their parameters' placements, which sums the partial
ones across ranks, before ``optim.adamw.update`` updates each rank's
shards in place.

MoE models default to the grouped GShard dispatch with one group per
data-parallel shard (``gshard:<G>``), whose dispatch / combine one-hots
shard on (group, expert) — see models/moe.py.
"""
from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..configs.base import InputShape, ModelConfig
from ..core.predictor import resolve_device
from ..models import model as model_lib
from ..models import pctx
from ..models import steps as steps_lib
from ..optim import adamw
from .sharding import (NamedSharding, P, axis_size, batch_pspecs,
                       cache_shardings, dp_axes, dp_entry, param_shardings,
                       placements)

# ---------------------------------------------------------------------------
# Abstract trees
# ---------------------------------------------------------------------------


_FAKE = None


def fake_mode():
    """The one ``FakeTensorMode`` every abstract tree is built under, so
    that a dry run can trace a step on all of them together."""
    global _FAKE
    if _FAKE is None:
        from torch._subclasses.fake_tensor import FakeTensorMode
        _FAKE = FakeTensorMode(allow_non_fake_inputs=True)
    return _FAKE


def abstract_params(cfg: ModelConfig, param_dtype=torch.float32):
    """The parameters' shapes and dtypes: fake CPU tensors."""
    with fake_mode():
        return model_lib.init_params(
            cfg, torch.Generator(device="cpu").manual_seed(0), "cpu",
            param_dtype=param_dtype)


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int):
    with fake_mode():
        return model_lib.init_cache(cfg, batch, max_len, "cpu")


def abstract_train_state(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                         param_dtype=torch.float32):
    p = abstract_params(cfg, param_dtype)
    with fake_mode():
        opt = adamw.init(p, opt_cfg)
    return {"params": p, "opt": opt}


def abstract_batch(cfg: ModelConfig, shape: InputShape) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    with fake_mode():
        z = lambda s, dt: torch.empty(s, dtype=dt)
        if shape.kind == "decode":
            return {"tokens": z((B,), i32), "pos": z((B,), i32)}
        out: Dict[str, Any] = {}
        if cfg.frontend == "audio":
            out["frames"] = z((B, S, cfg.frontend_dim), torch.float32)
        elif cfg.frontend == "vision":
            nf = cfg.n_frontend_tokens
            out["patch_embeds"] = z((B, nf, cfg.frontend_dim),
                                    torch.float32)
            out["tokens"] = z((B, S - nf), i32)
        else:
            out["tokens"] = z((B, S), i32)
        if shape.kind == "train":
            tgt = (B, S - cfg.n_frontend_tokens) if cfg.frontend == \
                "vision" else (B, S)
            out["targets"] = z(tgt, i32)
        return out


def _map2(fn, tree, specs):
    """`fn(leaf, spec)` over a tree and its congruent tree of specs."""
    if isinstance(tree, dict):
        return {k: _map2(fn, v, specs[k]) for k, v in tree.items()}
    if hasattr(tree, "_fields"):                 # AdamW's OptState
        return type(tree)(*(_map2(fn, getattr(tree, f), getattr(specs, f))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return [_map2(fn, v, s) for v, s in zip(tree, specs)]
    return fn(tree, specs)


def _with_shardings(tree, specs, mesh):
    """Fake DTensors of `tree`'s (fake) leaves on `mesh` with `specs`:
    each a local shard of the leaf's shard shape (0-d leaves plain)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    def one(leaf, spec):
        if leaf.dim() == 0:
            return leaf     # a scalar stays plain, as in ``distribute``
        pl = placements(spec, mesh)
        local_shape, _ = compute_local_shape_and_global_offset(
            leaf.shape, mesh, pl)
        with fake_mode():
            local = torch.empty(local_shape, dtype=leaf.dtype,
                                device=leaf.device)
            return DTensor.from_local(local, mesh, pl, run_check=False,
                                      shape=leaf.shape,
                                      stride=_contiguous_stride(leaf.shape))
    return _map2(one, tree, specs)


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for s in reversed(tuple(shape)):
        stride.append(acc)
        acc *= s
    return tuple(reversed(stride))


def distribute(tree, specs, mesh):
    """`tree`'s tensors as DTensors on `mesh` with `specs`: each rank keeps
    its own slice of its copy of the global tensor, which every rank must
    hold alike (the same seed, the same data).  DTensors pass through,
    redistributed to their spec; 0-d tensors stay plain."""
    from torch.distributed.tensor import distribute_tensor

    def one(t, spec):
        if pctx.is_dtensor(t):
            return pctx.redistribute(t, spec)
        if t.dim() == 0:
            return t        # a scalar (AdamW's step): alike on every rank
        return distribute_tensor(t.to(mesh.device_type), mesh,
                                 placements(spec, mesh),
                                 src_data_rank=None)
    return _map2(one, tree, specs)


# ---------------------------------------------------------------------------
# MoE dispatch / hints
# ---------------------------------------------------------------------------


def _moe_groups(cfg: ModelConfig, shape: InputShape, mesh) -> int:
    if cfg.moe is None:
        return 1
    dp = dp_axes(mesh)
    G = axis_size(mesh, dp)
    n_tok = shape.global_batch if shape.kind == "decode" \
        else shape.global_batch * shape.seq_len
    if G > 1 and n_tok % G == 0 and shape.global_batch % G == 0:
        return G
    return 1


def _moe_hints(mesh, G: int):
    if G <= 1:
        return {}
    dp = dp_axes(mesh)
    dpx = dp if len(dp) > 1 else dp[0]
    # the reference's "moe_dispatch" and "moe_group_buf" hints place its
    # buffers inside the dispatch, where the port has no DTensor
    return {"moe_expert_in": NamedSharding(mesh, P("model", dpx, None, None))}


def _dispatch_for(cfg: ModelConfig, shape: InputShape, mesh,
                  override: Optional[str]) -> Tuple[Optional[str], dict]:
    if cfg.moe is None:
        return None, {}
    if override is not None:
        if override.startswith(("gshard", "sortg")):
            if ":" in override:
                G = int(override.split(":")[1])
            else:
                G = _moe_groups(cfg, shape, mesh)
                override = f"{override}:{G}"
            return override, _moe_hints(mesh, G)
        return override, {}
    G = _moe_groups(cfg, shape, mesh)
    return f"gshard:{G}", _moe_hints(mesh, G)


def _model_hints(cfg: ModelConfig, shape: InputShape, mesh) -> dict:
    """Activation sharding hints (models/pctx.py keys): keep the batch
    dim on the DP axes and put heads / FFN-hidden / vocab on "model"
    wherever the dimension divides."""
    nm = axis_size(mesh, ("model",))
    dpx = dp_entry(mesh, shape.global_batch)
    heads = "model" if cfg.n_heads % nm == 0 else None
    kv = "model" if cfg.n_kv_heads and cfg.n_kv_heads % nm == 0 else None
    if cfg.mla is not None:
        kv = heads
    hints = {
        "activations": NamedSharding(mesh, P(dpx, None, None)),
        "attn_q": NamedSharding(mesh, P(dpx, None, heads, None)),
        "attn_kv": NamedSharding(mesh, P(dpx, None, kv, None)),
    }
    d_ff = cfg.moe.d_ff_dense or cfg.d_ff if cfg.moe else cfg.d_ff
    if d_ff and d_ff % nm == 0:
        hints["ffn_hidden"] = NamedSharding(mesh, P(dpx, None, "model"))
        hints["ffn_hidden_2d"] = NamedSharding(mesh, P(dpx, "model"))
    if cfg.vocab_size % nm == 0:
        hints["logits"] = NamedSharding(mesh, P(dpx, None, "model"))
    return hints


def _hints_for(cfg, shape, mesh, dispatch, extra_hints):
    disp, hints = _dispatch_for(cfg, shape, mesh, dispatch)
    return disp, {**_model_hints(cfg, shape, mesh), **hints,
                  **(extra_hints or {})}


@contextmanager
def _distributed(hints):
    """The block a mesh step runs in: its hints installed, and plain
    tensors (positions, masks, constants) taken as replicated beside the
    DTensors."""
    from torch.distributed.tensor.experimental import implicit_replication
    with pctx.sharding_hints(hints), implicit_replication():
        yield


def _full(t):
    """A DTensor's global value as a plain tensor; a plain one as it is."""
    return t.full_tensor() if pctx.is_dtensor(t) else t


# ---------------------------------------------------------------------------
# Bundles
# ---------------------------------------------------------------------------


@dataclass
class StepBundle:
    name: str
    fn: Callable            # the step
    args: tuple = ()        # abstract args (fake tensors / DTensors)
    mesh: Any = None
    meta: dict = field(default_factory=dict)


def _split_local(x, microbatch: int, i: int):
    """Microbatch `i` of batch leaf `x`: on a DTensor each rank's i-th
    slice of its own rows (the batch stays on the DP axes), on a plain
    tensor the i-th slice of the rows."""
    if not pctx.is_dtensor(x):
        return x.chunk(microbatch, dim=0)[i]
    from torch.distributed.tensor import DTensor
    local = x.to_local().chunk(microbatch, dim=0)[i]
    return DTensor.from_local(local, x.device_mesh, x.placements,
                              run_check=False)


# -- train ------------------------------------------------------------------


def make_train_step(cfg: ModelConfig, mesh=None,
                    shape: Optional[InputShape] = None,
                    opt_cfg: Optional[adamw.AdamWConfig] = None,
                    remat: bool = True, microbatch: int = 1,
                    dispatch: Optional[str] = None,
                    param_dtype=torch.float32,
                    cast_params: bool = False,
                    extra_hints: Optional[dict] = None,
                    device=None) -> StepBundle:
    """The train step of `cfg` at `shape`, through the hand-written
    kernels and their backward kernels: ``fn(state, batch) -> (state,
    metrics)`` with the state ``{"params", "opt"}`` updated in place and
    the metrics (``loss``, ``xent``, ``aux``, ``tokens``, ``grad_norm``,
    ``lr``) plain 0-d tensors.  With ``microbatch`` > 1 the batch is
    split on its leading axis (on a mesh, each rank's own rows) and the
    gradients summed in f32 and divided by ``microbatch``.

    ``mesh=None``: one device, `device` (the card unless the caller names
    another).  With a mesh the state and batch are DTensors placed by
    ``meta["state_shardings"]`` / ``meta["batch_shardings"]`` (plain
    tensors are distributed on entry).  ``cast_params=True`` casts f32
    matrices to the compute dtype once at step entry, so weight gathers
    move the compute dtype."""
    if shape is None:
        raise TypeError("make_train_step needs an InputShape")
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    if microbatch < 1 or shape.global_batch % microbatch:
        raise ValueError(f"batch {shape.global_batch} does not split into "
                         f"{microbatch} microbatches")
    cdt = model_lib.compute_dtype(cfg)
    if mesh is None:
        dev = resolve_device(device)
        disp, hints = dispatch, {}
        state_sh = batch_sh = None
    else:
        dev = torch.device(mesh.device_type)
        disp, hints = _hints_for(cfg, shape, mesh, dispatch, extra_hints)
        state_abs = abstract_train_state(cfg, opt_cfg, param_dtype)
        state_sh = param_shardings(state_abs, mesh)
        batch_sh = batch_pspecs(cfg, shape, mesh)

    def loss_of(params, b):
        if cast_params:
            params = _map2(lambda p, _s: p.to(cdt)
                           if p.dtype == torch.float32 and p.dim() > 1
                           else p, params, params)
        return steps_lib.loss_fn(cfg, params, b, remat=remat,
                                 dispatch=disp)

    def grads_of(leaves, params, b):
        with torch.enable_grad():
            loss, mets = loss_of(params, b)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return loss.detach(), {k: v.detach() for k, v in mets.items()}, grads

    def body(state, batch):
        params = state["params"]
        leaves = [p.requires_grad_(True) for _, p in
                  adamw.leaves_with_path(params)]
        if microbatch > 1:
            g_acc = [torch.zeros_like(p, dtype=torch.float32)
                     for p in leaves]
            loss = 0.0
            for i in range(microbatch):
                b = {k: _split_local(v, microbatch, i)
                     for k, v in batch.items()}
                l_i, metrics, g = grads_of(leaves, params, b)
                for acc, gi in zip(g_acc, g):
                    acc.add_(_placed_like(gi, acc))
                loss = loss + l_i
                del g
            grads = [acc.div_(microbatch) for acc in g_acc]
            loss = loss / microbatch
        else:
            loss, metrics, grads = grads_of(leaves, params, batch)
        grads = [_placed_like(g, p) for g, p in zip(grads, leaves)]
        grads = _like(params, iter(grads))
        _, new_opt, opt_metrics = adamw.update(params, grads, state["opt"],
                                               opt_cfg)
        del grads
        metrics = {k: _full(v) for k, v in
                   {**metrics, **opt_metrics, "loss": loss}.items()}
        return {"params": params, "opt": new_opt}, metrics

    if mesh is None:
        step = body
    else:
        def step(state, batch):
            with _distributed(hints):
                state = distribute(state, state_sh, mesh)
                batch = distribute(batch, batch_sh, mesh)
                return body(state, batch)

    def grads(state, batch, paths=None):
        """(loss, metrics, gradients) of the whole batch without an
        update: the gradients of the leaves whose "/"-joined paths are in
        `paths` (all when None), summed across ranks and placed as their
        parameters, in ``leaves_with_path`` order."""
        from .sharding import path_str

        def run(state, batch):
            named = adamw.leaves_with_path(state["params"])
            leaves = [p.requires_grad_(True) for _, p in named]
            want = [p for (path, p) in named
                    if paths is None or path_str(path) in paths]
            with torch.enable_grad():
                loss, mets = loss_of(state["params"], batch)
                g = torch.autograd.grad(loss, want, allow_unused=True)
            del leaves
            g = [_placed_like(torch.zeros_like(p) if gi is None else gi, p)
                 for p, gi in zip(want, g)]
            return (_full(loss.detach()),
                    {k: _full(v.detach()) for k, v in mets.items()}, g)
        if mesh is None:
            return run(state, batch)
        with _distributed(hints):
            return run(distribute(state, state_sh, mesh),
                       distribute(batch, batch_sh, mesh))

    args = ()
    if mesh is not None:
        args = (_with_shardings(state_abs, state_sh, mesh),
                _with_shardings(abstract_batch(cfg, shape), batch_sh, mesh))
    return StepBundle("train", step, args, mesh,
                      meta={"dispatch": disp, "remat": remat,
                            "microbatch": microbatch, "device": dev,
                            "hints": hints, "state_shardings": state_sh,
                            "batch_shardings": batch_sh, "grads": grads})


def _placed_like(g, p):
    """Gradient `g` redistributed to parameter `p`'s placements (a
    partial gradient is summed across ranks here)."""
    if not pctx.is_dtensor(p):
        return g
    return g.redistribute(p.device_mesh, p.placements)


def _like(tree, it):
    """`tree`'s structure with its leaves taken from `it` in order."""
    if isinstance(tree, dict):
        return {k: _like(v, it) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_like(v, it) for v in tree]
    return next(it)


# -- prefill (encoder-only archs: full forward) -------------------------------


def _serve_setup(cfg, mesh, shape, dispatch, param_dtype, extra_hints):
    disp, hints = _hints_for(cfg, shape, mesh, dispatch, extra_hints)
    params_abs = abstract_params(cfg, param_dtype)
    params_sh = param_shardings(params_abs, mesh)
    return disp, hints, params_abs, params_sh


def make_prefill_step(cfg: ModelConfig, mesh, shape: InputShape,
                      dispatch: Optional[str] = None,
                      param_dtype=torch.float32,
                      extra_hints: Optional[dict] = None,
                      cache_len: Optional[int] = None) -> StepBundle:
    """``fn(params, batch)``: the last position's logits (B, V) and the
    cache sized for `cache_len` (``shape.seq_len`` when None; more leaves
    room for decode steps); an encoder-only model's step ("encode")
    returns the full logits (B, S, V).  DTensors out."""
    cache_len = cache_len or shape.seq_len
    disp, hints, params_abs, params_sh = _serve_setup(
        cfg, mesh, shape, dispatch, param_dtype, extra_hints)
    batch_abs = abstract_batch(cfg, shape)
    batch_sh = batch_pspecs(cfg, shape, mesh)
    dpx = dp_entry(mesh, shape.global_batch)
    args = (_with_shardings(params_abs, params_sh, mesh),
            _with_shardings(batch_abs, batch_sh, mesh))

    if cfg.encoder_only:
        def step(params, batch):
            with _distributed(hints):
                params = distribute(params, params_sh, mesh)
                batch = distribute(batch, batch_sh, mesh)
                out = model_lib.forward(cfg, params, batch, dispatch=disp)
                return pctx.redistribute(out, P(dpx, None, None))
        return StepBundle("encode", step, args, mesh,
                          meta={"dispatch": disp, "hints": hints,
                                "params_shardings": params_sh,
                                "batch_shardings": batch_sh})

    cache_abs = abstract_cache(cfg, shape.global_batch, cache_len)
    cache_sh = cache_shardings(cache_abs, cfg, mesh, shape.global_batch)

    def step(params, batch):
        with _distributed(hints):
            params = distribute(params, params_sh, mesh)
            batch = distribute(batch, batch_sh, mesh)
            logits, cache = model_lib.prefill(cfg, params, batch,
                                              cache_len, dispatch=disp)
            return (pctx.redistribute(logits, P(dpx, None)),
                    distribute(cache, cache_sh, mesh))

    return StepBundle("prefill", step, args, mesh,
                      meta={"dispatch": disp, "hints": hints,
                            "params_shardings": params_sh,
                            "batch_shardings": batch_sh,
                            "cache_shardings": cache_sh})


# -- decode -------------------------------------------------------------------


def make_decode_step(cfg: ModelConfig, mesh, shape: InputShape,
                     dispatch: Optional[str] = None,
                     param_dtype=torch.float32,
                     cache_l_model: bool = False,
                     extra_hints: Optional[dict] = None) -> StepBundle:
    """One serve step, ``fn(params, cache, tokens, pos) -> (next tokens,
    cache)``: each batch element appends one token against a KV / state
    cache of length seq_len, greedily.  ``cache_l_model`` shards the
    cache length dim over the "model" axis (flash-decoding).  On DTensors
    the cache is updated functionally (the returned cache holds new
    tensors)."""
    disp, hints, params_abs, params_sh = _serve_setup(
        cfg, mesh, shape, dispatch, param_dtype, extra_hints)
    B = shape.global_batch
    cache_abs = abstract_cache(cfg, B, shape.seq_len)
    cache_sh = cache_shardings(cache_abs, cfg, mesh, B,
                               l_model=cache_l_model)
    tok_sh = P(dp_entry(mesh, B))
    with fake_mode():
        tok_abs = torch.empty((B,), dtype=torch.int32)

    def step(params, cache, tokens, pos):
        with _distributed(hints):
            params = distribute(params, params_sh, mesh)
            cache = distribute(cache, cache_sh, mesh)
            tokens, pos = (distribute(t, tok_sh, mesh)
                           for t in (tokens, pos))
            logits, new_cache = model_lib.decode_step(cfg, params, tokens,
                                                      pos, cache, disp)
            # the vocabulary whole on each rank: the argmax is local
            logits = pctx.redistribute(logits, (tok_sh[0], None))
            next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
            return (pctx.redistribute(next_tok, tok_sh),
                    distribute(new_cache, cache_sh, mesh))

    args = (_with_shardings(params_abs, params_sh, mesh),
            _with_shardings(cache_abs, cache_sh, mesh),
            _with_shardings(tok_abs, tok_sh, mesh),
            _with_shardings(tok_abs, tok_sh, mesh))
    return StepBundle("decode", step, args, mesh,
                      meta={"dispatch": disp, "hints": hints,
                            "params_shardings": params_sh,
                            "cache_shardings": cache_sh})


def make_step_bundle(cfg: ModelConfig, mesh, shape: InputShape,
                     **kw) -> StepBundle:
    """The step a given input shape exercises (assignment semantics)."""
    if shape.kind == "train":
        return make_train_step(cfg, mesh, shape, **kw)
    if shape.kind == "prefill":
        return make_prefill_step(cfg, mesh, shape, **kw)
    return make_decode_step(cfg, mesh, shape, **kw)


# re-exported alias
TrainState = dict


def input_specs(cfg: ModelConfig, shape: InputShape, mesh, **kw) -> tuple:
    """Fake DTensor stand-ins for every model input of this cell."""
    return make_step_bundle(cfg, mesh, shape, **kw).args
