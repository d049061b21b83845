"""Partitioning context: activation sharding hints for model code (port
of ``repro.models.pctx``).

The reference's distributed train and serve steps install a dict of
NamedShardings here and model code applies them with :func:`constrain`;
on a single device the context is empty and ``constrain`` is the
identity.  The port runs on one device: the context stays empty, and
installing a non-empty one raises, naming the slice that brings
distribution, rather than silently ignoring a mesh.

Keys used by the model layer (as in the reference):
    moe_dispatch   (G, n, E, C) dispatch/combine one-hots
    moe_expert_in  (E, G, C, d) expert input buffers
    attn_qkv       (B, S, H, D) post-projection activations
    activations    (B, S, d) residual-stream activations
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, Optional

DISTRIBUTION_SLICE = ("sharding hints need a device mesh: distribution "
                      "(DeviceMesh / DTensor) arrives with a later slice "
                      "of the port (ROADMAP Queue A item 7)")


@contextmanager
def sharding_hints(specs: Optional[Dict[str, object]]):
    """The block runs with `specs` installed.  Only the empty context
    (None or {}) exists on one device."""
    if specs:
        raise NotImplementedError(DISTRIBUTION_SLICE)
    yield


def constrain(x, key: str):
    """The identity: no hint is ever installed on one device."""
    return x


def hint(key: str):
    """The hint installed for `key`: none on one device."""
    return None
