"""Nested containers of tensors (named tuples, tuples, lists, dicts)."""

from __future__ import annotations

import torch


def clone(x):
    """``x`` with every tensor in it cloned."""
    if torch.is_tensor(x):
        return x.clone()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(clone(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(clone(v) for v in x)
    if isinstance(x, dict):
        return {k: clone(v) for k, v in x.items()}
    return x
