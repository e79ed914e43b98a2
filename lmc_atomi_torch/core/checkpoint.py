"""Checkpoint and resume (counterpart of ``lmc_atomi_tpu/core/checkpoint.py``).

A bundle (sampler state, streaming moments, marker state, base key, step
count) is saved with ``torch.save`` as plain containers of CPU tensors:
dataclasses and NamedTuples become dicts of their fields, ``None`` a tagged
dict, so the file loads with ``weights_only=True``. ``restore_checkpoint``
rebuilds the bundle's types from a template and puts each tensor on the
template's device. The write goes to a temporary file in the same directory
and is renamed over the target, so a reader sees the old checkpoint or the
new one, never a partial file.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Any

import torch

__all__ = ["save_checkpoint", "restore_checkpoint"]

_NONE_TAG = "__none__"


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _encode(node: Any) -> Any:
    if node is None:
        return {_NONE_TAG: True}
    if isinstance(node, torch.Tensor):
        return node.detach().cpu()
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return {f.name: _encode(getattr(node, f.name))
                for f in dataclasses.fields(node)}
    if _is_namedtuple(node):
        return {k: _encode(v) for k, v in node._asdict().items()}
    if isinstance(node, dict):
        return {k: _encode(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_encode(v) for v in node]
    return node


def _decode(data: Any, template: Any, device) -> Any:
    if isinstance(data, dict) and _NONE_TAG in data:
        return None
    if isinstance(template, torch.Tensor):
        return data.to(template.device)
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        return type(template)(**{
            f.name: _decode(data[f.name], getattr(template, f.name), device)
            for f in dataclasses.fields(template)})
    if _is_namedtuple(template):
        return type(template)(**{k: _decode(data[k], v, device)
                                 for k, v in template._asdict().items()})
    if isinstance(template, dict):
        return {k: _decode(v, template.get(k), device) for k, v in data.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_decode(d, t, device) for d, t in zip(data, template))
    # no template for this node (e.g. None where the file has a value)
    if isinstance(data, torch.Tensor):
        return data if device is None else data.to(device)
    if isinstance(data, list):
        return [_decode(d, None, device) for d in data]
    if isinstance(data, dict):
        return {k: _decode(v, None, device) for k, v in data.items()}
    return data


def save_checkpoint(path: str, tree: Any) -> None:
    """Save a bundle (dicts, lists, tuples, dataclasses, NamedTuples,
    tensors, Python scalars) atomically."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".ckpt.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(_encode(tree), f)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def restore_checkpoint(path: str, template: Any, device=None) -> Any:
    """Restore a bundle saved by :func:`save_checkpoint` into the structure
    of ``template`` (a freshly built bundle). Tensors land on the device of
    the template's tensor at the same place, or on ``device`` where the
    template has none."""
    data = torch.load(path, map_location="cpu", weights_only=True)
    return _decode(data, template, device)
