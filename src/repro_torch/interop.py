"""Carry JAX parameters across into the port.

Reads the npz format that ``repro/train/checkpoint.py::save`` writes: one
array per leaf under a ``||``-joined path key, plus a JSON schema of the
tree under ``__tree__`` (dicts, ``PlannedPair``/``QuantizedLinear`` with
their static fields, ``None`` markers, and each array's dtype).  Nothing
here imports JAX; the reader keeps its own copy of the format.

Conversions: uint32 leaves arrive as int32 bit views (the port's packed
word format); bf16 leaves, which ``np.load`` returns as ``|V2`` void,
are read through ``view(np.int16)`` and ``torch.bfloat16``; the layer
stack of a dense model (leaves ``(L, ...)`` under ``layers``) becomes the
port's list of per-layer dicts.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

import numpy as np
import torch

from repro_torch.core.quantization import QuantizedLinear
from repro_torch.core.reorder import PlannedPair
from repro_torch.device import DeviceLike, resolve_device

_SEP = "||"
_TREE_KEY = "__tree__"
_SCHEMA_VERSION = 1


def _tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(
            np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    if dtype == "uint32":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int32))
    return torch.from_numpy(np.ascontiguousarray(arr).astype(dtype,
                                                             copy=False))


def _build(schema: dict, leaves: dict, prefix: tuple = ()) -> Any:
    t = schema["t"]
    if t == "none":
        return None
    fields = {k: _build(v, leaves, prefix + (k,))
              for k, v in schema.get("fields", {}).items()}
    if t == "qlinear":
        return QuantizedLinear(group_size=schema["group_size"],
                               kind=schema["kind"], **fields)
    if t == "pair":
        return PlannedPair(scheme=schema["scheme"], **fields)
    if t == "dict":
        return {k: _build(v, leaves, prefix + (k,))
                for k, v in schema["keys"].items()}
    if t in ("list", "tuple"):
        items = [_build(v, leaves, prefix + (str(i),))
                 for i, v in enumerate(schema["items"])]
        return items if t == "list" else tuple(items)
    key = _SEP.join(prefix)
    if key not in leaves:
        raise KeyError(f"checkpoint missing leaf {key}")
    arr = leaves[key]
    if list(arr.shape) != schema["shape"]:
        raise ValueError(f"leaf {key}: shape {arr.shape} != schema "
                         f"{schema['shape']}")
    return _tensor(arr, schema["dtype"])


def _map_tensors(node: Any, fn) -> Any:
    """Apply ``fn`` to every tensor of a port param tree."""
    if torch.is_tensor(node):
        return fn(node)
    if isinstance(node, dict):
        return {k: _map_tensors(v, fn) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_map_tensors(v, fn) for v in node)
    if isinstance(node, (QuantizedLinear, PlannedPair)):
        return dataclasses.replace(node, **{
            f.name: _map_tensors(getattr(node, f.name), fn)
            for f in dataclasses.fields(node)
            if getattr(node, f.name) is not None
            and f.name not in ("group_size", "kind", "scheme")})
    return node


def unstack_layers(stacked: Any, num_layers: int) -> list:
    """Split a tree of ``(L, ...)`` leaves into ``L`` per-layer trees."""
    return [_map_tensors(stacked, lambda t, i=i: t[i].clone())
            for i in range(num_layers)]


def _read(path: str) -> Any:
    """The tree ``checkpoint.save`` wrote, as torch tensors on the CPU,
    with the reference's structure (stacked layers kept stacked)."""
    with np.load(path) as data:
        if _TREE_KEY not in data:
            raise ValueError(f"{path} has no embedded tree schema")
        meta = json.loads(str(data[_TREE_KEY][()]))
        if meta["version"] != _SCHEMA_VERSION:
            raise ValueError(f"{path}: schema v{meta['version']} != "
                             f"supported v{_SCHEMA_VERSION}")
        leaves = {k: data[k] for k in data.files if k != _TREE_KEY}
    return _build(meta["tree"], leaves)


def load_tree(path: str, *, device: DeviceLike = None) -> Any:
    """The tree ``checkpoint.save`` wrote, with the reference's structure
    (stacked layers kept stacked), on ``device`` (default: the CUDA card;
    raises without one)."""
    dev = resolve_device(device)
    return _map_tensors(_read(path), lambda t: t.to(dev))


def load_params(path: str, *, device: DeviceLike = None) -> dict:
    """A dense model's JAX params (``checkpoint.save`` npz) as the port's
    params on ``device`` (default: the CUDA card; raises without one): the
    layer stack split into a list of layers."""
    dev = resolve_device(device)
    tree = _read(path)
    if "layers" in tree:
        depth = tree["layers"]["ln1"]["scale"].shape[0]
        tree = dict(tree, layers=unstack_layers(tree["layers"], depth))
    return _map_tensors(tree, lambda t: t.to(dev))
