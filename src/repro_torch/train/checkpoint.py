"""npz checkpoints in the reference's template-free format; port of
``repro/train/checkpoint.py`` (``save``, ``load``, ``restore``,
``latest``, ``flatten_keys``), and ``leaf_shapes``, a file's leaf shapes
read from its schema alone.

A file holds one array per tensor leaf, under its ``||``-joined key path,
and under ``__tree__`` a JSON schema of the tree: dicts, lists, tuples,
``PlannedPair``/``QuantizedLinear`` with their static fields, ``None``
markers, and each array's dtype and shape.  So a planned tree round-trips
with no template.  Nothing here imports JAX: the port keeps its own copy
of the format and writes the reference's dtype names, so each package
reads the other's files.

Dtypes.  The port holds packed int4 words (a ``QuantizedLinear``'s
``qweight``) as int32 bit views of the reference's uint32: they are
written as ``uint32`` and read back as int32 views.  ``np.load`` returns
bfloat16 as 2-byte void (``|V2``) where ``ml_dtypes`` is absent, as on
the card's machine: bfloat16 is written and read through an int16 view.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.quantization import QuantizedLinear
from repro_torch.core.reorder import PlannedPair

SEP = "||"
_TREE_KEY = "__tree__"
_SCHEMA_VERSION = 1
_QLINEAR_FIELDS = ("qweight", "scales", "zeros", "g_idx")
_PAIR_FIELDS = ("up", "gate", "down", "p1_up", "p1_gate", "p2")


def map_tensors(tree: Any, fn: Callable[[str, torch.Tensor], Any],
                key: str = "") -> Any:
    """``tree`` with every tensor ``t`` replaced by ``fn(key, t)``, ``key``
    being its ``||``-joined path (list items by index, plan dataclasses
    by field name)."""
    def sub(child, name):
        return map_tensors(child, fn, f"{key}{SEP}{name}" if key
                           else str(name))

    if torch.is_tensor(tree):
        return fn(key, tree)
    if isinstance(tree, dict):
        return {k: sub(v, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(sub(v, i) for i, v in enumerate(tree))
    if isinstance(tree, QuantizedLinear):
        return dataclasses.replace(tree, **{f: sub(getattr(tree, f), f)
                                            for f in _QLINEAR_FIELDS})
    if isinstance(tree, PlannedPair):
        return dataclasses.replace(tree, **{f: sub(getattr(tree, f), f)
                                            for f in _PAIR_FIELDS})
    return tree


def flatten_keys(tree: Any) -> dict[str, torch.Tensor]:
    """``{key: tensor}`` of every leaf, the keys ``save`` writes."""
    flat = {}

    def put(key, t):
        flat[key] = t
        return t

    map_tensors(tree, put)
    return flat


def _to_numpy(t: torch.Tensor, dtype: str) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    arr = t.numpy()
    return arr.view(np.uint32) if dtype == "uint32" else arr


def _encode(node: Any, leaves: dict, key: tuple = (),
            field: str = "") -> dict:
    """The schema of ``node``; its arrays go into ``leaves``."""
    def sub(child, name, f=""):
        return _encode(child, leaves, key + (str(name),), f)

    if node is None:
        return {"t": "none"}
    if torch.is_tensor(node):
        dtype = ("uint32" if field == "qweight"
                 else str(node.dtype).removeprefix("torch."))
        leaves[SEP.join(key)] = _to_numpy(node, dtype)
        return {"t": "array", "dtype": dtype, "shape": list(node.shape)}
    if isinstance(node, QuantizedLinear):
        return {"t": "qlinear", "group_size": int(node.group_size),
                "kind": node.kind,
                "fields": {f: sub(getattr(node, f), f, f)
                           for f in _QLINEAR_FIELDS}}
    if isinstance(node, PlannedPair):
        return {"t": "pair", "scheme": node.scheme,
                "fields": {f: sub(getattr(node, f), f)
                           for f in _PAIR_FIELDS}}
    if isinstance(node, dict):
        return {"t": "dict", "keys": {str(k): sub(v, k)
                                      for k, v in node.items()}}
    if isinstance(node, (list, tuple)):
        return {"t": "list" if isinstance(node, list) else "tuple",
                "items": [sub(v, i) for i, v in enumerate(node)]}
    raise TypeError(f"cannot checkpoint a {type(node).__name__} at "
                    f"{SEP.join(key)!r}")


def _tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    if dtype == "uint32":
        return torch.from_numpy(arr.view(np.int32))
    return torch.from_numpy(arr.astype(dtype, copy=False))


def _decode(schema: dict, leaves: dict, key: tuple = ()) -> Any:
    t = schema["t"]
    if t == "none":
        return None
    fields = {k: _decode(v, leaves, key + (k,))
              for k, v in schema.get("fields", {}).items()}
    if t == "qlinear":
        return QuantizedLinear(group_size=schema["group_size"],
                               kind=schema["kind"], **fields)
    if t == "pair":
        return PlannedPair(scheme=schema["scheme"], **fields)
    if t == "dict":
        return {k: _decode(v, leaves, key + (k,))
                for k, v in schema["keys"].items()}
    if t in ("list", "tuple"):
        items = [_decode(v, leaves, key + (str(i),))
                 for i, v in enumerate(schema["items"])]
        return items if t == "list" else tuple(items)
    name = SEP.join(key)
    if name not in leaves:
        raise KeyError(f"checkpoint missing leaf {name}")
    arr = leaves[name]
    if list(arr.shape) != schema["shape"]:
        raise ValueError(f"leaf {name}: shape {arr.shape} != schema "
                         f"{schema['shape']}")
    return _tensor(arr, schema["dtype"])


def save(path: str, tree: Any, *, step: int | None = None) -> str:
    """Write ``tree`` (tensors on any device) to ``path`` (.npz, added if
    missing), schema included; with ``step``, to
    ``<path>_stepNNNNNNNN.npz``.  Returns the file written."""
    if step is not None:
        root, ext = os.path.splitext(path)
        path = f"{root}_step{step:08d}{ext or '.npz'}"
    if not path.endswith(".npz"):
        path += ".npz"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    leaves: dict = {}
    schema = _encode(tree, leaves)
    if _TREE_KEY in leaves:
        raise ValueError(f"tree key collides with reserved {_TREE_KEY!r}")
    meta = json.dumps({"version": _SCHEMA_VERSION, "tree": schema})
    np.savez(path, **leaves, **{_TREE_KEY: np.asarray(meta)})
    return path


def _schema(data, path: str) -> dict:
    """The tree schema of an open npz file, its version checked."""
    if _TREE_KEY not in data:
        raise ValueError(f"{path} has no embedded tree schema")
    meta = json.loads(str(data[_TREE_KEY][()]))
    if meta["version"] != _SCHEMA_VERSION:
        raise ValueError(f"{path}: schema v{meta['version']} != "
                         f"supported v{_SCHEMA_VERSION}")
    return meta["tree"]


def load(path: str) -> Any:
    """The tree ``save`` (the port's or the reference's) wrote, as torch
    tensors on the CPU, with the file's structure."""
    with np.load(path) as data:
        schema = _schema(data, path)
        leaves = {k: data[k] for k in data.files if k != _TREE_KEY}
    return _decode(schema, leaves)


def leaf_shapes(path: str) -> dict[str, tuple]:
    """``{key: shape}`` of every leaf ``load`` would return (the keys of
    ``flatten_keys``), from the file's schema alone: no array is read.
    Raises ``ValueError`` where the file's arrays are not the schema's
    leaves."""
    shapes: dict[str, tuple] = {}

    def walk(node: dict, key: tuple):
        if node["t"] == "array":
            shapes[SEP.join(key)] = tuple(node["shape"])
        for k, v in node.get("fields", {}).items():
            walk(v, key + (k,))
        for k, v in node.get("keys", {}).items():
            walk(v, key + (k,))
        for i, v in enumerate(node.get("items", ())):
            walk(v, key + (str(i),))

    with np.load(path) as data:
        walk(_schema(data, path), ())
        files = set(data.files) - {_TREE_KEY}
    if files != set(shapes):
        raise ValueError(f"{path}: arrays {sorted(files ^ set(shapes))[:5]} "
                         f"are not both in the file and in its schema")
    return shapes


def restore(path: str, template: Any) -> Any:
    """The checkpoint at ``path`` in the structure of ``template``: each
    leaf with the template leaf's dtype and device.  The file may hold
    the reference's layout (layers stacked) or the port's (lists of
    layers).  Raises ``KeyError`` for a leaf the file lacks and
    ``ValueError`` for a shape that differs from the template's."""
    from repro_torch.interop import to_port_layout

    flat = flatten_keys(to_port_layout(load(path)))

    def put(key, t):
        if key not in flat:
            raise KeyError(f"checkpoint {path} missing {key}")
        arr = flat[key]
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"{key}: checkpoint shape {tuple(arr.shape)} "
                             f"!= template {tuple(t.shape)}")
        return arr.to(device=t.device, dtype=t.dtype)

    return map_tensors(template, put)


def latest(dirpath: str, prefix: str) -> str | None:
    """Newest ``<prefix>_stepNNNNNNNN.npz`` in ``dirpath`` (None if none)."""
    if not os.path.isdir(dirpath):
        return None
    pat = re.compile(re.escape(prefix) + r"_step(\d+)\.npz$")
    best, best_step = None, -1
    for f in os.listdir(dirpath):
        m = pat.match(f)
        if m and int(m.group(1)) > best_step:
            best, best_step = os.path.join(dirpath, f), int(m.group(1))
    return best
