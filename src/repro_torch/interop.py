"""Carry JAX parameters across into the port, and back.

Files are the npz format of ``repro/train/checkpoint.py::save``, which
``repro_torch/train/checkpoint.py`` reads and writes.  What differs is
the layout: the reference stacks layers along leading dims (for
``lax.scan``), the port holds lists of per-layer dicts.  Each family
module declares where its reference tree stacks layers and how many
leading dims it stacks there (``LAYER_STACKS``: ``layers`` 1 for the
dense and MoE families, ``enc_layers`` and ``dec_layers`` 1 for whisper,
``super`` 1 and ``super.self`` 2 for the vision model, whose
``(n_super, n_self)`` self layers become a list of lists; ``super`` 1
and ``extra`` 1 for recurrentgemma, whose ``extra`` is None when there
are no extra layers).  ``to_port_layout`` and ``to_reference_layout``
convert between the two by those declarations (every family's at once:
a prefix two families share has one depth, ``registry.layer_stacks``).
A stack of length 0 (recurrentgemma's ``super`` below 3 layers) has no
layers to list: it stays a tree of ``(0, ...)`` leaves in both layouts,
which keeps a layer's shapes.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.train import checkpoint


def unstack_layers(stacked: Any, num_layers: int) -> list:
    """Split a tree of ``(L, ...)`` leaves into ``L`` per-layer trees."""
    return [checkpoint.map_tensors(stacked, lambda _, t, i=i: t[i].clone())
            for i in range(num_layers)]


def stack_layers(layers: list) -> Any:
    """The per-layer trees ``layers`` as one tree of ``(L, ...)`` leaves."""
    flats = [checkpoint.flatten_keys(layer) for layer in layers]
    return checkpoint.map_tensors(
        layers[0], lambda key, _: torch.stack([f[key] for f in flats]))


def all_layer_stacks() -> dict:
    """Every family's ``LAYER_STACKS`` as one map."""
    from repro_torch.models.registry import layer_stacks

    return layer_stacks()


def stack_levels(stacks: dict, path: str) -> int:
    """How many leading dims the stacked prefix ``path`` adds to those of
    the longest stacked prefix above it (``super.self``: 2 - 1 = 1)."""
    parts = path.split(".")
    above = next((stacks[p] for p in (".".join(parts[:i])
                                      for i in range(len(parts) - 1, 0, -1))
                  if p in stacks), 0)
    return stacks[path] - above


def _depth(node: Any) -> int:
    return next(iter(checkpoint.flatten_keys(node).values())).shape[0]


def to_port_layout(tree: Any) -> Any:
    """A tree in the reference's layout with each stacked prefix split
    into (nested) lists of per-layer trees; other trees unchanged."""
    stacks = all_layer_stacks()

    def split(node, levels: int, path: str):
        if levels == 0:
            return conv(node, path)
        depth = _depth(node)
        if depth == 0:
            return node
        return [split(item, levels - 1, path)
                for item in unstack_layers(node, depth)]

    def conv(node, path: str):
        if not isinstance(node, dict):
            return node
        out = {}
        for k, v in node.items():
            p = f"{path}.{k}" if path else str(k)
            out[k] = (split(v, stack_levels(stacks, p), p)
                      if p in stacks and isinstance(v, dict)
                      else conv(v, p))
        return out

    return conv(tree, "")


def to_reference_layout(tree: Any) -> Any:
    """A port tree with its (nested) lists of layers stacked at each
    stacked prefix, as the reference holds it; other trees unchanged."""
    stacks = all_layer_stacks()

    def join(node, levels: int, path: str):
        if levels == 0:
            return conv(node, path)
        return stack_layers([join(item, levels - 1, path) for item in node])

    def conv(node, path: str):
        if not isinstance(node, dict):
            return node
        out = {}
        for k, v in node.items():
            p = f"{path}.{k}" if path else str(k)
            out[k] = (join(v, stack_levels(stacks, p), p)
                      if p in stacks and isinstance(v, list)
                      else conv(v, p))
        return out

    return conv(tree, "")


def load_tree(path: str, *, device: DeviceLike = None) -> Any:
    """The tree ``checkpoint.save`` wrote, with the file's structure
    (stacked layers kept stacked), on ``device`` (default: the CUDA card;
    raises without one)."""
    dev = resolve_device(device)
    return checkpoint.map_tensors(checkpoint.load(path),
                                  lambda _, t: t.to(dev))


def load_params(path: str, *, device: DeviceLike = None) -> dict:
    """A model's JAX params (``checkpoint.save`` npz) as the port's params
    on ``device`` (default: the CUDA card; raises without one): the layer
    stacks split into lists of layers."""
    dev = resolve_device(device)
    return checkpoint.map_tensors(to_port_layout(checkpoint.load(path)),
                                  lambda _, t: t.to(dev))
