"""Carry JAX parameters across into the port, and back.

Files are the npz format of ``repro/train/checkpoint.py::save``, which
``repro_torch/train/checkpoint.py`` reads and writes.  What differs is
the layout: the reference stacks a dense model's layers along a leading
dim (leaves ``(L, ...)`` under ``layers``, for ``lax.scan``), the port
holds a list of per-layer dicts.  ``to_port_layout`` and
``to_reference_layout`` convert between the two.
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


def to_port_layout(tree: Any) -> Any:
    """A tree in the reference's layout with its layer stack split into
    the port's list of layers (other trees unchanged)."""
    if not isinstance(tree, dict) or not isinstance(tree.get("layers"),
                                                    dict):
        return tree
    leaves = checkpoint.flatten_keys(tree["layers"])
    depth = next(iter(leaves.values())).shape[0]
    return dict(tree, layers=unstack_layers(tree["layers"], depth))


def to_reference_layout(tree: Any) -> Any:
    """A port tree with its list of layers stacked, as the reference
    holds it (other trees unchanged)."""
    if not isinstance(tree, dict) or not isinstance(tree.get("layers"),
                                                    list):
        return tree
    return dict(tree, layers=stack_layers(tree["layers"]))


def load_tree(path: str, *, device: DeviceLike = None) -> Any:
    """The tree ``checkpoint.save`` wrote, with the file's structure
    (stacked layers kept stacked), on ``device`` (default: the CUDA card;
    raises without one)."""
    dev = resolve_device(device)
    return checkpoint.map_tensors(checkpoint.load(path),
                                  lambda _, t: t.to(dev))


def load_params(path: str, *, device: DeviceLike = None) -> dict:
    """A dense model's JAX params (``checkpoint.save`` npz) as the port's
    params on ``device`` (default: the CUDA card; raises without one): the
    layer stack split into a list of layers."""
    dev = resolve_device(device)
    return checkpoint.map_tensors(to_port_layout(checkpoint.load(path)),
                                  lambda _, t: t.to(dev))
