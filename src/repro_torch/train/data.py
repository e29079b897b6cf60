"""Token data: the synthetic stream and the file-backed corpus; port of
``repro/train/data.py``.

The streams are the reference's numpy code, draw for draw, so a seed
gives the same tokens in both packages.  The port runs one process, so
the reference's stripe of the global batch by ``process_index`` is the
whole batch.  Batches land on the CUDA card unless the caller asks for
another device.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass
class DataConfig:
    seq_len: int
    global_batch: int
    vocab_size: int
    seed: int = 0
    path: Optional[str] = None    # None -> synthetic stream


def _synthetic_stream(cfg: DataConfig) -> Iterator[np.ndarray]:
    """Deterministic synthetic corpus: a Zipfian unigram and Markov bigram
    mix (learnable structure, so the loss falls)."""
    rng = np.random.default_rng(cfg.seed)
    v = cfg.vocab_size
    # Zipf unigram
    probs = 1.0 / np.arange(1, v + 1) ** 1.1
    probs /= probs.sum()
    # sparse deterministic bigram: each token has a preferred successor
    succ = rng.permutation(v)
    while True:
        b = rng.random((cfg.global_batch, cfg.seq_len + 1))
        toks = np.empty((cfg.global_batch, cfg.seq_len + 1), np.int64)
        toks[:, 0] = rng.choice(v, size=cfg.global_batch, p=probs)
        for t in range(1, cfg.seq_len + 1):
            follow = b[:, t] < 0.7
            toks[:, t] = np.where(follow, succ[toks[:, t - 1]],
                                  rng.choice(v, size=cfg.global_batch, p=probs))
        yield toks


def _file_stream(cfg: DataConfig) -> Iterator[np.ndarray]:
    """Flat binary (np.uint16 tokens) corpus, windows at random starts."""
    data = np.fromfile(cfg.path, dtype=np.uint16).astype(np.int64)
    if data.size < cfg.seq_len + 1:
        raise ValueError(f"corpus {cfg.path} too small: {data.size} tokens")
    rng = np.random.default_rng(cfg.seed)
    n = data.size - cfg.seq_len - 1
    while True:
        starts = rng.integers(0, n, size=cfg.global_batch)
        yield np.stack([data[s:s + cfg.seq_len + 1] for s in starts])


def batches(cfg: DataConfig, *, device: DeviceLike = None) -> Iterator[dict]:
    """Yields ``{"tokens": (B, S), "labels": (B, S)}`` int64 tensors on
    ``device`` (default: the CUDA card; raises without one): each row's
    labels are its tokens shifted by one."""
    dev = resolve_device(device)
    stream = _file_stream(cfg) if cfg.path else _synthetic_stream(cfg)
    for toks in stream:
        yield {"tokens": torch.from_numpy(toks[:, :-1]).to(dev),
               "labels": torch.from_numpy(toks[:, 1:]).to(dev)}
