"""Long sequences in the port, against the reference, on the CPU:

* the Q-chunked einsum forward at S = 8192 (starcoder2-3b's smoke model,
  JAX params carried across as ``tests/test_torch_model.py`` does)
  against JAX's, with and without a window shorter than S, and against
  the port's own unchunked forward bit for bit;
* the rotary embedding at each dense arch's theta over 8192 positions
  against the reference's.

JAX is imported inside the tests and fixtures that run it."""

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import common
from repro_torch.models.registry import build_model
from repro_torch.runtime.serve import Engine

REL_TOL = 5e-3
CPU = torch.device("cpu")
#: the long forward's length: the reference's Q_CHUNK_MIN_SEQ
LONG = 8192
ARCH = "starcoder2-3b"


@pytest.fixture(scope="module")
def carried(tmp_path_factory):
    """activation dtype -> (JAX engine, port engine) of starcoder2's smoke
    model over the same params, each built once."""
    import jax
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.runtime.serve import make_engine as jax_make_engine
    from repro.train import checkpoint as jax_checkpoint

    made = {}

    def get(dtype="bfloat16"):
        if dtype not in made:
            jeng = jax_make_engine(jax_smoke_config(ARCH).with_(dtype=dtype),
                                   jax.random.PRNGKey(0), max_seq=24)
            path = jax_checkpoint.save(
                str(tmp_path_factory.mktemp("ckpt") / "p.npz"), jeng.params)
            teng = Engine(
                model=build_model(get_smoke_config(ARCH).with_(dtype=dtype)),
                params=interop.load_params(path, device=CPU), device=CPU,
                max_seq=24)
            made[dtype] = jeng, teng
        return made[dtype]

    return get


def _rel_gap(got: np.ndarray, ref: np.ndarray) -> float:
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _long_forward(teng, window, monkeypatch):
    """(tokens, the port's forward of one 8192-token sequence, the (query
    rows, key rows) of each ``_sdpa`` call it made)."""
    toks = np.random.default_rng(5).integers(
        0, teng.model.cfg.vocab_size, (1, LONG)).astype(np.int32)
    calls = []
    sdpa = common._sdpa

    def counted(q, k, v, mask):
        calls.append((q.shape[1], k.shape[1]))
        return sdpa(q, k, v, mask)

    monkeypatch.setattr(common, "_sdpa", counted)
    got = teng.model.forward(teng.params,
                             {"tokens": torch.from_numpy(toks).long()},
                             teng.policy, window=window)
    monkeypatch.setattr(common, "_sdpa", sdpa)
    return toks, got, calls


WINDOWS = pytest.mark.parametrize("window", [None, 4096],
                                  ids=["causal", "window"])


@WINDOWS
def test_q_chunked_forward_matches_jax(carried, monkeypatch, window):
    """One 8192-token sequence through starcoder2's smoke model, carried in
    float32: the port runs the einsum attention one 2048-row Q chunk at a
    time (four chunks a layer, each scoring the whole key range) and holds
    JAX's forward (measured 1.7e-5 of max|logit|), with and without a
    window shorter than S.  In the config's bfloat16 the gap is 7.0e-3,
    the port's unchunked forward's too (the next test): a last-bit float32
    difference of a norm's mean flips a bfloat16 rounding in one element
    in 1e5, and each of the 8192 queries sums the keys of thousands of
    positions, so the bf16 tail of the 12-token bound does not carry to
    this length."""
    import jax.numpy as jnp
    from repro.models.common import REPLICATED

    jeng, teng = carried("float32")
    toks, got, calls = _long_forward(teng, window, monkeypatch)
    s, layers = toks.shape[1], teng.model.cfg.num_layers
    assert calls == [(common.Q_CHUNK, s)] * (s // common.Q_CHUNK) * layers
    ref = np.asarray(jeng.model.forward(jeng.params,
                                        {"tokens": jnp.asarray(toks)},
                                        REPLICATED, window=window))
    assert got.shape == ref.shape
    assert _rel_gap(got.numpy(), ref) <= REL_TOL


@WINDOWS
def test_q_chunked_forward_is_the_unchunked_one(carried, monkeypatch,
                                                window):
    """In the config's bfloat16: the chunked forward bit-equal to the same
    forward with chunking turned off (one (S, S) score tensor a layer)."""
    _, teng = carried()
    _, chunked, calls = _long_forward(teng, window, monkeypatch)
    assert len(calls) == 4 * teng.model.cfg.num_layers
    monkeypatch.setattr(common, "Q_CHUNK_MIN_SEQ", 2 * common.Q_CHUNK_MIN_SEQ)
    _, whole, calls = _long_forward(teng, window, monkeypatch)
    assert calls == [(LONG, LONG)] * teng.model.cfg.num_layers
    assert torch.equal(chunked, whole)


def test_q_chunks_only_long_causal_sequences(carried, monkeypatch):
    """The chunked branch takes S >= Q_CHUNK_MIN_SEQ that Q_CHUNK divides,
    causal only: at 8192 + 16 tokens, and non-causal at 8192, one
    unchunked call."""
    from repro.models.common import Q_CHUNK, Q_CHUNK_MIN_SEQ

    assert (common.Q_CHUNK, common.Q_CHUNK_MIN_SEQ) == (Q_CHUNK,
                                                        Q_CHUNK_MIN_SEQ)
    _, teng = carried()
    calls = []
    sdpa = common._sdpa
    monkeypatch.setattr(common, "_sdpa", lambda q, k, v, mask: (
        calls.append(q.shape[1]), sdpa(q, k, v, mask))[1])
    p = teng.params["layers"][0]["attn"]
    cfg = teng.model.cfg
    x = torch.randn(1, common.Q_CHUNK_MIN_SEQ + 16, cfg.d_model)
    common.attention_forward(cfg, p, x)
    common.attention_forward(cfg, p, x[:, :common.Q_CHUNK_MIN_SEQ],
                             causal=False)
    assert calls == [common.Q_CHUNK_MIN_SEQ + 16, common.Q_CHUNK_MIN_SEQ]


@pytest.mark.parametrize("arch", ("granite-3-8b", "starcoder2-3b",
                                  "mistral-large-123b", "qwen3-4b"))
def test_rope_is_the_references(arch):
    """The rotary embedding at the arch's theta over 8192 positions: the
    reference's correctly rounded float32 frequencies, so far positions
    rotate as the reference's do (within float32 cos/sin rounding)."""
    import jax.numpy as jnp
    from repro.models.common import rope as jax_rope

    theta = get_config(arch).rope_theta
    x = np.random.default_rng(9).standard_normal(
        (1, LONG, 2, 128)).astype(np.float32)
    pos = np.arange(LONG)
    ref = np.asarray(jax_rope(jnp.asarray(x), jnp.asarray(pos), theta))
    got = common.rope(torch.from_numpy(x), torch.from_numpy(pos),
                      theta).numpy()
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()
