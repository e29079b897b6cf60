"""Gradients of the port's train loss against ``jax.value_and_grad`` of
the reference's ``loss_fn``, for every smoke config, on the CPU.

The dense model (``quant.mode="none"``) of each of the ten configs, its
params drawn by the reference and carried across (``checkpoint.save`` ->
``interop.load_params``); the same tokens (and, for the audio and vision
families, the trainer's zero bf16 frames / patches); then every leaf's
gradient, in the reference's layout, and the loss.

Tolerances, each leaf's gap against its own max|grad|:

* float32 carry, every family but whisper: within ``GRAD_TOL`` = 1e-4
  (the worst measured: rwkv6's ``tm.bonus_u``, 6.7e-5), the loss within
  1e-6 relative.  Leaves the port gives no gradient (``grad is None``)
  are exactly recurrentgemma's zero-size ``super`` stack below 3 layers,
  whose JAX gradient is a zero-size array.
* whisper: its encoder's carry is the frames' dtype, and the trainer's
  stub is bf16, so its gradients pass through bf16 roundings that the
  two frameworks place apart.  ``test_whisper_gradients_stage_by_stage``
  shows it: with float32 frames every leaf is within ``GRAD_TOL``; with
  the bf16 stub the decoder on the reference's encoder states is within
  ``GRAD_TOL`` and hands the encoder a cotangent within one bf16 ulp
  (2**-8 of its max); the encoder's states are within one bf16 ulp, and
  its leaves, from the reference's cotangent, within ``BF16_TOL``; the
  whole within ``BF16_TOL`` (8.4e-3 measured), the loss within 1e-6.
* the configs' bf16 carry (qwen3-4b smoke): within ``BF16_TOL`` = 2e-2,
  five bf16 ulps (6.25e-3 measured, ``embed.embedding``), the loss
  within 1e-5 relative (2.8e-6 measured).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.core.policy import DEFAULT_POLICY
from repro_torch.launch.train import stubs
from repro_torch.models import whisper
from repro_torch.models.registry import build_model
from repro_torch.train import checkpoint, trainstep

CPU = torch.device("cpu")
GRAD_TOL = 1e-4
LOSS_TOL = 1e-6
BF16_TOL = 2e-2
BF16_ULP = 2.0 ** -8
B, S = 2, 16
WHISPER = "whisper-large-v3"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread (as the other heavy port test files)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np32(t) -> np.ndarray:
    if torch.is_tensor(t):
        return t.detach().to(torch.float32).numpy()
    return np.array(jnp.asarray(t).astype(jnp.float32))


def _gap(ref, got) -> float:
    """|got - ref| max over max|ref| (0 for an all-zero or empty ref)."""
    ref, got = _np32(ref), _np32(got)
    assert ref.shape == got.shape
    scale = float(np.abs(ref).max()) if ref.size else 0.0
    return float(np.abs(got - ref).max()) / scale if scale else 0.0


@pytest.fixture(scope="module")
def carried(tmp_path_factory):
    """(arch, dtype) -> (reference config, reference params, a loader of
    fresh trainable port params carried from them), each drawn once."""
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.models.registry import build_model as jax_build_model
    from repro.train import checkpoint as jck

    made = {}

    def get(arch, dtype="float32"):
        if (arch, dtype) not in made:
            jcfg = jax_smoke_config(arch).with_quant(mode="none").with_(
                dtype=dtype)
            jp = jax.jit(jax_build_model(jcfg).init)(jax.random.PRNGKey(0))
            path = jck.save(str(tmp_path_factory.mktemp("p") / "p.npz"), jp)
            made[arch, dtype] = (jcfg, jp, lambda path=path: (
                trainstep.trainable(interop.load_params(path, device=CPU))))
        return made[arch, dtype]

    return get


def _tokens():
    toks = np.random.default_rng(0).integers(0, 512, (B, S + 1))
    return toks[:, :-1], toks[:, 1:]


def _grads(carried, arch, dtype="float32", stub_dtype=torch.bfloat16):
    """(ref loss, ref grads, port loss, port grads, the port's leaves
    with no gradient, the port's params): the grads flat ``{key: leaf}``
    in the reference's layout."""
    from repro.models.common import REPLICATED
    from repro.models.registry import build_model as jax_build_model
    from repro.train import checkpoint as jck
    from repro.train import trainstep as jts

    jcfg, jp, load = carried(arch, dtype)
    cfg = get_smoke_config(arch).with_quant(mode="none").with_(dtype=dtype)
    tok, lab = _tokens()
    batch = {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab)}
    jbatch = {"tokens": jnp.asarray(tok, jnp.int32),
              "labels": jnp.asarray(lab, jnp.int32)}
    jstub = jnp.bfloat16 if stub_dtype == torch.bfloat16 else jnp.float32
    for k, v in stubs(cfg, B, CPU).items():       # zeros
        batch[k] = v.to(stub_dtype)
        jbatch[k] = jnp.zeros(v.shape, jstub)
    jmodel = jax_build_model(jcfg)
    jl, jg = jax.value_and_grad(
        lambda p: jts.loss_fn(jmodel, p, jbatch, REPLICATED))(jp)
    params = load()
    loss = trainstep.loss_fn(build_model(cfg), params, batch)
    loss.backward()
    none = [k for k, p in checkpoint.flatten_keys(params).items()
            if p.grad is None]
    grads = checkpoint.map_tensors(
        params, lambda _, p: torch.zeros_like(p) if p.grad is None
        else p.grad)
    return (float(jl), jck.flatten_keys(jg), loss.item(),
            checkpoint.flatten_keys(interop.to_reference_layout(grads)),
            none, checkpoint.flatten_keys(params))


def _hold(ref_grads, grads, tol) -> dict:
    assert set(ref_grads) == set(grads)
    gaps = {k: _gap(ref_grads[k], grads[k]) for k in ref_grads}
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= tol, (worst, gaps[worst])
    return gaps


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS if a != WHISPER])
def test_gradients_match_the_reference(carried, arch):
    jl, jg, loss, grads, none, params = _grads(carried, arch)
    assert abs(loss - jl) <= LOSS_TOL * abs(jl), (loss, jl)
    _hold(jg, grads, GRAD_TOL)
    # no gradient only where there is nothing to differentiate
    assert all(params[k].numel() == 0 for k in none), none
    if arch == "recurrentgemma-2b":
        assert none and all(k.startswith("super||") for k in none)
    else:
        assert not none


def test_bf16_carry_gradients(carried):
    """The config's own bf16 carry (qwen3-4b smoke)."""
    jl, jg, loss, grads, _, _ = _grads(carried, "qwen3-4b", "bfloat16")
    assert abs(loss - jl) <= 1e-5 * abs(jl), (loss, jl)
    _hold(jg, grads, BF16_TOL)


def test_whisper_gradients_stage_by_stage(carried):
    from repro.models import common as jcm
    from repro.models import whisper as jw
    from repro.models.common import REPLICATED
    from repro.train import checkpoint as jck
    from repro.train import trainstep as jts

    # 1. float32 frames: the encoder's carry is float32; every leaf agrees
    jl, jg, loss, grads, _, _ = _grads(carried, WHISPER,
                                       stub_dtype=torch.float32)
    assert abs(loss - jl) <= LOSS_TOL * abs(jl)
    _hold(jg, grads, GRAD_TOL)

    # 2. the bf16 stub, the decoder on the reference's encoder states
    jcfg, jp, load = carried(WHISPER)
    cfg = get_smoke_config(WHISPER).with_quant(mode="none").with_(
        dtype="float32")
    tok, lab = _tokens()
    jtok, jlab = jnp.asarray(tok, jnp.int32), jnp.asarray(lab, jnp.int32)
    frames = jnp.zeros((B, jcfg.encoder_seq, jcfg.d_model), jnp.bfloat16)
    dec_keys, enc_keys = ("embed", "dec_layers", "final_norm"), (
        "enc_layers", "enc_norm")

    def jdecoder_loss(dp, enc):
        # the reference's forward after its encoder, on given states
        p = dict(jp, **dp)
        x = jcm.embed_tokens(jcfg, p["embed"], jtok, REPLICATED)
        x = x + jw._sinusoid(S, jcfg.d_model).astype(x.dtype)
        x = jcm.scan_layers(jw._dec_layer(jcfg, REPLICATED), x,
                            p["dec_layers"], REPLICATED, extra=enc)
        x = jcm.apply_norm(jcfg, p["final_norm"], x)
        logits = jcm.lm_head(jcfg, p["embed"], x, REPLICATED)
        return jts.cross_entropy(logits[:, :-1], jlab[:, :-1])

    jenc, enc_vjp = jax.vjp(
        lambda ep: jw.encode(jcfg, dict(jp, **ep), frames, REPLICATED),
        {k: jp[k] for k in enc_keys})
    assert jenc.dtype == jnp.bfloat16
    jl, (jgd, jct) = jax.value_and_grad(jdecoder_loss, argnums=(0, 1))(
        {k: jp[k] for k in dec_keys}, jenc)
    params = load()
    enc = torch.from_numpy(_np32(jenc)).to(torch.bfloat16).requires_grad_()
    logits = whisper.decoder_forward(cfg, params, torch.from_numpy(tok), enc,
                                     DEFAULT_POLICY)
    loss = trainstep.cross_entropy(logits[:, :-1],
                                   torch.from_numpy(lab)[:, :-1])
    loss.backward()
    assert abs(loss.item() - float(jl)) <= LOSS_TOL * abs(float(jl))
    port_dec = checkpoint.flatten_keys(interop.to_reference_layout(
        checkpoint.map_tensors({k: params[k] for k in dec_keys},
                               lambda _, p: p.grad)))
    _hold(jck.flatten_keys(jgd), port_dec, GRAD_TOL)
    assert enc.grad.dtype == torch.bfloat16
    assert _gap(jct, enc.grad) <= BF16_ULP

    # 3. the bf16 stub, the encoder from the reference's cotangent
    for p in checkpoint.flatten_keys(params).values():
        p.grad = None
    states = whisper.encode(cfg, params, torch.zeros(
        (B, jcfg.encoder_seq, jcfg.d_model), dtype=torch.bfloat16),
        DEFAULT_POLICY)
    assert _gap(jenc, states) <= BF16_ULP
    states.backward(torch.from_numpy(_np32(jct)).to(torch.bfloat16))
    (jge,) = enc_vjp(jct)
    port_enc = checkpoint.flatten_keys(interop.to_reference_layout(
        checkpoint.map_tensors({k: params[k] for k in enc_keys},
                               lambda _, p: p.grad)))
    _hold(jck.flatten_keys(jge), port_enc, BF16_TOL)

    # 4. the whole, with the trainer's bf16 stub
    jl, jg, loss, grads, _, _ = _grads(carried, WHISPER)
    assert abs(loss - jl) <= LOSS_TOL * abs(jl)
    _hold(jg, grads, BF16_TOL)
