"""DeploymentArtifact, the prepared plan on disk; port of
``repro/plan/artifact.py``.

One directory per deployment, in the reference's format, so each package
serves the other's artifacts:

* ``manifest.json``: format version, arch id and config hash, the
  policy's fields, the TP degree, the seed, per-pair layout metadata, and
  ``leaf_shards``: the dim of each leaf that was split over the ranks, or
  null for a leaf every rank holds whole;
* ``rank_NN.npz``: rank ``NN``'s planned tree (``train/checkpoint.py``);
* ``aux.npz``: optional V->O attention folds (``{"attn_plans":
  {"layers.attn": PlannedPair}}``, the pair's leaves stacked over the
  layers), written whole and read whole by every rank, as the reference
  does; the engine keeps each rank's heads of the fold its model
  consumes (``runtime/serve.py``).  ``validate`` refuses an aux tree the
  port's model neither consumes nor waives (``ATTN_VO_WAIVED``: whisper's
  encoder and cross folds, the vision model's cross folds, which the
  reference's prepare writes and its runtime leaves unused).

Layout.  The files hold the reference's layout: layers stacked along
leading dims, and ``leaf_shards`` keyed and dimensioned in that stacked
tree (``layers||attn||wq: 2``).  The port's trees hold lists of
per-layer dicts: ``save`` stacks them and ``load`` unstacks, by the
families' ``LAYER_STACKS`` (``interop``), and the split dim of a stacked
leaf is the per-layer dim plus the dims stacked above it (1 under
``layers``, 2 under the vision model's ``super.self``).

Backends.  The manifest names the reference's backends: the port's
``torch`` is ``jnp``, ``cuda`` is ``pallas`` and ``ref`` is ``ref``.
``validate`` compares the scheme, the dtypes and the collective; like the
reference it leaves out ``kv`` and ``mesh`` (it pins the TP degree
alone, so a grid may widen ``dp`` at serve time without a new
prepare), and unlike it, the backend too.  The reference serves with the manifest's backend; the port decides
at load by its own rule (``policy(backend="auto")``: the CUDA kernels on
the card for ordered layouts), because a JAX artifact prepared on a CPU
says ``jnp`` and on the card must still run the kernels.  Every backend
is held to the one oracle, ``kernels/ref.py``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Any, Optional

import torch

from repro_torch import interop
from repro_torch.comm.spec import CollectivePlan
from repro_torch.core.policy import ExecutionPolicy
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dist import loader
from repro_torch.dist.topology import MeshPlan
from repro_torch.train import checkpoint

FORMAT_VERSION = 1
MANIFEST = "manifest.json"
AUX = loader.AUX

#: the reference's name of each of the port's backends
BACKEND_NAMES = {"torch": "jnp", "cuda": "pallas", "ref": "ref"}
_PORT_BACKENDS = {v: k for k, v in BACKEND_NAMES.items()}


class PlanMismatchError(ValueError):
    """A deployment artifact was asked to serve under the wrong plan."""


def config_hash(cfg) -> str:
    """Stable content hash of a ``ModelConfig`` (the reference's)."""
    blob = repr(sorted(dataclasses.asdict(cfg).items()))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def policy_fields(policy: ExecutionPolicy) -> dict:
    """The manifest's view of an ``ExecutionPolicy``, in the reference's
    names (strings only)."""
    return {
        "scheme": policy.scheme,
        "backend": BACKEND_NAMES.get(policy.backend, policy.backend),
        "compute_dtype": str(policy.compute_dtype).removeprefix("torch."),
        "accum_dtype": str(policy.accum_dtype).removeprefix("torch."),
        "collective": policy.collective.shorthand(),
        "kv": policy.kv.shorthand(),
        "mesh": policy.mesh.shorthand(),
    }


def _stacked_key(key: str) -> tuple[str, int]:
    """A port leaf key's key in the reference's stacked tree, and what its
    split dims add there: each list index below a stacked prefix
    (``interop``'s ``LAYER_STACKS``) is a leading dim there:
    ``layers||3||attn||wq`` -> (``layers||attn||wq``, 1),
    ``super||1||self||0||attn||wq`` -> (``super||self||attn||wq``, 2)."""
    stacks = interop.all_layer_stacks()
    kept, path, pending, shift = [], [], 0, 0
    for part in key.split(checkpoint.SEP):
        if pending and part.isdigit():
            pending -= 1
            shift += 1
            continue
        kept.append(part)
        path.append(part)
        dotted = ".".join(path)
        pending = (interop.stack_levels(stacks, dotted)
                   if dotted in stacks else 0)
    return checkpoint.SEP.join(kept), shift


def stacked_shards(leaf_shards: dict) -> dict:
    """``leaf_shards`` keyed by the port's per-layer keys (as
    ``compiler.shard_params`` records them) as the manifest holds them:
    keyed and dimensioned in the stacked tree.  Layers that disagree
    raise."""
    out: dict = {}
    for key, dim in leaf_shards.items():
        skey, shift = _stacked_key(key)
        sdim = None if dim is None else int(dim) + shift
        if out.setdefault(skey, sdim) != sdim:
            raise ValueError(f"layers split {skey!r} along different dims")
    return out


def layer_dim(leaf_shards: dict, key: str) -> Optional[int]:
    """The dim a port leaf (per-layer ``key``) was split along, from the
    manifest's stacked ``leaf_shards``; None: held whole."""
    skey, shift = _stacked_key(key)
    dim = leaf_shards.get(skey)
    return None if dim is None else int(dim) - shift


def _spec_at(specs: Any, key: str):
    """The entry of a ``param_specs`` tree at a leaf key."""
    for part in key.split(checkpoint.SEP):
        if isinstance(specs, list):
            specs = specs[int(part)]
        elif isinstance(specs, dict):
            specs = specs[part]
        else:
            specs = getattr(specs, part)
    return specs


@dataclasses.dataclass(frozen=True)
class DeploymentArtifact:
    """The manifest and the per-rank planned trees (the port's layout).

    ``load`` holds every rank's tree; ``load_rank`` only one rank's (the
    others are None) with the byte ledger ``load_stats``."""

    manifest: dict
    rank_params: tuple = ()
    aux: Optional[dict] = None      # {"attn_plans": {path: PlannedPair}}
    load_stats: Any = None          # dist.loader.RankLoadStats

    # ---- construction -----------------------------------------------------

    @classmethod
    def from_state(cls, *, cfg, policy: ExecutionPolicy, tp: int,
                   rank_params, leaf_shards: dict, pair_meta,
                   seed: Optional[int] = None,
                   extra: Optional[dict] = None, tuner_report=(),
                   aux: Optional[dict] = None) -> "DeploymentArtifact":
        """Freeze the compiler's output: ``rank_params`` the ``tp`` rank
        trees, ``leaf_shards`` keyed as ``compiler.shard_params`` records
        them, ``tuner_report`` the collective tuner's per-site scores
        (the manifest's ``collective_tuner``), ``aux`` the attention
        folds.  ``extra``: the caller's provenance fields (the CLI's
        ``smoke``), merged in, never overriding the plan's."""
        manifest = {
            "format_version": FORMAT_VERSION,
            "arch_id": cfg.arch_id,
            "config_hash": config_hash(cfg),
            "quant": dataclasses.asdict(cfg.quant),
            "policy": policy_fields(policy),
            "tp": int(tp),
            "seed": seed,
            "pairs": list(pair_meta),
            "leaf_shards": stacked_shards(leaf_shards),
        }
        coll = policy.collective
        if isinstance(coll, CollectivePlan):
            manifest["collective_plan"] = {
                "entries": [[pat, spec.shorthand()]
                            for pat, spec in coll.entries],
                "default": coll.default.shorthand()}
        if tuner_report:
            manifest["collective_tuner"] = list(tuner_report)
        if extra:
            manifest = {**extra, **manifest}
        return cls(manifest=manifest, rank_params=tuple(rank_params),
                   aux=aux)

    # ---- accessors --------------------------------------------------------

    @property
    def tp(self) -> int:
        return int(self.manifest["tp"])

    @property
    def scheme(self) -> str:
        return self.manifest["policy"]["scheme"]

    def policy(self, *, backend: Optional[str] = None,
               device: Optional[torch.device] = None) -> ExecutionPolicy:
        """The manifest's plan as a port policy for the artifact's TP
        degree, its recorded ``kv`` layout included.  ``backend``: None
        takes the manifest's, by its port name; ``"auto"`` the port's rule
        for ``device``; any other the backend named."""
        p = self.manifest["policy"]
        kw = dict(compute_dtype=p["compute_dtype"],
                  accum_dtype=p["accum_dtype"], collective=p["collective"],
                  kv=p.get("kv", "dense"), mesh=MeshPlan(tp=self.tp))
        if backend == "auto":
            return ExecutionPolicy.auto(p["scheme"], device=device, **kw)
        if backend is None:
            if p["backend"] not in _PORT_BACKENDS:
                raise PlanMismatchError(
                    f"the artifact's backend {p['backend']!r} has no port "
                    f"counterpart; serve it with backend='auto'")
            backend = _PORT_BACKENDS[p["backend"]]
        return ExecutionPolicy(scheme=p["scheme"], backend=backend, **kw)

    def rank_tree(self, r: int):
        tree = self.rank_params[r]
        if tree is None:
            raise ValueError(f"rank {r}'s file was not loaded by this "
                             f"process (load_rank)")
        return tree

    def params(self):
        """Reassemble the whole planned tree from every rank's slices
        (concatenated along each leaf's recorded dim): bit-equal to the
        tree the compiler sharded."""
        if not self.rank_params or any(t is None for t in self.rank_params):
            raise ValueError("params() needs every rank's tree "
                             "(DeploymentArtifact.load)")
        shards = self.manifest["leaf_shards"]
        flats = [checkpoint.flatten_keys(t) for t in self.rank_params]

        def join(key, leaf):
            dim = layer_dim(shards, key)
            return leaf if dim is None else torch.cat(
                [f[key] for f in flats], dim)

        return checkpoint.map_tensors(self.rank_params[0], join)

    # ---- validation -------------------------------------------------------

    def validate(self, cfg=None, policy: Optional[ExecutionPolicy] = None,
                 tp: Optional[int] = None) -> "DeploymentArtifact":
        """Refuse to serve under a mismatched plan, or what the port cannot
        serve (an aux tree its model does not consume; a leaf held whole
        that the port's model would split).  Raises ``PlanMismatchError``;
        returns self."""
        if self.aux is not None:
            self._check_aux(cfg)
        if cfg is not None:
            if cfg.arch_id != self.manifest["arch_id"]:
                raise PlanMismatchError(
                    f"artifact was compiled for {self.manifest['arch_id']!r}"
                    f", not {cfg.arch_id!r}")
            if config_hash(cfg) != self.manifest["config_hash"]:
                raise PlanMismatchError(
                    f"config hash {config_hash(cfg)} != artifact's "
                    f"{self.manifest['config_hash']}: the model config "
                    "changed since this plan was compiled")
            self._check_shards(cfg)
        if policy is not None:
            want = policy_fields(policy)
            have = dict(self.manifest["policy"])
            for k in ("kv", "mesh", "backend"):
                want.pop(k, None)
                have.pop(k, None)
            if want != have:
                raise PlanMismatchError(
                    f"policy {want} != artifact's plan {have}")
        if tp is not None and int(tp) != self.tp:
            raise PlanMismatchError(
                f"{tp} TP rank(s) != artifact's TP {self.tp}: re-run "
                "prepare for this degree")
        return self

    def _check_aux(self, cfg) -> None:
        """The aux tree must be attention folds (``attn_plans``) at the
        path the model's attention consumes them from, or at paths its
        family waives (with ``cfg``): serving without part of a plan
        would serve another model."""
        from repro_torch.core.reorder import PlannedPair
        from repro_torch.models.registry import build_model

        plans = self.aux.get("attn_plans") if isinstance(self.aux,
                                                         dict) else None
        if (not isinstance(plans, dict) or set(self.aux) != {"attn_plans"}
                or not all(isinstance(p, PlannedPair)
                           for p in plans.values())):
            have = sorted(self.aux) if isinstance(self.aux, dict) else \
                type(self.aux).__name__
            raise PlanMismatchError(
                f"artifact's {AUX} holds {have}, which the port cannot "
                "serve: it serves only attention V->O folds (attn_plans)")
        if cfg is None:
            return
        model = build_model(cfg)
        want = {model.attn_vo_path} if model.supports_attn_vo else set()
        waived = set(model.attn_vo_waived)
        if set(plans) - want - waived:
            raise PlanMismatchError(
                f"artifact's {AUX} folds attention at {sorted(plans)}, "
                f"but the port's {cfg.family} model consumes folds at "
                f"{sorted(want)} only (and waives {sorted(waived)}) and "
                "cannot serve the others")

    def _check_shards(self, cfg) -> None:
        """Each leaf must be split as the port's model splits it at the
        artifact's TP degree.  The reference keeps a leaf whose dim does
        not divide the ranks whole (null), for its loader to assemble; a
        port rank runs on its own slices and sums every split leaf's
        partials over the ranks, so it cannot serve such a copy."""
        from repro_torch.models.registry import build_model

        tree = next((t for t in self.rank_params if t is not None), None)
        if tree is None or self.tp == 1:
            return
        specs = build_model(cfg).param_specs(tree, self.tp)
        shards = self.manifest["leaf_shards"]
        for key in checkpoint.flatten_keys(tree):
            want, have = _spec_at(specs, key), layer_dim(shards, key)
            if want != have:
                skey = _stacked_key(key)[0]
                raise PlanMismatchError(
                    f"leaf {skey!r}: the artifact records split dim "
                    f"{shards.get(skey)} in its stacked tree, but the port "
                    f"splits it along dim {want} (per layer) at tp="
                    f"{self.tp}; a rank cannot serve a leaf held whole that "
                    "its model sums over the ranks")

    # ---- (de)serialization ------------------------------------------------

    def save(self, dirpath: str) -> str:
        """Write the manifest and every rank's file (layers stacked)."""
        if not self.rank_params or any(t is None for t in self.rank_params):
            raise ValueError("cannot save an artifact loaded for one rank: "
                             "this process holds only its own rank's tree")
        os.makedirs(dirpath, exist_ok=True)
        with open(os.path.join(dirpath, MANIFEST), "w") as f:
            json.dump(self.manifest, f, indent=1, sort_keys=True)
        for r, tree in enumerate(self.rank_params):
            checkpoint.save(loader.rank_file(dirpath, r),
                            interop.to_reference_layout(tree))
        if self.aux is not None:
            checkpoint.save(os.path.join(dirpath, AUX), self.aux)
        return dirpath

    @classmethod
    def load_manifest(cls, dirpath: str) -> dict:
        """Read and format-check just ``manifest.json``."""
        mpath = os.path.join(dirpath, MANIFEST)
        if not os.path.exists(mpath):
            raise FileNotFoundError(
                f"{dirpath} is not a deployment artifact (no {MANIFEST})")
        with open(mpath) as f:
            manifest = json.load(f)
        if manifest.get("format_version") != FORMAT_VERSION:
            raise PlanMismatchError(
                f"artifact format v{manifest.get('format_version')} != "
                f"supported v{FORMAT_VERSION}")
        return manifest

    @classmethod
    def load(cls, dirpath: str, *,
             device: DeviceLike = None) -> "DeploymentArtifact":
        """Every rank's tree, in the port's layout, and the aux tree, on
        ``device`` (default: the CUDA card)."""
        dev = resolve_device(device)
        manifest = cls.load_manifest(dirpath)
        ranks = tuple(
            checkpoint.map_tensors(
                interop.to_port_layout(checkpoint.load(
                    loader.rank_file(dirpath, r))), lambda _, t: t.to(dev))
            for r in range(int(manifest["tp"])))
        aux, _ = loader.load_aux(dirpath, device=dev)
        return cls(manifest=manifest, rank_params=ranks, aux=aux)

    @classmethod
    def load_rank(cls, dirpath: str, rank: int, *,
                  device: DeviceLike = None) -> "DeploymentArtifact":
        """Rank ``rank``'s tree alone, read from its own file only
        (``dist.loader.load_per_rank``), and the whole aux tree, with the
        byte ledger."""
        manifest = cls.load_manifest(dirpath)
        tree, stats = loader.load_per_rank(dirpath, manifest, rank,
                                           device=device)
        aux, aux_bytes = loader.load_aux(dirpath, device=device)
        ranks = tuple(tree if r == rank else None
                      for r in range(int(manifest["tp"])))
        return cls(manifest=manifest, rank_params=ranks, aux=aux,
                   load_stats=dataclasses.replace(
                       stats, aux_bytes_loaded=aux_bytes))
