"""CollectiveSpec / CollectivePlan: the TP epilogue collective as part of
the deployment plan; port of ``repro/comm/spec.py``.

``CollectiveSpec.parse`` takes the reference's shorthands unchanged:

* ``"psum"`` / ``"psum_scatter"`` / ``"none"``;
* ``"cast"`` or ``"cast:<dtype>"`` (default bfloat16);
* ``"quant-int8[:<block>][:fused][:overlap]"`` (block default 128) and
  ``"quant-int4[:<block>][:fused][:overlap]"`` (block default 32).
  ``:fused`` means the down projection's dequant-GEMM emits ring phase
  1's payload itself (``kernels/dispatch.qmatmul_wire``); ``:overlap``
  the same ring pipelined against the down GEMM one row microbatch at a
  time (``dist/overlap.py``).  The flags parse in either order and print
  ``:fused`` first.

``CollectivePlan`` is the per-layer form,
``"per-layer:<glob>=<spec>[,...][,*=<default>]"``, resolved per pair path
by ordered glob match.  Wire dtypes are torch dtypes.
"""

from __future__ import annotations

import dataclasses
import fnmatch
from typing import Any, Optional, Union

import torch

__all__ = ["CollectiveSpec", "CollectivePlan", "parse_collective"]

_WIRE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float16": torch.float16,
                # CLI aliases; the shorthand always prints the full name
                "f32": torch.float32, "fp32": torch.float32,
                "bf16": torch.bfloat16,
                "f16": torch.float16, "fp16": torch.float16}

def _canon_wire_dtype(dt):
    """A torch dtype from a dtype or its name (None passes)."""
    if dt is None or isinstance(dt, torch.dtype):
        return dt
    try:
        return _WIRE_DTYPES[dt]
    except (KeyError, TypeError):
        raise ValueError(f"unknown wire dtype {dt!r}, expected one of "
                         f"{sorted(_WIRE_DTYPES)}") from None


def dtype_name(dt: torch.dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"`` (the reference's spelling)."""
    return str(dt).removeprefix("torch.")


@dataclasses.dataclass(frozen=True)
class CollectiveSpec:
    """One TP epilogue collective: a strategy name (key into
    ``comm/dispatch.py``), the wire dtype of ``cast`` (and the dtype
    ``bytes_on_wire`` assumes for uncompressed strategies, float32 when
    None), and the block size and payload bits of the quantized rings."""

    name: str = "psum"
    wire_dtype: Optional[Any] = None
    block_size: int = 128
    bits: Optional[int] = None   # None -> the strategy's payload width
    fused: bool = False          # wire payload produced by the GEMM kernel
    overlap: bool = False        # ring pipelined with the down GEMM

    def __post_init__(self):
        from repro_torch.comm import dispatch  # dispatch imports spec

        if self.name not in dispatch.strategies():
            raise ValueError(
                f"unknown collective {self.name!r}; registered strategies: "
                f"{list(dispatch.strategies())}")
        if self.name == "cast" and self.wire_dtype is None:
            object.__setattr__(self, "wire_dtype", torch.bfloat16)
        if self.bits is None:
            object.__setattr__(self, "bits",
                               4 if self.name == "quant-int4" else 8)
        object.__setattr__(self, "wire_dtype",
                           _canon_wire_dtype(self.wire_dtype))
        if self.block_size <= 0:
            raise ValueError(f"block_size must be positive, "
                             f"got {self.block_size}")
        if self.bits not in (4, 8):
            raise ValueError(f"only 4/8-bit payloads are implemented, got "
                             f"bits={self.bits}")
        want_bits = {"quant-int8": 8, "quant-int4": 4}.get(self.name)
        if want_bits is not None and self.bits != want_bits:
            raise ValueError(f"{self.name} carries {want_bits}-bit payloads, "
                             f"got bits={self.bits}")
        if self.fused and self.name not in ("quant-int8", "quant-int4"):
            raise ValueError(
                f"fused wire epilogue only applies to quant-int8/quant-int4 "
                f"collectives, not {self.name!r}")
        if self.overlap and self.name not in ("quant-int8", "quant-int4"):
            raise ValueError(
                f"overlapped epilogue only applies to quant-int8/quant-int4 "
                f"collectives, not {self.name!r}")

    @classmethod
    def parse(cls, value) -> "CollectiveSpec":
        """Parse a spec, a string shorthand, or None (-> default psum)."""
        if value is None:
            return cls()
        if isinstance(value, CollectiveSpec):
            return value
        if not isinstance(value, str):
            raise TypeError(f"expected CollectiveSpec or string shorthand, "
                            f"got {type(value).__name__}")
        name, _, arg = value.partition(":")
        if name == "cast":
            return cls(name="cast", wire_dtype=arg or "bfloat16")
        if name in ("quant-int8", "quant-int4"):
            # "<name>[:<block>][:fused][:overlap]", trailing flags in
            # either order, each at most once
            parts = [p for p in arg.split(":") if p] if arg else []
            flags = set()
            while parts and parts[-1] in ("fused", "overlap"):
                if parts[-1] in flags:
                    raise ValueError(f"collective shorthand {value!r} "
                                     f"repeats the ':{parts[-1]}' flag")
                flags.add(parts.pop())
            if len(parts) > 1:
                raise ValueError(
                    f"collective shorthand {value!r} has too many ':' "
                    f"arguments (expected "
                    f"'<name>[:<block>][:fused][:overlap]')")
            default_block = 128 if name == "quant-int8" else 32
            return cls(name=name, bits=4 if name == "quant-int4" else None,
                       block_size=int(parts[0]) if parts else default_block,
                       fused="fused" in flags, overlap="overlap" in flags)
        if arg:
            raise ValueError(f"collective {name!r} takes no ':' argument "
                             f"(got {value!r})")
        return cls(name=name)

    def with_(self, **kw) -> "CollectiveSpec":
        return dataclasses.replace(self, **kw)

    def shorthand(self) -> str:
        """The string form ``parse`` round-trips."""
        if self.name == "cast":
            return f"cast:{dtype_name(self.wire_dtype)}"
        if self.name in ("quant-int8", "quant-int4"):
            return f"{self.name}:{self.block_size}" + (
                ":fused" if self.fused else "") + (
                ":overlap" if self.overlap else "")
        return self.name

    def resolve(self, pair_path: Optional[str] = None) -> "CollectiveSpec":
        """A bare spec is a one-entry plan: every path resolves to it."""
        return self

    def bytes_on_wire(self, shape, tp: int) -> float:
        """Per-rank bytes on the wire to close a row-TP layer whose
        per-rank partial output has ``shape``, over ``tp`` ranks (ring
        cost model)."""
        from repro_torch.comm import dispatch

        return dispatch.resolve(self.name).bytes_on_wire(
            tuple(shape), int(tp), self)


# ---------------------------------------------------------------------------
# per-layer plans
# ---------------------------------------------------------------------------

_PLAN_PREFIX = "per-layer:"


def _match(path: str, pattern: str) -> bool:
    """Glob-match ``pattern`` against the dotted ``path`` and every dotted
    suffix of it (``"mlp"`` and ``"*.mlp"`` both hit ``"layers.mlp"``)."""
    segs = path.replace("/", ".").split(".")
    return any(fnmatch.fnmatchcase(".".join(segs[i:]), pattern)
               for i in range(len(segs)))


@dataclasses.dataclass(frozen=True)
class CollectivePlan:
    """An ordered ``(path glob, CollectiveSpec)`` map plus a default;
    ``resolve(pair_path)`` returns the first matching entry's spec, else
    the default.  ``*=<spec>`` names the default and must come last."""

    entries: tuple = ()
    default: CollectiveSpec = CollectiveSpec()

    def __post_init__(self):
        ent = []
        for pat, spec in self.entries:
            if not isinstance(pat, str) or not pat:
                raise ValueError(f"plan entry pattern must be a non-empty "
                                 f"string, got {pat!r}")
            ent.append((pat, CollectiveSpec.parse(spec)))
        object.__setattr__(self, "entries", tuple(ent))
        object.__setattr__(self, "default",
                           CollectiveSpec.parse(self.default))

    @classmethod
    def parse(cls, value) -> "CollectivePlan":
        """Parse a plan, a ``per-layer:`` shorthand, or anything
        ``CollectiveSpec.parse`` takes (-> a one-entry plan)."""
        if isinstance(value, CollectivePlan):
            return value
        if not (isinstance(value, str) and value.startswith(_PLAN_PREFIX)):
            return cls(default=CollectiveSpec.parse(value))
        entries, default, saw_default = [], CollectiveSpec(), False
        for item in value[len(_PLAN_PREFIX):].split(","):
            item = item.strip()
            if not item:
                continue
            if saw_default:
                raise ValueError(f"plan entry {item!r} comes after the "
                                 f"catch-all '*=...' and would never match "
                                 f"(in {value!r})")
            pat, sep, short = item.partition("=")
            if not sep or not pat:
                raise ValueError(f"plan entry {item!r} is not "
                                 f"'<glob>=<spec>' (in {value!r})")
            if pat == "*":
                default, saw_default = CollectiveSpec.parse(short), True
            else:
                entries.append((pat, CollectiveSpec.parse(short)))
        return cls(entries=tuple(entries), default=default)

    def shorthand(self) -> str:
        parts = [f"{pat}={spec.shorthand()}" for pat, spec in self.entries]
        parts.append(f"*={self.default.shorthand()}")
        return _PLAN_PREFIX + ",".join(parts)

    def resolve(self, pair_path: Optional[str] = None) -> CollectiveSpec:
        """The spec closing the epilogue at ``pair_path`` (None, an
        anonymous site, gets the default)."""
        if pair_path is not None:
            for pat, spec in self.entries:
                if _match(pair_path, pat):
                    return spec
        return self.default

    def specs(self) -> tuple[CollectiveSpec, ...]:
        """Distinct specs the plan can resolve to, default last."""
        out = []
        for _, spec in self.entries:
            if spec not in out:
                out.append(spec)
        if self.default not in out:
            out.append(self.default)
        return tuple(out)


def parse_collective(value) -> Union[CollectiveSpec, CollectivePlan]:
    """A spec, a plan, or a shorthand of either (None -> psum).  Bare specs
    stay specs; only ``per-layer:`` shorthands and plans give a plan."""
    if isinstance(value, CollectivePlan) or (
            isinstance(value, str) and value.startswith(_PLAN_PREFIX)):
        return CollectivePlan.parse(value)
    return CollectiveSpec.parse(value)
