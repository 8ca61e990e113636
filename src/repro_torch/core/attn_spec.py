"""One frozen spec for the attention entry points — the port of
``repro/core/attn_spec.py``'s :class:`AttnSpec` — and the kernel-profiling
choke point every public attention entry goes through (:func:`attn_entry`).

The reference's spec also carried ``use_kernels`` and ``interpret``; the port
has neither, because a tensor's device picks the path (CUDA tensors run the
Hopper kernels, CPU tensors their plain versions).  The jit-cache machinery
of the reference has no counterpart either: PyTorch runs eagerly."""
from __future__ import annotations

import dataclasses
import functools
import time

import torch

from repro_torch.kernels import softmax_state
from repro_torch.runtime import telemetry


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    """Attention configuration.  ``scale`` is the softmax temperature (set
    per layer by the model); ``rescale=None`` means the process default;
    ``kv_splits=None`` means auto-scheduled."""
    scale: float = 0.0
    mode: str = "etap"             # attention pipeline: etap | standard
    rescale: str | None = None     # online-softmax mode (None = default)
    kv_splits: int | None = None   # split-KV count (None = auto)
    kv_dtype: str = "fp"           # paged pool storage layout
    block: int = 512               # dense KV block size

    def replace(self, **kw) -> "AttnSpec":
        return dataclasses.replace(self, **kw)


FIELDS = tuple(f.name for f in dataclasses.fields(AttnSpec))
_DEFAULTS = AttnSpec()


def _spec_tag(spec: AttnSpec) -> str:
    """Compact spec label for profiler records — the fields that select a
    kernel family, not the full repr."""
    return (f"mode={spec.mode} rescale={spec.rescale} "
            f"kv={spec.kv_dtype} splits={spec.kv_splits}")


def _dtype_name(t) -> str:
    return str(getattr(t, "dtype", "?")).removeprefix("torch.")


def _geometry(args, kw) -> tuple:
    """Hashable (shape, dtype) summary of the tensor arguments — what the
    profiler aggregates launches by.  Dtypes by torch's names without the
    module prefix (``bfloat16``, ``int32``), which are the reference's."""
    geo = []
    for a in args:
        shape = getattr(a, "shape", None)
        if shape is not None:
            geo.append((tuple(shape), _dtype_name(a)))
    for k in sorted(kw):
        shape = getattr(kw[k], "shape", None)
        if shape is not None:
            geo.append((k, tuple(shape), _dtype_name(kw[k])))
    return tuple(geo)


def _sync(args) -> None:
    """Wait for the card where any operand lives on one (no-op on the
    CPU), so a timed launch is charged neither earlier queued work nor
    less than its own."""
    if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
        torch.cuda.synchronize()


# True while a top-level entry runs under an installed profiler: an entry
# called from inside another (a split-KV entry's single-pass branch) is
# part of the outer launch and is neither sampled nor recorded, as the
# reference's inner entries are traced into the outer jit.
_INSIDE = [False]


def attn_entry(*, uses=()):
    """Decorator for the public attention entries (``kernels/*/ops.py``).

    With no profiler installed the call goes straight through (one ``is
    None`` check).  With a :class:`repro_torch.runtime.telemetry
    .KernelProfiler` installed (``--profile-kernels``) every top-level call
    asks :meth:`want`; a sampled one synchronises the card, runs, synchronises
    again and is recorded under (entry name, spec tag, argument geometry)
    with its wall seconds.  The tag is taken from the spec projected onto
    ``uses`` (the other fields at their defaults) with ``rescale`` resolved,
    as the reference's canonicalised spec is.  The decorator never changes
    the call and never catches an exception."""
    keep = frozenset(uses) | {"scale"}

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, spec, **kw):
            prof = telemetry.profiler()
            if prof is None or _INSIDE[0]:
                return fn(*args, spec=spec, **kw)
            _INSIDE[0] = True
            try:
                if not prof.want():
                    return fn(*args, spec=spec, **kw)
                tensors = args + tuple(kw.values())
                _sync(tensors)
                t0 = time.perf_counter()
                out = fn(*args, spec=spec, **kw)
                _sync(tensors)
                dt = time.perf_counter() - t0
                tag = AttnSpec(**{f: getattr(spec if f in keep else _DEFAULTS,
                                             f) for f in FIELDS})
                tag = tag.replace(rescale=softmax_state.resolve(tag.rescale))
                prof.record(fn.__name__, _spec_tag(tag), _geometry(args, kw),
                            dt)
                return out
            finally:
                _INSIDE[0] = False

        return wrapper
    return deco
