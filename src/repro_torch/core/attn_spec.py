"""One frozen spec for the attention entry points — the port of
``repro/core/attn_spec.py``'s :class:`AttnSpec`.

The reference's spec also carried ``use_kernels`` and ``interpret``; the port
has neither, because a tensor's device picks the path (CUDA tensors run the
Hopper kernels, CPU tensors their plain versions).  The jit-cache machinery
of the reference has no counterpart either: PyTorch runs eagerly."""
from __future__ import annotations

import dataclasses


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
