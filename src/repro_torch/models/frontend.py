"""Modality frontends of the audio and vision backbones (MusicGen,
LLaVA-NeXT) — the port of ``repro/models/frontend.py``.  As in the
reference they are stubs: a batch ``{"embeds": [B, S, d_frontend]}``
brings precomputed frame or patch embeddings, and the frontend is the
projection into the backbone's width.  Decode runs in token space (EnCodec
codes, text tokens) through the embedding table."""
from __future__ import annotations

from repro_torch.models import layers

FRONTEND_DIMS = {"audio": 128, "vision": 1024}


def init_frontend(gen, cfg, dtype, device):
    """{"proj": [d_frontend, d_model]} for a config with a frontend, else
    None."""
    if not cfg.frontend:
        return None
    d_in = FRONTEND_DIMS[cfg.frontend]
    with layers.leaf_scope("frontend"):
        return {"proj": layers.leaf("proj", layers.init_dense(
            gen, d_in, cfg.d_model, dtype, device))}


def apply_frontend(params, embeds, d_model: int | None = None):
    """embeds [B, S, d_frontend] → [B, S, d_model]; a column piece of the
    projection (tensor parallelism) has its outputs gathered into all
    ``d_model`` columns."""
    if d_model is None:
        return layers.dense(embeds, params["proj"])
    return layers.dense_col(embeds, params["proj"], d_model)
