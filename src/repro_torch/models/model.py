"""Config-driven LM — the port of ``repro/models/model.py`` for stacks of
attention blocks with a dense (GLU MLP) or MoE FFN (DeepSeek-R1 past its
first 3 layers, DBRX, Llama-4-Maverick), the attention either MLA
(DeepSeek), full-causal GQA (Qwen3, Granite, SmolLM, StableLM, MusicGen,
LLaVA-NeXT, DBRX, Llama-4) or local GQA, for the hybrid RG-LRU /
local-attention stack (RecurrentGemma's rglru, rglru, attn cycle) and for
all-Mamba stacks (falcon-mamba): frontend or embedding → layers → head,
served over the dense cache or (attention-only stacks) the paged one.

The reference stacks each layer group on a leading axis and scans it with
``lax.scan``; the port keeps one parameter dict per layer (and one cache
dict per layer) and loops in Python.  :func:`layer_groups` is kept as the
reference's static plan, which tells the two apart when weights are
converted.  A layer's cache is {"c"} (the MLA latent), {"k", "v"} (GQA;
local attention's holds the last ``window`` rows as a ring) or {"h",
"conv"} (Mamba, RG-LRU).  A frontend (audio, vision) projects a batch's
precomputed embeddings (``{"embeds"}``) into the model's width; serving
decodes in token space.  :func:`verify_step` scores k draft tokens a
sequence in one chunked-prefill-shaped pass over the paged cache (the
serve loop's speculative decoding).  A MoE block routes as the
reference's does: :func:`forward` (and so single-shot :func:`prefill`)
with capacity routing, returning the layer's aux losses; a decode step
(the B tokens one group) and a prompt chunk dropless.

Under a mesh (``launch.mesh.use_mesh``) the weights are each rank's
pieces as ``param_specs(profile="serve")`` places them (tensor
parallelism: :func:`init` under the mesh, or ``rules.place_params``);
:func:`forward`, :func:`prefill` and :func:`decode_step` check the
placement and run the rank's batch rows, each layer reading its head
counts from its pieces and running the collectives the placement needs.
:func:`loss_fn` under a mesh is the rank's part of the sharded train step
(weights placed by ``profile="train"``: TP over `model`, FSDP over
`data`, each block gathering its `data` pieces as it starts): its loss is
the rank's share of the whole batch's, its metrics the whole batch's.

Training: :func:`loss_fn` is the reference's next-token cross-entropy plus
the MoE aux losses.  It unembeds through ``params["embed"]`` upcast inside
the autograd graph, as the reference's ``layers.unembed`` does, so the
tied table gets the logits' gradient; ``embed_f32``, the copy serving
upcasts once, is never read there.  With ``cfg.remat`` each block that
autograd records (grad on, and its input or a parameter requiring grad)
runs under ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``);
serving, whose parameters require no grad, never reaches it.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import mla as mla_mod
from repro_torch.core.attn_spec import AttnSpec
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.mesh import get_mesh
from repro_torch.models import attention, frontend, layers, mamba, moe, rglru
from repro_torch.runtime import paged_cache
from repro_torch.sharding import rules

AUX_KEYS = ("load_balance", "router_z")


# ------------------------------------------------------------- layer groups
def signatures(cfg) -> list:
    """(kind, is_moe) per layer."""
    return [(k, bool(cfg.moe_layer(i)) and k == "attn")
            for i, k in enumerate(cfg.layer_kinds())]


def _rle(seq):
    runs = []
    for s in seq:
        if runs and runs[-1][0] == s:
            runs[-1][1] += 1
        else:
            runs.append([s, 1])
    return [(s, n) for s, n in runs]


def layer_groups(cfg) -> list:
    """The reference's static plan: list of {"sigs": [sig,...], "n": repeats}."""
    sigs = signatures(cfg)
    runs = _rle(sigs)
    if len(runs) <= 4:
        return [{"sigs": [s], "n": n} for s, n in runs]
    for p in range(1, 7):                              # periodic superblock
        if all(sigs[i] == sigs[i % p] for i in range(len(sigs))):
            n = len(sigs) // p
            groups = [{"sigs": sigs[:p], "n": n}]
            groups += [{"sigs": [s], "n": 1} for s in sigs[n * p:]]
            return groups
    return [{"sigs": [s], "n": 1} for s in sigs]       # fallback: unrolled


def layer_stacks(cfg) -> list:
    """The layers the reference stacks into one leaf: for each group of
    :func:`layer_groups` and each block j of it, the indices of the
    port's layers that hold its n repeats (repeat i of a group with p
    blocks runs as layer offset + i·p + j, the order
    :func:`repro_torch.models.convert.params_from_jax` unstacks in).  A
    statistic the reference takes over a whole stacked leaf (Adafactor's
    update clipping) is taken over these layers."""
    stacks, off = [], 0
    for g in layer_groups(cfg):
        p = len(g["sigs"])
        stacks += [[off + i * p + j for i in range(g["n"])]
                   for j in range(p)]
        off += p * g["n"]
    return stacks


_BLOCK_KINDS = ("attn", "rglru", "ssm")


def check_ported(cfg) -> None:
    """Raise unless the stack is one the port serves: attention blocks (MLA,
    full or local GQA) with a dense MLP or a MoE FFN, RG-LRU blocks with a
    dense MLP, or Mamba blocks, behind the embedding or a frontend (the
    reference's ``_init_block`` raises on any other block kind)."""
    for i, kind in enumerate(cfg.layer_kinds()):
        if kind not in _BLOCK_KINDS:
            raise NotImplementedError(
                f"{cfg.name}: layer {i} is a {kind!r} block, which has no "
                "port")


# ------------------------------------------------------------------- init
def _init_block(gen, cfg, sig, dtype, device):
    kind, is_moe = sig
    D = cfg.d_model

    def norm(name):
        return layers.leaf(name, torch.zeros(D, dtype=dtype, device=device))

    def sub(name, fn, *a):
        with layers.leaf_scope(name):
            return fn(gen, *a, dtype, device)
    if kind == "ssm":                  # a Mamba block has no FFN
        return {"norm1": norm("norm1"),
                "mix": sub("mix", mamba.init_mamba, cfg)}
    if kind == "rglru":
        mix = rglru.init_rglru
    else:
        mix = (mla_mod.init_mla if cfg.attention_kind == "mla"
               else attention.init_attention)
    return {
        "norm1": norm("norm1"),
        "mix": sub("mix", mix, cfg),
        "norm2": norm("norm2"),
        "ffn": (sub("ffn", moe.init_moe, cfg) if is_moe else
                sub("ffn", layers.init_mlp, cfg.d_model, cfg.d_ff)),
    }


def _draw(cfg, seed: int, device) -> dict:
    """:func:`init`'s draws, each leaf through ``layers.leaf`` as it is
    drawn."""
    dtype = cfg.torch_dtype
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = {
        "embed": layers.leaf("embed", layers.init_embed(
            gen, cfg.vocab_size, cfg.d_model, dtype, device)),
        "final_norm": layers.leaf("final_norm", torch.zeros(
            cfg.d_model, dtype=dtype, device=device)),
    }
    fe = frontend.init_frontend(gen, cfg, dtype, device)
    if fe is not None:
        params["frontend"] = fe
    layer_list = []
    for i, sig in enumerate(signatures(cfg)):
        with layers.leaf_scope("layers"), layers.leaf_scope(i):
            layer_list.append(_init_block(gen, cfg, sig, dtype, device))
    params["layers"] = layer_list
    # the upcast of the (piece of the) table: the piece of the upcast
    params["embed_f32"] = layers.unembed_table(params["embed"])
    return params


def init(cfg, *, seed: int = 0, device="cuda",
         profile: str = "serve") -> dict:
    """Random parameters from a seeded ``torch.Generator`` on ``device``
    (the port's own stream: it does not reproduce the reference's
    ``jax.random`` draws — use :mod:`repro_torch.models.convert` for the
    reference's weights).  ``embed_f32`` is the unembedding table, upcast
    once here; a config with a frontend also gets its projection
    ``frontend``.

    Under a mesh (``launch.mesh.use_mesh``) each leaf is drawn whole from
    the same generator, cut to this rank's piece by its
    ``param_specs(profile=profile)`` spec and freed before the next is
    drawn; a MoE expert stack is drawn in blocks of experts, of which the
    rank keeps only its experts and its slices of them
    (``layers.leaf_part``).  The result is bitwise
    ``rules.place_params(init(cfg), mesh, profile=profile)``, without the
    whole tree, or a whole expert stack, ever on the device."""
    check_ported(cfg)
    mesh = get_mesh()
    if mesh is None:
        return _draw(cfg, seed, device)
    check_tensor_parallel(cfg, mesh)
    specs = {}

    def spec(path, shape):
        return rules.leaf_spec(path, torch.empty(shape, device="meta"), mesh,
                               profile=profile)

    def put(path, t, whole):
        if whole is None:
            piece, specs[path] = rules.place_leaf(path, t, mesh,
                                                  profile=profile)
            return piece
        specs[path] = spec(path, whole)
        if tuple(t.shape) != rules.local_shape(whole, specs[path], mesh):
            raise AssertionError(f"{path}: a part of {tuple(t.shape)} for "
                                 f"the spec {specs[path]} of {whole}")
        return t

    def part(path, shape):
        return rules.local_slices(shape, spec(path, shape), mesh)
    with layers.placing(put, part):
        params = _draw(cfg, seed, device)
    specs["embed_f32"] = specs["embed"]

    def spec_of(path, t):      # a leaf drawn outside layers.leaf: whole
        if path not in specs:
            t_placed, specs[path] = rules.place_leaf(path, t, mesh,
                                                     profile=profile)
            if t_placed is not t:
                raise AssertionError(f"{path} was drawn whole and is cut")
        return specs[path]
    return rules.Placed(params, mesh.shape,
                        rules._tree_map_with_path(spec_of, params), profile)


def check_tensor_parallel(cfg, mesh, *, cache: bool = False) -> None:
    """Raise unless the port runs ``cfg`` with its weights placed by
    ``param_specs`` on ``mesh``: a head weight whose `model` piece cuts a
    head or whose heads the other head weights do not cut alike (ROADMAP
    A10b.1) raises ``NotImplementedError``, and so (``cache``: a path that
    builds or reads a serving cache) does a Mamba or RG-LRU block under a
    `model` axis of more than one rank, whose state's placement is not
    ported (ROADMAP A10b.5); their full-sequence forward runs on the
    rank's channels.  A MoE layer's experts run under either profile's
    placement: over `data` (serving, ``moe.moe_ffn``'s expert
    parallelism, F over `model`) or over `model` (training)."""
    n = mesh.shape.get("model", 1)
    if n == 1:
        return
    kinds = set(cfg.layer_kinds())
    if cache and kinds & {"ssm", "rglru"}:
        raise NotImplementedError(
            f"{cfg.name}: a serving cache of {sorted(kinds & {'ssm', 'rglru'})}"
            f" blocks under a `model` axis of {n}: their state's placement "
            "is not yet ported (ROADMAP A10b.5)")
    if "attn" not in kinds:
        return
    if cfg.attention_kind == "mla":
        m = cfg.mla
        groups = {"heads": (cfg.num_heads, {
            "w_uq": m.qk_head_dim, "w_uk": m.qk_nope_head_dim,
            "w_uv": m.v_head_dim, "w_o": m.v_head_dim})}
    else:
        hd = cfg.resolved_head_dim
        groups = {"heads": (cfg.num_heads, {"w_q": hd, "w_o": hd}),
                  "kv heads": (cfg.num_kv_heads, {"w_k": hd, "w_v": hd})}
    cut = {}
    for what, (heads, widths) in groups.items():
        for name, width in widths.items():
            cut[name] = heads * width % n == 0     # _fit keeps `model`
            if cut[name] and heads % n:
                raise NotImplementedError(
                    f"{cfg.name}: the serve spec cuts {name}'s {heads} "
                    f"{what} of width {width} into {n} pieces of "
                    f"{heads * width // n} columns, which cuts a head: not "
                    "yet ported (ROADMAP A10b.1)")
    if len(set(cut.values())) > 1:
        raise NotImplementedError(
            f"{cfg.name}: on a `model` axis of {n} the serve specs cut "
            f"{sorted(k for k, c in cut.items() if c)} but not "
            f"{sorted(k for k, c in cut.items() if not c)}: not yet ported "
            "(ROADMAP A10b.1)")


def _check_mesh(params, cfg, *, cache: bool = True):
    """The current mesh (None outside one), after checking that
    ``params`` were placed for it and that the port runs ``cfg`` so
    placed (``cache``: on a path that builds or reads a serving cache,
    which takes weights placed by the serve profile)."""
    mesh = get_mesh()
    if mesh is not None:
        rules.check_placed(params, mesh)
        check_tensor_parallel(cfg, mesh, cache=cache)
        if cache and getattr(params, "profile", "serve") != "serve":
            raise ValueError(
                f"weights placed by profile {params.profile!r} on a serving "
                "path: serve with weights placed by profile \"serve\"")
    return mesh


# ---------------------------------------------------------- full sequence
def _zero_aux(device):
    return {k: torch.zeros((), dtype=torch.float32, device=device)
            for k in AUX_KEYS}


def _block_seq(lp, cfg, sig, x, positions, collect_cache: bool,
               lspec=None, batch_axes=(), moe_kw=None):
    """One block over a full sequence.  Returns (x, aux, cache rows or {});
    a MoE block routes with capacity (the training route, which single-shot
    prefill reuses) and returns its aux losses, any other block zeros.
    ``lspec``: the block's specs where its weights are placed by the train
    profile (its `data` pieces are gathered first: ``layers.unshard``);
    ``batch_axes``: the mesh axes the batch's rows are cut over, whose MoE
    aux losses are this rank's shares of the whole batch's;
    ``moe_kw``: ``moe.moe_ffn``'s placement keywords
    (:func:`_moe_layout`)."""
    kind, is_moe = sig
    lp = layers.unshard(lp, lspec, get_mesh())
    aux = _zero_aux(x.device)
    h = layers.rms_norm(x, lp["norm1"], cfg.norm_eps)
    if kind in ("ssm", "rglru"):
        fn = mamba.mamba_seq if kind == "ssm" else rglru.rglru_seq
        if collect_cache:
            mixed, cache = fn(lp["mix"], cfg, h, return_state=True)
        else:
            mixed, cache = fn(lp["mix"], cfg, h), {}
    else:
        fn = (mla_mod.mla_train if cfg.attention_kind == "mla"
              else attention.attention_train)
        if collect_cache:
            mixed, cache = fn(lp["mix"], cfg, h, positions,
                              return_cache=True)
        else:
            mixed, cache = fn(lp["mix"], cfg, h, positions), {}
    x = x + mixed
    if kind == "ssm":                  # a Mamba block has no FFN
        return x, aux, cache
    h2 = layers.rms_norm(x, lp["norm2"], cfg.norm_eps)
    if is_moe:
        f, aux = moe.moe_ffn(lp["ffn"], cfg, h2, batch_axes=batch_axes,
                             **(moe_kw or {}))
    else:
        f = layers.mlp(lp["ffn"], h2, cfg.d_ff)
    return x + f, aux, cache


def _moe_layout(lspec, data_dim) -> dict:
    """``moe.moe_ffn``'s placement keywords for a MoE block whose specs
    are ``lspec`` (None: whole weights): the mesh axis its expert stacks
    are cut over, and with experts over `data` the dim of its input that
    `data` cuts (``data_dim``, None where every `data` rank holds it)."""
    mesh = get_mesh()
    if lspec is None or mesh is None:
        return {}
    entry = lspec["ffn"]["w_gate"][0]
    if rules.extent(entry, mesh) == 1:
        return {}
    (axis,) = rules._axes(entry)
    return {"expert_axis": axis,
            **({"data_dim": data_dim} if axis == "data" else {})}


def _data_rows(B: int, mesh) -> bool:
    """Whether the serve path cuts a batch of B rows over `data` on
    ``mesh`` (:func:`rank_batch`, ``rules.cache_specs``' batch entry)."""
    return mesh is not None and mesh.shape.get("data", 1) > 1 and \
        "data" in rules._axes(rules._fit(rules.batch_axes(mesh), B, mesh))


def _block_in(mesh, *args):
    """:func:`_block_seq` under ``mesh`` (None: no mesh).  A checkpointed
    block's recompute runs inside the backward pass, on the autograd
    engine's thread for CUDA tensors, where the current mesh (a context
    variable) is not set."""
    if mesh is None:
        return _block_seq(*args)
    with mesh_mod.use_mesh(mesh):
        return _block_seq(*args)


def _embed_inputs(params, cfg, batch):
    """A batch {"tokens": [B,S]} (or the tokens themselves) through the
    embedding table, or {"embeds": [B,S,d_frontend]} through the frontend's
    projection."""
    if isinstance(batch, dict) and "embeds" in batch:
        return frontend.apply_frontend(params["frontend"], batch["embeds"],
                                       cfg.d_model)
    tokens = batch["tokens"] if isinstance(batch, dict) else batch
    return layers.embed(params["embed"], tokens, cfg.vocab_size)


def _rank_rows(t, mesh, *, exact: bool = False):
    """This rank's batch rows of ``t`` [B, ...] (``rules.cache_specs``'
    batch entry: all of them where B does not divide; ``exact``: a B the
    batch axes do not divide raises)."""
    spec = rules.P(rules._fit(rules.batch_axes(mesh), t.shape[0], mesh))
    n = math.prod(mesh.shape[a] for a in rules.batch_axes(mesh))
    if exact and rules.extent(spec[0], mesh) != n:
        raise ValueError(f"a batch of {t.shape[0]} rows over {n} data "
                         f"ranks of {mesh}: the rows must divide")
    return rules.local_rows(t, spec, mesh)


def _batch_rows(batch) -> int:
    """The rows of a batch as :func:`forward` takes it."""
    return (next(iter(batch.values())) if isinstance(batch, dict)
            else batch).shape[0]


def rank_batch(batch, mesh, *, exact: bool = False):
    """A batch as :func:`forward` takes it, cut to this rank's rows."""
    if isinstance(batch, dict):
        return {k: _rank_rows(v, mesh, exact=exact) for k, v in batch.items()}
    return _rank_rows(batch, mesh, exact=exact)



def _requires_grad(tree) -> bool:
    """Whether a tensor of a parameter tree requires grad."""
    if isinstance(tree, torch.Tensor):
        return tree.requires_grad
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, (list, tuple)):
        return False
    return any(_requires_grad(t) for t in tree)


def _hidden(params, cfg, batch, collect_cache: bool, batch_axes=(),
            data_rows: bool = False):
    """The final-normed hidden states [B,S,D] of a full sequence (a batch
    as :func:`_embed_inputs` takes it), the per-layer cache rows and the
    aux losses summed over the layers.  Placed weights are gathered over
    `data` where their spec names it, a block's as the block starts
    (inside its checkpoint, so remat gathers them again).
    ``data_rows``: the batch is this rank's rows over `data`
    (:func:`_block_seq`)."""
    check_ported(cfg)
    specs = getattr(params, "specs", None)
    mesh = get_mesh()
    fsdp = getattr(params, "profile", None) == "train"
    top = layers.unshard({k: v for k, v in params.items() if k not in (
        "layers", "embed_f32")}, specs if fsdp else None, mesh)
    x = _embed_inputs(top, cfg, batch)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None, :].expand(B, S)
    caches, aux_total = [], _zero_aux(x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    lspecs = specs["layers"] if specs is not None else [None] * len(
        params["layers"])
    for lp, sig, lspec in zip(params["layers"], signatures(cfg), lspecs,
                              strict=True):
        kw = _moe_layout(lspec, 0 if data_rows else None) if sig[1] else {}
        args = (lp, cfg, sig, x, positions, collect_cache,
                lspec if fsdp else None, batch_axes, kw)
        if remat and (x.requires_grad or _requires_grad(lp)):
            x, a, c = checkpoint(_block_in, mesh, *args, use_reentrant=False)
        else:
            x, a, c = _block_seq(*args)
        aux_total = {k: aux_total[k] + a[k] for k in AUX_KEYS}
        caches.append(c)
    x = layers.rms_norm(x, top["final_norm"], cfg.norm_eps)
    return x, caches, aux_total


def forward(params, cfg, batch, *, collect_cache: bool = False):
    """Full-sequence forward.  batch: tokens [B,S], {"tokens": [B,S]} or
    {"embeds": [B,S,d_frontend]}.  Returns (logits [B,S,V] fp32, aux
    {"load_balance", "router_z"} summed over the layers, the per-layer
    cache rows when ``collect_cache`` else None).  Under a mesh
    (``params`` placed for it: ``rules.place_params`` or :func:`init`
    under the mesh) the rank runs its batch rows of the whole batch, its
    pieces of the weights with their collectives, and returns its rows'
    logits over the whole vocabulary."""
    mesh = _check_mesh(params, cfg, cache=collect_cache)
    rows = _data_rows(_batch_rows(batch), mesh)
    if mesh is not None:
        batch = rank_batch(batch, mesh)
    x, caches, aux = _hidden(params, cfg, batch, collect_cache,
                             data_rows=rows)
    logits = layers.unembed(params["embed_f32"], x, cfg.vocab_size)
    return logits, aux, (caches if collect_cache else None)


def loss_fn(params, cfg, batch):
    """Next-token cross-entropy plus the MoE aux losses (0.01 ·
    load_balance + 0.001 · router_z), the reference's.  batch: {"tokens":
    [B,S]} or {"embeds": [B,S,d_frontend], "targets": [B,S]}.  The logits
    are fp32 from ``params["embed"]`` upcast in the graph (the unembedding
    is an fp32 product: TF32 stays off, PyTorch's default).  Returns
    (loss, {"nll", "load_balance", "router_z"}).

    Under a mesh (``params`` placed for it, by either profile) ``batch``
    is this rank's rows of the whole batch (:func:`rank_batch` with
    ``exact``: the data ranks must divide the rows).  Its loss is its
    share of the whole batch's: the step's loss is the sum of the data
    ranks' (``launch.mesh``'s convention), so each term's mean is over
    the whole batch, the vocab-parallel cross-entropy's
    (``layers.vocab_nll``) and the MoE aux losses' alike.  The metrics
    are the whole batch's (the shares summed over the batch axes, with no
    gradient)."""
    mesh = get_mesh()
    if mesh is None:
        x, _, aux = _hidden(params, cfg, batch, collect_cache=False)
        logits = layers.unembed(layers.unembed_table(params["embed"]), x)
        targets = batch["targets"] if "targets" in batch else batch["tokens"]
        lp = torch.log_softmax(logits[:, :-1, :], dim=-1)
        nll = -torch.gather(lp, -1, targets[:, 1:, None].long())[..., 0]
        loss = nll.mean()
        total = loss + 0.01 * aux["load_balance"] + 0.001 * aux["router_z"]
        return total, {"nll": loss, **aux}
    _check_mesh(params, cfg, cache=False)
    axes = tuple(a for a in rules.batch_axes(mesh) if mesh.shape[a] > 1)
    n_data = math.prod(mesh.shape[a] for a in axes)
    x, _, aux = _hidden(params, cfg, batch, collect_cache=False,
                        batch_axes=axes)
    targets = batch["targets"] if "targets" in batch else batch["tokens"]
    table = layers.unshard({"embed": params["embed"]}, getattr(
        params, "specs", None), mesh)["embed"]
    nll = layers.vocab_nll(table, x[:, :-1], targets[:, 1:], cfg.vocab_size)
    share = nll.sum() / (nll.numel() * n_data)
    total = share + 0.01 * aux["load_balance"] + 0.001 * aux["router_z"]
    metrics = {"nll": share, **aux}
    with torch.no_grad():
        flat = torch.stack([metrics[k].detach().float()
                            for k in ("nll", *AUX_KEYS)])
        for a in axes:
            mesh_mod.all_reduce(flat, torch.distributed.ReduceOp.SUM, mesh, a)
    return total, dict(zip(("nll", *AUX_KEYS), flat.unbind(), strict=True))


# ----------------------------------------------------------------- serving
def _whole_cache(cfg, batch: int, max_len: int, device):
    dtype = cfg.torch_dtype

    def one(kind):
        if kind == "ssm":
            return mamba.init_mamba_cache(cfg, batch, dtype, device=device)
        if kind == "rglru":
            return rglru.init_rglru_cache(cfg, batch, dtype, device=device)
        if cfg.attention_kind == "mla":
            return mla_mod.init_mla_cache(cfg, batch, max_len, dtype,
                                          device=device)
        return attention.init_attention_cache(cfg, batch, max_len, dtype,
                                              device=device)
    return [one(kind) for kind in cfg.layer_kinds()]


_SEQ_KEYS = ("c", "k", "v")           # the attention caches [B, S, ...]


def _rank_specs(cache, mesh):
    """``rules.cache_specs`` of a whole dense cache, checked against what
    this slice applies: the batch entry, and the S entry of an attention
    cache.  Any other entry that splits a dim (a Mamba state over `model`,
    an RG-LRU state) raises."""
    specs = rules.cache_specs(cache, mesh)
    for i, (layer, lspec) in enumerate(zip(cache, specs, strict=True)):
        for key, spec in lspec.items():
            for dim, entry in enumerate(spec or ()):
                axes = entry if isinstance(entry, tuple) else (entry,)
                split = math.prod(mesh.shape[a] for a in axes if a)
                if split > 1 and dim > 0 and not (
                        dim == 1 and key in _SEQ_KEYS):
                    raise NotImplementedError(
                        f"layer {i} {key!r} {tuple(layer[key].shape)}: "
                        f"cache_specs splits dim {dim} over {entry} on "
                        f"{mesh}; not yet ported (ROADMAP A10b.5)")
    return specs


def _rank_layer(layer, lspec, rows_of):
    """One layer's rank cache: each tensor from ``rows_of(t, spec)``, and
    the whole S under "seq_rows" where the spec shards S."""
    out = {key: rows_of(t, lspec[key]) for key, t in layer.items()}
    for key in _SEQ_KEYS:
        if key in layer and lspec[key][1] is not None:
            out["seq_rows"] = layer[key].shape[1]
            break
    return out


def init_cache(cfg, batch: int, max_len: int, *, device="cuda"):
    """Dense serving cache, one dict per layer: {"c": [batch, max_len,
    latent]} for an MLA layer, {"k", "v": [batch, max_len, K, hd]} for a
    GQA layer (local attention: min(max_len, window) rows, a ring), the
    recurrent state {"h", "conv"} for an ssm or RG-LRU layer.  Under a
    mesh (``launch.mesh.use_mesh``) each rank gets its piece by
    ``rules.cache_specs``: batch / n_data rows, and S / n_model rows of an
    attention cache where ``seq_shardable`` (the whole S then under
    "seq_rows")."""
    check_ported(cfg)
    mesh = get_mesh()
    if mesh is None:
        return _whole_cache(cfg, batch, max_len, device)
    whole = _whole_cache(cfg, batch, max_len, "meta")
    specs = _rank_specs(whole, mesh)
    return [_rank_layer(layer, lspec, lambda t, spec: torch.zeros(
        rules.local_shape(t.shape, spec, mesh), dtype=t.dtype,
        device=device)) for layer, lspec in zip(whole, specs, strict=True)]


def shard_cache(cache, mesh=None):
    """This rank's piece of a whole dense cache (:func:`prefill`'s, or
    :func:`init_cache`'s outside a mesh) by ``rules.cache_specs`` on
    ``mesh`` (default the current one), as :func:`init_cache` places it
    under the mesh: each piece a contiguous copy."""
    mesh = mesh or get_mesh()
    specs = _rank_specs(cache, mesh)
    return [_rank_layer(layer, lspec, lambda t, spec: rules.local_rows(
        t, spec, mesh).clone(memory_format=torch.contiguous_format))
        for layer, lspec in zip(cache, specs, strict=True)]


def _pad_cache_rows(cfg, kind, cache_rows, max_len):
    """Pad one layer's prefill cache rows ({"c": [B,S,latent]} or {"k",
    "v": [B,S,K,hd]}) out to the serving length along S (a Mamba or RG-LRU
    layer's state passes as it is).  Local attention keeps a ring of n =
    min(max_len, window) rows: a longer prompt keeps its last n rows, at
    slots 0..n-1, where decode's ``pos % n`` finds them because the prompt
    is a multiple of the window (local_attention's condition)."""
    if kind != "attn":
        return cache_rows
    n = max_len
    if cfg.attention_kind == "local":
        n = min(max_len, cfg.window_size)
        cache_rows = {key: rows[:, -n:] for key, rows in cache_rows.items()}
    return {key: torch.nn.functional.pad(
        rows, (0, 0) * (rows.dim() - 2) + (0, n - rows.shape[1]))
        for key, rows in cache_rows.items()}


def _place_rows(cache, batch: int, mesh):
    """A cache of this rank's batch rows (of a whole batch of ``batch``)
    cut as :func:`init_cache` places it under ``mesh``: the S slice of an
    attention cache where ``rules.cache_specs`` of the whole cache
    sequence-shards it (the whole S under "seq_rows"), each piece a
    contiguous copy."""
    whole = [{k: torch.empty((batch, *t.shape[1:]), dtype=t.dtype,
                             device="meta") for k, t in layer.items()}
             for layer in cache]
    specs = _rank_specs(whole, mesh)

    def rows_of(t, spec):
        if all(e is None for e in spec[1:]):
            return t
        return rules.local_rows(t, rules.P(None, *spec[1:]), mesh).clone(
            memory_format=torch.contiguous_format)
    return [_rank_layer(layer, lspec, rows_of)
            for layer, lspec in zip(cache, specs, strict=True)]


def prefill(params, cfg, batch, max_len: int):
    """Run the prompt and build the dense serving cache.  batch: tokens
    [B,S] (or a batch as :func:`forward` takes it).  Returns (last_logits
    [B,V] fp32, cache, pos = S).  Only the last row is unembedded: the full
    [B,S,V] logits are never made.  Under a mesh (``params`` placed for
    it) the rank prefills its batch rows with its pieces of the weights
    and returns its rows' logits and its piece of the cache as
    :func:`init_cache` places it under the mesh."""
    mesh = _check_mesh(params, cfg)
    rows = batch
    if mesh is not None:
        rows = rank_batch(batch, mesh)
    x, caches, _ = _hidden(params, cfg, rows, collect_cache=True,
                           data_rows=_data_rows(_batch_rows(batch), mesh))
    logits = layers.unembed(params["embed_f32"], x[:, -1], cfg.vocab_size)
    cache = [_pad_cache_rows(cfg, kind, c, max_len)
             for c, kind in zip(caches, cfg.layer_kinds(), strict=True)]
    if mesh is not None:
        cache = _place_rows(cache, _batch_rows(batch), mesh)
    return logits, cache, x.shape[1]


def check_pageable(cfg) -> None:
    """The reference's ``ValueError`` unless every layer is an attention
    block: a recurrent or SSM state is per sequence, not per token."""
    for kind in cfg.layer_kinds():
        if kind != "attn":
            raise ValueError(
                f"paged cache requires an attention-only stack (got {kind})")


def init_paged_cache(cfg, layout, kv_dtype: str = "fp", *, device="cuda"):
    """Paged serving cache: one pool per layer, all layers sharing the one
    block table the scheduler owns (runtime/paged_cache.BlockPool).
    Returns a list of per-layer dicts: {"c": latent pool} for MLA, where
    kv_dtype "int8" / "fp8" stores codes and adds the per-row (scale, zp)
    pool under "c_sz"; {"k", "v": [N, page, K, hd]} for GQA, where a
    quantized layout adds "k_sz" / "v_sz" [N, page, K, 2] (one (scale, zp)
    per row and kv head).  Every later path (decode, chunked prefill,
    block copy, swap) keys off the dict, so the layout is chosen here
    once.  Attention-only stacks: a
    recurrent or SSM state is per sequence, not per token, so there is
    nothing to page (the reference's ``ValueError``)."""
    check_pageable(cfg)
    check_ported(cfg)
    mesh = get_mesh()
    if mesh is not None and mesh.size > 1:
        raise NotImplementedError(
            f"a paged cache on {mesh}: not yet ported (ROADMAP A10b.5)")
    init = (mla_mod.init_mla_cache_paged if cfg.attention_kind == "mla"
            else attention.init_attention_cache_paged)
    return [init(cfg, layout, cfg.torch_dtype, kv_dtype, device=device)
            for _ in range(cfg.num_layers)]


def paged_row_bytes(cfg, kv_dtype: str = "fp") -> int:
    """KV-cache bytes one token costs across the layer stack of a paged
    cache in the given layout — what the serve loop's byte-budget sizing
    divides by.  MLA: one latent row per layer; GQA: K heads × head_dim for
    K and V each, every head its own quantization granule with its own
    (scale, zp) (the reference's formula, for every layout, ported or
    not)."""
    n_layers = len(cfg.layer_kinds())
    if cfg.attention_kind == "mla":
        return n_layers * paged_cache.row_bytes(
            cfg.mla.latent_dim, kv_dtype, cfg.torch_dtype)
    Kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    return n_layers * 2 * paged_cache.row_bytes(
        Kv * hd, kv_dtype, cfg.torch_dtype, granules=Kv)


def copy_paged_block(cache, src: int, dst: int):
    """Copy-on-write copy of physical block ``src`` into ``dst`` in every
    pool of every layer (codes and their (scale, zp) rows alike), in
    place.  Returns ``cache``."""
    for layer in cache:
        for pool in layer.values():
            paged_cache.copy_block(pool, src, dst)
    return cache


def read_paged_blocks(cache, ids):
    """Host copies of physical blocks ``ids`` of every layer's pools — the
    device→host leg of preemption by swap.  Returns {key: CPU tensor
    [n_layers, len(ids), bs, *F]} in each pool's dtype (bitwise copies;
    fp8 codes move as their bytes)."""
    idx = torch.as_tensor(list(ids), dtype=torch.long)
    return {key: torch.stack([
        paged_cache.raw(layer[key])[idx.to(layer[key].device)].cpu()
        for layer in cache]).view(cache[0][key].dtype)
        for key in cache[0]}


def write_paged_blocks(cache, ids, rows):
    """Write host block rows (from :func:`read_paged_blocks`) back into
    physical blocks ``ids`` of every layer's pools, bitwise, in place.
    Returns ``cache``."""
    for i, layer in enumerate(cache):
        for key, pool in layer.items():
            idx = torch.as_tensor(list(ids), dtype=torch.long,
                                  device=pool.device)
            src = rows[key][i]
            if src.dtype != pool.dtype:
                raise ValueError(f"{key}: rows of {src.dtype} for a pool of "
                                 f"{pool.dtype}")
            paged_cache.raw(pool)[idx] = paged_cache.raw(src).to(pool.device)
    return cache


def _block_prefill_chunk(lp, cfg, sig, x, cache, table, lengths, spec,
                         qpos=None, n_cached: int = 0):
    """One block over a chunk against the paged cache; ``qpos`` [B,C]
    switches its attention to the verify entry (explicit per-row
    horizons); the first ``n_cached`` rows of a prefill chunk are in the
    pools already and are not appended.  A MoE block routes dropless, the
    B rows its groups of C tokens, as a prompt token is never dropped at
    inference (so chunked equals single-shot prefill only where
    single-shot's capacity drops nothing)."""
    _, is_moe = sig
    h = layers.rms_norm(x, lp["norm1"], cfg.norm_eps)
    mla = cfg.attention_kind == "mla"
    if qpos is None:
        fn = mla_mod.mla_prefill_chunk if mla else \
            attention.attention_prefill_chunk
        mixed, cache = fn(lp["mix"], cfg, h, cache, table, lengths, spec=spec,
                          n_cached=n_cached)
    else:
        fn = mla_mod.mla_verify_chunk if mla else \
            attention.attention_verify_chunk
        mixed, cache = fn(lp["mix"], cfg, h, cache, table, lengths, qpos,
                          spec=spec)
    x = x + mixed
    h2 = layers.rms_norm(x, lp["norm2"], cfg.norm_eps)
    if is_moe:
        return x + moe.moe_ffn(lp["ffn"], cfg, h2, dropless=True)[0], cache
    return x + layers.mlp(lp["ffn"], h2, cfg.d_ff), cache


def _block_decode(lp, cfg, sig, x, cache, pos, spec, cache_layout, table,
                  lengths, lspec=None, data_rows: bool = False):
    """One block, one token a row (x [B,D]); a MoE block routes the B
    tokens as one dropless group (``lspec``, ``data_rows``: as
    :func:`_block_seq`'s, the group's tokens the rows)."""
    kind, is_moe = sig
    h = layers.rms_norm(x, lp["norm1"], cfg.norm_eps)
    if kind == "ssm":
        mixed, cache = mamba.mamba_decode(lp["mix"], cfg, h, cache)
        return x + mixed, cache
    mla = cfg.attention_kind == "mla"
    if kind == "rglru":
        mixed, cache = rglru.rglru_decode(lp["mix"], cfg, h, cache)
    elif cache_layout == "paged":
        fn = mla_mod.mla_decode_paged if mla else \
            attention.attention_decode_paged
        mixed, cache = fn(lp["mix"], cfg, h, cache, table, lengths, spec=spec)
    else:
        fn = mla_mod.mla_decode if mla else attention.attention_decode
        mixed, cache = fn(lp["mix"], cfg, h, cache, pos, spec=spec)
    x = x + mixed
    h2 = layers.rms_norm(x, lp["norm2"], cfg.norm_eps)
    if is_moe:                         # the B tokens: one group
        return x + moe.moe_ffn(
            lp["ffn"], cfg, h2[None], dropless=True,
            **_moe_layout(lspec, 1 if data_rows else None))[0][0], cache
    return x + layers.mlp(lp["ffn"], h2, cfg.d_ff), cache


def prefill_chunk(params, cfg, cache, tokens, block_table, lengths, *,
                  spec: AttnSpec | None = None, n_cached: int = 0):
    """Chunked paged prefill: C prompt tokens per sequence against the
    block-pool cache.  tokens: [B,C] (token c at position lengths[b] + c);
    block_table: [B,max_blocks]; lengths: [B] the chunk's start.  Each
    layer appends its chunk rows into its pool and attends causally over
    chunk + earlier context.  ``n_cached``: the chunk's first rows (a
    prefix-cache hit or a restore inside it) are in the pools already;
    they are computed as the rest, and only the rows after them are
    appended, so a chunk resumed after a hit has the shape, and on the card
    the bits, of the chunk an uncached run gives those rows (a GEMM's row
    bits depend on its row count there).  Returns (logits [B,C,V] fp32,
    cache)."""
    return _chunk_forward(params, cfg, cache, tokens, block_table, lengths,
                          spec or AttnSpec(), n_cached=n_cached)


def _chunk_forward(params, cfg, cache, tokens, block_table, lengths, spec,
                   qpos=None, n_cached: int = 0):
    """The chunk-shaped forward of :func:`prefill_chunk` and
    :func:`verify_step`."""
    x = layers.embed(params["embed"], tokens, cfg.vocab_size)
    new_cache = []
    for lp, lc, sig in zip(params["layers"], cache, signatures(cfg),
                           strict=True):
        x, nc = _block_prefill_chunk(lp, cfg, sig, x, lc, block_table,
                                     lengths, spec, qpos, n_cached)
        new_cache.append(nc)
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return layers.unembed(params["embed_f32"], x, cfg.vocab_size), new_cache


def verify_step(params, cfg, cache, tokens, block_table, lengths, *,
                spec: AttnSpec | None = None, qpos=None):
    """Score k draft tokens per sequence in one chunked-prefill-shaped pass
    — the verification half of draft-then-verify decoding.

    tokens: [B,k] — column 0 is each sequence's last committed token,
    columns 1..k-1 the draft; their rows are appended into the paged pools
    at ``lengths`` (the accepted prefix's rows are then where decode needs
    them) and logits come back for every draft position.  qpos: [B,k] each
    row's absolute position; None is the linear chain lengths[:, None] +
    arange(k), under which this is bitwise :func:`prefill_chunk` on the
    same tokens.  The caller extends the block budget first
    (``BlockPool.extend``) and rewinds the rejected tail after
    (``BlockPool.truncate(..., free_blocks=False)``).  Returns (logits
    [B,k,V] fp32, cache)."""
    if qpos is None:
        k = tokens.shape[1]
        qpos = lengths[:, None].to(torch.int32) + torch.arange(
            k, dtype=torch.int32, device=lengths.device)[None, :]
    return _chunk_forward(params, cfg, cache, tokens, block_table, lengths,
                          spec or AttnSpec(), qpos.to(torch.int32))


def decode_step(params, cfg, cache, tokens, pos=None, *,
                spec: AttnSpec | None = None, cache_layout: str = "dense",
                block_table=None, lengths=None):
    """One serving step. tokens: [B].  cache_layout "dense": ``cache`` is
    :func:`init_cache`'s (or :func:`prefill`'s) and ``pos`` the new token's
    position, shared by every row.  "paged": ``cache`` is
    :func:`init_paged_cache`'s, and block_table [B,max_blocks] plus
    per-sequence lengths [B] place each new token.  An MLA layer's cache is
    updated in place; a Mamba layer's state is replaced by the new one.
    Under a mesh (dense layout): ``tokens`` is the whole batch, ``cache``
    this rank's piece (:func:`init_cache` / :func:`shard_cache` under the
    mesh), and the step runs the rank's batch rows (``rules.cache_specs``'
    batch entry), each rank over its sequence slice where the cache is
    sequence-sharded, with its pieces of the weights (``params`` placed
    for the mesh: ``rules.place_params`` or :func:`init` under it).
    Returns (logits [B,V] fp32, under a mesh the rank's rows
    (``launch.steps.gather_rows`` gathers them), cache)."""
    spec = spec or AttnSpec()
    if cache_layout not in ("dense", "paged"):
        raise ValueError(f"cache_layout {cache_layout!r}")
    if cache_layout == "paged" and (block_table is None or lengths is None):
        raise ValueError("paged decode_step needs block_table and lengths")
    if cache_layout == "dense" and pos is None:
        raise ValueError("dense decode_step needs pos")
    mesh = get_mesh()
    rows = _data_rows(tokens.shape[0], mesh)
    if mesh is not None:
        if cache_layout == "paged" and mesh.size > 1:
            raise NotImplementedError(
                f"paged decode on {mesh}: not yet ported (ROADMAP A10b.5)")
        _check_mesh(params, cfg)
        tokens = _rank_rows(tokens, mesh)
    specs = getattr(params, "specs", None)
    lspecs = specs["layers"] if specs is not None else [None] * len(
        params["layers"])
    x = layers.embed(params["embed"], tokens, cfg.vocab_size)
    new_cache = []
    for lp, lc, sig, lspec in zip(params["layers"], cache, signatures(cfg),
                                  lspecs, strict=True):
        x, nc = _block_decode(lp, cfg, sig, x, lc, pos, spec, cache_layout,
                              block_table, lengths, lspec, rows)
        new_cache.append(nc)
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return layers.unembed(params["embed_f32"], x, cfg.vocab_size), new_cache


def param_count(params) -> int:
    """Parameters of the model, every expert counted (the derived fp32
    unembedding not counted)."""
    def count(tree):
        if isinstance(tree, dict):
            return sum(count(v) for k, v in tree.items() if k != "embed_f32")
        if isinstance(tree, list):
            return sum(count(v) for v in tree)
        return tree.numel()
    return count(params)
