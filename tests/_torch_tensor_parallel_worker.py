"""The rank processes of ``tests/test_torch_tensor_parallel.py``.

Each of 4 gloo ranks on the CPU joins the group through a FileStore in the
test's directory and reads ``inputs.pt`` (the converted weights of each
case and the prompts).  For each case and each of its meshes it places the
weights (``rules.place_params``), checks them against the placed ``init``
and ``rules.local_shape``, checks the vocab-parallel lookup, and serves:
``make_prefill_step`` under the mesh, then greedy ``make_serve_step``
steps, ``gather_rows`` after each, once into a cache below
``SEQ_SHARD_MIN_S`` (unsharded) and once into one at it
(sequence-sharded).  Writes what it got to ``rank<r>.pt``.  Imports no
JAX: the ranks run the port only.
"""
import pathlib

MIN_S = 64                        # SEQ_SHARD_MIN_S at test scale
# cache rows: unsharded (below MIN_S) and sequence-sharded
MAX_LENS = {"unsharded": 48, "seq-sharded": MIN_S}


def _same(a, b) -> bool:
    """Two trees of tensors bitwise equal, leaf by leaf."""
    import torch
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(map(_same, a, b))
    return a.dtype == b.dtype and torch.equal(a, b)


def _placement(params, cfg, mesh) -> dict:
    """The placed tree, and its checks: bitwise the placed ``init``
    (seed 0 under the mesh against ``place_params`` of the whole init);
    every leaf's shape its ``rules.local_shape``; the vocab-parallel
    embedding bitwise the whole table's lookup."""
    import torch

    from repro_torch.launch import mesh as M
    from repro_torch.models import layers, model
    from repro_torch.sharding import rules

    placed = rules.place_params(params, mesh)
    pieces = dict(rules._leaves_with_path(placed))
    shapes_ok, n_cut = True, 0
    for path, t in rules._leaves_with_path(params):
        spec = rules.leaf_spec(path, t, mesh, profile="serve")
        piece = pieces[path]
        shapes_ok &= tuple(piece.shape) == rules.local_shape(t.shape, spec,
                                                             mesh)
        n_cut += piece.shape != t.shape
    with M.use_mesh(mesh):
        init_placed = model.init(cfg, seed=0, device="cpu")
        toks = torch.arange(cfg.vocab_size, dtype=torch.int32).reshape(
            4, -1)
        lookup = layers.embed(placed["embed"], toks, cfg.vocab_size)
    init_same = _same(init_placed, rules.place_params(
        model.init(cfg, seed=0, device="cpu"), mesh)) and \
        init_placed.mesh_shape == mesh.shape
    return placed, {"shapes_ok": shapes_ok, "n_cut": n_cut,
                    "init_same": init_same,
                    "embed_same": torch.equal(lookup, params["embed"][
                        toks.long()])}


def _serve(placed, cfg, toks, prompt, steps, mesh, max_len) -> dict:
    """Prefill under the mesh, then ``steps`` greedy steps; the gathered
    logits of the prefill and of each step, the tokens, and whether the
    cache came out sequence-sharded."""
    import torch

    from repro_torch.launch import mesh as M
    from repro_torch.launch import steps as S

    B = toks.shape[0]
    with M.use_mesh(mesh):
        logits, cache, pos = S.make_prefill_step(cfg, max_len)(
            placed, toks[:, :prompt])
        logits = S.gather_rows(logits, mesh, B)
        out = {"prefill": logits, "sharded": "seq_rows" in cache[0]}
        step = S.make_serve_step(cfg)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        logits_all, toks_all = [], []
        for i in range(steps):
            logits, cache = step(placed, cache, tok, pos + i)
            logits = S.gather_rows(logits, mesh, B)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            logits_all.append(logits)
            toks_all.append(tok)
    out.update(logits=torch.stack(logits_all), tokens=torch.stack(toks_all))
    return out


def main(rank: int, world: int, work_dir: str) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.launch import mesh as M
    from repro_torch.sharding import rules

    torch.set_num_threads(1)
    rules.SEQ_SHARD_MIN_S = MIN_S
    work = pathlib.Path(work_dir)
    M.init_ranks(rank, world, backend="gloo",
                 init_method=f"file://{work / 'store'}", device="cpu",
                 timeout_s=60)
    try:
        inp = torch.load(work / "inputs.pt", weights_only=False)
        out = {}
        for name, case in inp.items():
            for shape in case["meshes"]:
                mesh = M.make_host_mesh("cpu", shape)
                placed, checks = _placement(case["params"], case["cfg"],
                                            mesh)
                res = {"checks": checks}
                for kind, max_len in MAX_LENS.items():
                    res[kind] = _serve(placed, case["cfg"], case["toks"],
                                       case["prompt"], case["steps"], mesh,
                                       max_len)
                out[(name, shape)] = res
        torch.save(out, work / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()
