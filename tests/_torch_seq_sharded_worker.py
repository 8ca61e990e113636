"""The rank processes of ``tests/test_torch_seq_sharded.py``.

Each of 4 gloo ranks on the CPU joins the group through a FileStore in the
test's directory, reads the inputs the test wrote there (``inputs.pt``:
the primitives' operands, the converted weights and the prompts), and for
each mesh (1, 4) and (2, 2) runs the sequence-sharded primitives on its
piece of the operands and the serve loops (whole prefill, ``shard_cache``,
``make_serve_step`` greedy over the weights placed for the mesh,
``gather_rows``), then writes what it got to ``rank<r>.pt``.  A MoE model
runs all-dense on a mesh with `data` > 1 (:func:`moe_dense`), where the
serve placement puts its experts over `data` (expert parallelism, held to
the JAX package in ``tests/test_torch_expert_parallel.py``).  The test
compares those with the JAX package's results.
Imports no JAX: the ranks run the port only.
"""
import pathlib

MESHES = ((1, 4), (2, 2))
MIN_S = 64                        # SEQ_SHARD_MIN_S at test scale


def moe_dense(shape) -> bool:
    """Whether a MoE model runs as its all-dense variant (every MoE layer
    a dense MLP) on a mesh of ``shape`` (data, model): where `data` > 1
    the serve placement puts the experts over `data`, which this test
    leaves to ``tests/test_torch_expert_parallel.py``."""
    return shape[0] > 1


def dense_variant(cfg):
    """``cfg`` with every layer's FFN a dense MLP."""
    import dataclasses
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, first_dense_layers=cfg.num_layers))


def _primitives(inp, mesh):
    import torch

    from repro_torch.core import etap
    from repro_torch.sharding import rules

    def piece(t, *entries):
        return rules.local_rows(t, rules.P(*entries), mesh).clone()

    out = {}
    pos = inp["pos"]
    q = piece(inp["q"], "data")
    cache = piece(inp["cache"], "data", "model")
    new_row = piece(inp["new_row"], "data")
    o, c = etap.seq_sharded_decode(q, cache, new_row, pos, dv=inp["dv"],
                                   scale=0.1, block=16)
    out["mla_o"], out["mla_cache"] = o, c
    q4 = piece(inp["q4"], "data")
    kc = piece(inp["kc"], "data", "model")
    vc = piece(inp["vc"], "data", "model")
    B, K, G, hd = q4.shape
    og, kc, vc = etap.seq_sharded_gqa_decode(
        q4.reshape(B, K * G, hd), kc, vc, piece(inp["nk"], "data"),
        piece(inp["nv"], "data"), pos, scale=0.1, block=16)
    out["gqa_o"], out["gqa_k"], out["gqa_v"] = og, kc, vc
    out["lengths"] = torch.tensor(
        [min(max(pos + 1 - mesh.coord("model") * cache.shape[1], 0),
             cache.shape[1])])
    return out


def _serve(params, cfg, toks, prompt, max_len, steps, mesh, dense=None):
    """Prefill the whole batch outside the mesh, take this rank's piece,
    then ``steps`` greedy serve steps under the mesh over the weights
    placed for it (``dense``: the all-dense variant's (params, cfg), run
    where :func:`moe_dense`)."""
    import torch

    from repro_torch.launch import mesh as M
    from repro_torch.launch import steps as S
    from repro_torch.models import model
    from repro_torch.sharding import rules

    if dense is not None and moe_dense(tuple(mesh.shape.values())):
        params, cfg = dense
    _, cache, pos = model.prefill(params, cfg, toks[:, :prompt], max_len)
    params = rules.place_params(params, mesh)
    with M.use_mesh(mesh):
        cache = model.shard_cache(cache)
        step = S.make_serve_step(cfg)
        tok = toks[:, prompt]
        logits_all, toks_all = [], []
        for i in range(steps):
            logits, cache = step(params, cache, tok, pos + i)
            logits = S.gather_rows(logits, mesh, toks.shape[0])
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            logits_all.append(logits)
            toks_all.append(tok)
    return {"logits": torch.stack(logits_all), "tokens": torch.stack(toks_all),
            "cache": cache}


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
        for shape in MESHES:
            mesh = M.make_host_mesh("cpu", shape)
            with M.use_mesh(mesh):
                res = {"coord": (mesh.coord("data"), mesh.coord("model")),
                       "prim": _primitives(inp["prim"], mesh)}
            for name, case in inp["serve"].items():
                res[name] = _serve(mesh=mesh, **case)
            out[shape] = res
        torch.save(out, work / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()
