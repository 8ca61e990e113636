"""The rank processes of ``tests/test_torch_sharded_train.py`` and
``tests/test_torch_sharded_train_jax.py``.

Each of 8 gloo ranks on the CPU joins the group through a FileStore in
the test's directory, builds the (data, model) = (2, 4) mesh and reads
``inputs.pt``: for each case the whole weights (the reference's, carried
across by ``params_from_jax``), the config, the batch, the train config
and what to run.  Per case it places the weights by
``param_specs(profile="train")`` and the optimizer state by
``opt_state_specs`` (``opt.opt_init`` on the placed tree), checks every
piece's shape against ``rules.local_shape``, and under the mesh runs the
sharded ``grads_of`` and ``make_train_step`` for the case's steps; it may
also check that the placed train-profile ``init`` (and
``train.build_state`` under the mesh) is bitwise the cut of the whole
one, and round-trip the placed state through ``checkpoint.save`` /
``restore``.  The results are gathered whole
(``rules.gather_placed``); rank 0 writes them to ``out.pt``, every rank
its checks to ``rank<r>.pt``.  Imports no JAX: the ranks run the port
only.
"""
import pathlib

MESH = (2, 4)                     # (data, model)


def _same(a, b) -> bool:
    """Two trees of tensors bitwise equal, leaf by leaf."""
    import torch
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_same, a, b))
    return a.dtype == b.dtype and torch.equal(a, b)


def _shapes_ok(placed, whole, specs_of, mesh) -> bool:
    """Every piece of ``placed`` has ``rules.local_shape`` of its whole
    leaf under its spec."""
    from repro_torch.sharding import rules
    pieces = dict(rules._leaves_with_path(placed))
    specs = dict(rules._leaves_with_path(specs_of, leaf_type=rules.P))
    return pieces.keys() == specs.keys() and all(
        tuple(pieces[p].shape) == rules.local_shape(t.shape, specs[p], mesh)
        for p, t in rules._leaves_with_path(whole))


def _checkpoint(params, state, cfg, tcfg, mesh, work) -> dict:
    """Save the placed (params, state) under the mesh and restore them
    into a placed template of zeros: bitwise the saved pieces, and the
    files hold whole leaves."""
    import json

    import torch

    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.launch import mesh as M
    from repro_torch.optim import optimizers as opt
    from repro_torch.sharding import rules
    path = str(work / "ckpt")
    with M.use_mesh(mesh):
        ckpt.save(path, 3, (params, state))
        whole = rules.gather_placed(params, mesh)
        zeros = rules.place_params(opt.tree_map(torch.zeros_like, whole),
                                   mesh, profile="train")
        template = (zeros, opt.opt_init(tcfg.optimizer, zeros))
        (p2, s2), step = ckpt.restore(path, 3, template)
    with open(f"{path}/step_3/MANIFEST.json") as f:
        shapes = {k: tuple(v["shape"]) for k, v in
                  json.load(f)["leaves"].items()}
    want = {"#0__" + p.replace("/", "__"): tuple(t.shape)
            for p, t in rules._leaves_with_path(whole)}
    return {"restored": step == 3 and _same((p2, s2), (params, state))
            and isinstance(p2, rules.Placed) and p2.specs is zeros.specs,
            "whole_on_disk": all(shapes[_flat(k)] == v
                                 for k, v in want.items())}


def _flat(key: str) -> str:
    """A checkpoint key of a params path ("#0__layers__0__mix__w_q"):
    list indices as "#i"."""
    parts = key.split("__")
    return "__".join(f"#{p}" if p.isdigit() else p for p in parts)


def _gathered(tree, mesh):
    """A copy of the whole tree of a placed one (a whole leaf is the
    rank's own tensor, which later steps update in place)."""
    import torch

    from repro_torch.optim import optimizers as opt
    from repro_torch.sharding import rules
    return opt.tree_map(torch.clone, rules.gather_placed(tree, mesh))


def _run(case, mesh, work) -> tuple:
    """One case on this rank: (whole results, this rank's checks)."""
    import torch

    from repro_torch.launch import mesh as M
    from repro_torch.launch import steps as S
    from repro_torch.launch import train
    from repro_torch.models import model
    from repro_torch.optim import optimizers as opt
    from repro_torch.sharding import rules
    cfg, tcfg = case["cfg"], case["tcfg"]
    whole = opt.tree_map(torch.clone, case["params"])   # cases share them
    batch = {"tokens": case["tokens"]}
    placed = rules.place_params(whole, mesh, profile="train")
    whole_state = opt.opt_init(tcfg.optimizer, whole)
    whole_init = model.init(cfg, seed=0, device="cpu") \
        if case.get("init_check") else None
    checks = {"params_shapes": _shapes_ok(placed, whole, placed.specs, mesh),
              "n_cut": sum(p.shape != t.shape for p, t in zip(
                  opt.tree_leaves(placed), opt.tree_leaves(whole)))}
    out = {"steps": []}
    chunk = opt.CHUNK
    opt.CHUNK = case.get("chunk", chunk)      # AdamW's elements at a time
    with M.use_mesh(mesh):
        state = opt.opt_init(tcfg.optimizer, placed)
        cut_state = rules.place_opt_state(whole_state, mesh)
        checks["state_shapes"] = _shapes_ok(
            state, whole_state, rules.opt_state_specs(whole_state, mesh),
            mesh) and _same(state, cut_state)
        if case.get("grads"):
            g, m = S.grads_of(placed, cfg, model.rank_batch(
                batch, mesh, exact=True))
            out["grads"] = _gathered(g, mesh)
            out["grads_metrics"] = m
        step = S.make_train_step(cfg, tcfg)
        for i in range(case.get("steps", 1)):
            placed, state, m = step(placed, state, batch, i)
            out["steps"].append({
                "params": _gathered(placed, mesh),
                "state": _gathered(state, mesh),
                "metrics": {k: float(v) for k, v in m.items()}})
        opt.CHUNK = chunk
        if case.get("init_check"):
            got = model.init(cfg, seed=0, device="cpu", profile="train")
            cut = rules.place_params(whole_init, mesh, profile="train")
            params, state = train.build_state(cfg, tcfg, seed=0,
                                              device="cpu")
            del cut["embed_f32"]
            checks["init_same"] = _same(got, rules.place_params(
                whole_init, mesh, profile="train")) and \
                got.profile == "train" and _same(params, cut) and \
                _same(state, opt.opt_init(tcfg.optimizer, cut))
    if case.get("ckpt"):
        checks.update(_checkpoint(placed, state, cfg, tcfg, mesh, work))
    return out, checks


def _adjoints(mesh) -> dict:
    """Each collective with a gradient against its adjoint under the
    convention of ``launch.mesh`` (the step's loss is the sum of the data
    ranks' losses, each `model` rank holding its row's once): for x this
    rank's tensor and a per-rank weight w, the gradient of sum(f(x) · w)
    against its closed form, and the bytes counted under ":backward"."""
    import torch

    from repro_torch.launch import mesh as M
    d, m = mesh.coord("data"), mesh.coord("model")
    rank = d * mesh.shape["model"] + m

    def tensor(seed, shape):
        g = torch.Generator().manual_seed(seed)
        return torch.randn(*shape, generator=g, dtype=torch.float64)
    xs = [tensor(100 + r, (8, 3)) for r in range(8)]       # every rank's x
    w_of = [tensor(200 + r, (8, 3)) for r in range(8)]     # every rank's w
    w_rows = [tensor(300 + dd, (8, 3)) for dd in range(2)]  # a data row's w
    out = {}

    def grad(fn, x, w):
        x = x.clone().requires_grad_()
        (fn(x) * w).sum().backward()
        return x.grad

    def same(a, b):
        return bool(torch.allclose(a, b, rtol=1e-12, atol=1e-12))
    model_ranks = [d * 4 + mm for mm in range(4)]
    data_ranks = [dd * 4 + m for dd in range(2)]
    # gather over model: replicated result, the row's w -> the slice
    w = torch.cat([w_rows[d]] * 4)[:32].reshape(32, 3)
    out["gather/model"] = same(grad(lambda x: M.gather(
        x, mesh, "model", 0), xs[rank], w), w[8 * m:8 * m + 8])
    # gather over data: each data rank's own w -> the reduce-scatter
    w = torch.cat([w_of[rank]] * 2)
    want = sum(torch.cat([w_of[r]] * 2) for r in data_ranks)[8 * d:8 * d + 8]
    out["gather/data"] = same(grad(lambda x: M.gather(
        x, mesh, "data", 0), xs[rank], w), want)
    # all-reduce over model: the identity; over data: the sum
    out["reduce_sum/model"] = same(grad(lambda x: M.reduce_sum(
        x, mesh, "model"), xs[rank], w_rows[d]), w_rows[d])
    out["reduce_sum/data"] = same(grad(lambda x: M.reduce_sum(
        x, mesh, "data"), xs[rank], w_of[rank]),
        sum(w_of[r] for r in data_ranks))
    # reduce-scatter over model: the all-gather of each rank's w piece
    out["scatter_sum/model"] = same(grad(lambda x: M.scatter_sum(
        x, mesh, "model", 0), xs[rank], w_of[rank][2 * m:2 * m + 2]),
        torch.cat([w_of[r][2 * (r % 4):2 * (r % 4) + 2]
                   for r in model_ranks]))
    # enter over model: each rank's own w summed over the row
    out["enter/model"] = same(grad(lambda x: M.enter(x, mesh, "model"),
                                   xs[d * 4], w_of[rank]),
                              sum(w_of[r] for r in model_ranks))
    M.moved.clear()
    grad(lambda x: M.gather(x, mesh, "data", 0), xs[rank], w_of[rank].repeat(
        2, 1))
    out["moved"] = dict(M.moved)
    return out


def main(rank: int, world: int, work_dir: str, names) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.launch import mesh as M

    torch.set_num_threads(1)
    work = pathlib.Path(work_dir)
    M.init_ranks(rank, world, backend="gloo",
                 init_method=f"file://{work / 'store'}", device="cpu",
                 timeout_s=60)
    try:
        inp = torch.load(work / "inputs.pt", weights_only=False)
        mesh = M.make_host_mesh("cpu", MESH)
        out, checks = {}, {}
        for name in names:
            if name == "adjoints":
                checks[name] = _adjoints(mesh)
            else:
                out[name], checks[name] = _run(inp[name], mesh, work / name)
        if rank == 0:
            torch.save(out, work / "out.pt")
        torch.save(checks, work / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()
