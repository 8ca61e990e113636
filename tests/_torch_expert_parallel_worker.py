"""The rank processes of ``tests/test_torch_expert_parallel.py``.

Each of 4 gloo ranks on the CPU joins the group through a FileStore in the
test's directory and reads ``inputs.pt``.  For each mesh (data, model) of
``MESHES``: reduced DeepSeek-R1 with its MoE layer's experts over `data`
placed and served as ``_torch_tensor_parallel_worker`` does it (the
placement's checks, ``make_prefill_step`` then greedy ``make_serve_step``
steps, the collectives' bytes by op), the capacity-bound ``moe_ffn`` case
on both paths against the unsharded ``moe_ffn`` on the same rank, and
``device_batch``.  On (4, 1) also ``compressed_psum`` and
``pod_reduce_with_feedback`` over `data`.  Writes what it got to
``rank<r>.pt``.  Imports no JAX: the ranks run the port only.
"""
import pathlib

import _torch_tensor_parallel_worker as tp

MESHES = ((2, 2), (4, 1))
MAX_LEN = tp.MAX_LENS["unsharded"]


def _moe_paths(case, mesh) -> dict:
    """The capacity-bound ``moe_ffn`` case under ``mesh``: its weights
    placed by the serve profile (the experts over `data`), the full
    sequence's groups and the decode group's tokens cut over `data` (and
    the decode group whole on every rank), each against the unsharded
    ``moe_ffn`` of the whole weights on the same input.  Returns the
    largest difference of each and the rank's expert count."""
    from repro_torch.launch import mesh as M
    from repro_torch.models import moe
    from repro_torch.sharding import rules

    cfg, ffn = case["cfg"], case["ffn"]
    piece = rules.place_params({"ffn": ffn}, mesh)["ffn"]
    out = {"experts": piece["w_gate"].shape[0]}
    legs = {"seq": (case["x_seq"], False, 0),
            "decode": (case["x_dec"], True, 1),
            "decode-whole": (case["x_dec"], True, None)}
    for leg, (x, dropless, dim) in legs.items():
        whole, _ = moe.moe_ffn(ffn, cfg, x, dropless=dropless)
        spec = rules.P(*(["data" if d == dim else None for d in range(3)]))
        with M.use_mesh(mesh):
            got, _ = moe.moe_ffn(piece, cfg, rules.local_rows(x, spec, mesh),
                                 dropless=dropless, expert_axis="data",
                                 data_dim=dim)
        want = rules.local_rows(whole, spec, mesh)
        out[leg] = float((got - want).abs().max()) if \
            got.shape == want.shape else float("inf")
    return out


def _device_batches(cases, mesh) -> dict:
    """``device_batch`` under ``mesh`` against ``local_rows`` of the whole
    batch of the same step, bitwise, for each config."""
    import torch

    from repro_torch.data import pipeline
    from repro_torch.sharding import rules
    out = {}
    for name, cfg in cases.items():
        data = pipeline.DataConfig(seed=5, global_batch=8, seq_len=16)
        whole = pipeline.device_batch(cfg, data, 3)
        mine = pipeline.device_batch(cfg, data, 3, mesh)
        out[name] = mine.keys() == whole.keys() and all(
            torch.equal(mine[k], rules.local_rows(
                v, rules.data_spec(mesh, v.dim()), mesh))
            and mine[k].dtype == v.dtype for k, v in whole.items())
    return out


def _compress(case, mesh) -> dict:
    """``compressed_psum`` of this rank's row of ``case["x"]`` over `data`
    (with the bytes its gathers moved), and the error-feedback steps of
    ``pod_reduce_with_feedback`` over `data` from this rank's grads and
    residual."""
    from repro_torch.launch import mesh as M
    from repro_torch.optim import compress
    r = mesh.coord("data")
    M.moved.clear()
    psum = compress.compressed_psum(case["x"][r], mesh, "data")
    moved = dict(M.moved)
    grads = {k: v[r] for k, v in case["grads"].items()}
    residual = {k: v[r] for k, v in case["residual"].items()}
    with M.use_mesh(mesh):
        reduced, residual = compress.pod_reduce_with_feedback(
            grads, residual, axis="data")
    return {"psum": psum, "moved": moved, "reduced": reduced,
            "residual": residual}


def main(rank: int, world: int, work_dir: str) -> None:
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
        case = inp["deepseek"]
        out = {}
        for shape in MESHES:
            mesh = M.make_host_mesh("cpu", shape)
            placed, checks = tp._placement(case["params"], case["cfg"], mesh)
            M.moved.clear()
            res = tp._serve(placed, case["cfg"], case["toks"],
                            case["prompt"], case["steps"], mesh, MAX_LEN)
            out[shape] = {"checks": checks, "serve": res,
                          "moved": dict(M.moved),
                          "experts": placed["layers"][1]["ffn"][
                              "w_gate"].shape[0],
                          "moe": _moe_paths(inp["moe"], mesh),
                          "batches": _device_batches(inp["batch_cfgs"],
                                                     mesh)}
            if shape == (4, 1):
                out["compress"] = _compress(inp["compress"], mesh)
        torch.save(out, work / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()
