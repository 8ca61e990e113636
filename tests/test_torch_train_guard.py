"""No CUDA kernel wrapper drops a gradient without a word.

A kernel called through ``ctypes`` writes tensors outside the autograd
graph, so training through one would train with zero gradients behind it
(Falcon-Mamba's SSM through K10, for one).  Every CUDA wrapper calls
``kernels/launch.py:refuse_grad`` first on its CUDA branch.  Here each
wrapper's CUDA branch is taken on CPU tensors (``device_of`` says cuda, as
the launch tests fake it) with operands that require grad: each raises
``NotImplementedError`` naming ROADMAP A7 before it asks for the library;
under ``torch.no_grad`` the guard lets the call through to the library.
K9's wrapper refuses grad on either device: its autograd Function
(``flash_prefill_grad``) is the route that trains.
"""
import inspect

import pytest
import torch

from repro_torch.kernels import build, launch
from repro_torch.kernels.etap import combine as C
from repro_torch.kernels.etap import etap as K
from repro_torch.kernels.flash_decode import flash_decode as FD
from repro_torch.kernels.flash_prefill import flash_prefill as FP
from repro_torch.kernels.selective_scan import scan as S

NOT_WRAPPERS = {"flash_prefill_backward", "flash_prefill_grad"}


def _wrappers():
    out = []
    for mod in (K, C, FD, FP, S):
        for name, fn in vars(mod).items():
            if inspect.isfunction(fn) and fn.__module__ == mod.__name__ \
                    and not name.startswith("_") \
                    and not name.endswith("_plain") \
                    and name not in NOT_WRAPPERS:
                out.append((mod, name))
    return out


WRAPPERS = _wrappers()
SHAPES = {"q": (1, 2, 8), "kv_pool": (3, 4, 8), "k_pool": (3, 4, 8),
          "v_pool": (3, 4, 8), "kv_sz": (3, 4, 2), "k_sz": (3, 4, 2),
          "v_sz": (3, 4, 2), "k": (1, 4, 8), "v": (1, 4, 8),
          "kv": (1, 4, 8), "m": (1, 1, 2), "l": (1, 1, 2),
          "acc": (1, 1, 8, 2), "dA": (1, 4, 8, 2), "dBx": (1, 4, 8, 2),
          "c": (1, 4, 2)}
INTS = {"table": (1, 2), "lengths": (1,), "length": (1,), "start": (1,),
        "qpos": (1, 1)}
OTHER = {"dv": 8, "scale": 0.125, "n_splits": 1, "plan": None,
         "out_dtype": torch.bfloat16}


def _args(fn, grad: bool):
    pos, kw = [], {}
    for p in inspect.signature(fn).parameters.values():
        if p.default is not inspect.Parameter.empty:
            continue
        if p.name in SHAPES:
            val = torch.zeros(SHAPES[p.name], requires_grad=grad)
        elif p.name in INTS:
            val = torch.zeros(INTS[p.name], dtype=torch.int32)
        else:
            val = OTHER[p.name]
        if p.kind == p.KEYWORD_ONLY:
            kw[p.name] = val
        else:
            pos.append(val)
    return pos, kw


class _Reached(Exception):
    pass


@pytest.fixture
def cuda_branch(monkeypatch):
    for mod in (K, C, FD, FP, S):
        monkeypatch.setattr(mod, "device_of",
                            lambda *t: torch.device("cuda"))

    def library():
        raise _Reached("asked for the kernel library")
    monkeypatch.setattr(build, "library", library)


def test_every_wrapper_is_covered():
    names = {n for _, n in WRAPPERS}
    assert len(WRAPPERS) == 29
    assert {"selective_scan", "flash_prefill", "combine_splits",
            "etap_decode_mla_paged", "flash_decode_partial_quant",
            "etap_verify_paged_quant", "etap_decode_mla_dense"} <= names


@pytest.mark.parametrize("mod,name", WRAPPERS,
                         ids=[n for _, n in WRAPPERS])
def test_cuda_wrapper_refuses_grad(cuda_branch, mod, name):
    fn = getattr(mod, name)
    pos, kw = _args(fn, grad=True)
    with pytest.raises(NotImplementedError, match="no backward") as e:
        fn(*pos, **kw)
    assert "ROADMAP A7" in str(e.value)
    pos, kw = _args(fn, grad=False)
    with torch.no_grad():                   # no backward asked for
        with pytest.raises(Exception) as e:
            fn(*pos, **kw)
    assert "no backward" not in str(e.value)


def test_k10_names_its_backward(cuda_branch):
    pos, kw = _args(S.selective_scan, grad=True)
    with pytest.raises(NotImplementedError, match="K10 backward"):
        S.selective_scan(*pos, **kw)


def test_refuse_grad_itself():
    x = torch.zeros(2, requires_grad=True)
    with pytest.raises(NotImplementedError, match="k: the CUDA kernel"):
        launch.refuse_grad(None, x, what="k")
    with torch.no_grad():
        launch.refuse_grad(x, what="k")
    launch.refuse_grad(torch.zeros(2), None, 3, what="k")


def test_k9_cpu_refuses_grad_and_function_trains():
    q = torch.zeros(1, 8, 2, 16, requires_grad=True)
    k = torch.zeros(1, 8, 2, 16)
    with pytest.raises(NotImplementedError, match="flash_prefill_grad"):
        FP.flash_prefill(q, k, k, scale=0.25)
    out = FP.flash_prefill_grad(q, k, k, scale=0.25)
    (dq,) = torch.autograd.grad(out.sum(), (q,))
    assert dq.shape == q.shape
