"""The dry run on meta (`repro_torch.launch.dryrun`, `launch.inputs`) and
the kernel wrappers' shape-only meta branch: each wrapper's meta output has
the shape and dtype of its CPU plain output, in every variant, and counts
as a kernel call; the dry run records an ok, skip or error line for each
smoke config × small train, prefill and decode shapes, and for full
configs at `SHAPES` cells (skips as ``skip_shapes`` says); its counts
agree with `residency.expected_*` and the analytic model; it writes under
``build/`` and never to the reference's ``experiments/dryrun.jsonl``."""
import hashlib
import json
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.analysis import residency
from repro_torch.configs.base import (SHAPES, ShapeConfig, get_config,
                                      get_smoke_config, list_archs)
from repro_torch.core.conversion_plan import ConversionPlan
from repro_torch.core.quant import quant_scale
from repro_torch.core.rns import basis_for_chain, basis_for_int8_matmul
from repro_torch.core.rns_tensor import encode, encode_activation
from repro_torch.dist.rns_shard import channel_partials
from repro_torch.kernels import (flash_attention, fold, rns_forward,
                                 rns_fused_matmul, rns_matmul, rns_modmul,
                                 rns_reverse)
from repro_torch.launch import dryrun
from repro_torch.launch.costs import analytic_cost
from repro_torch.launch.inputs import (abstract_cache, abstract_params,
                                       input_specs)
from repro_torch.models import transformer as T

ROOT = pathlib.Path(__file__).resolve().parents[1]
META = torch.device("meta")
G = np.random.default_rng(0)


def _f(*shape, dtype=torch.float32):
    return torch.from_numpy(G.standard_normal(shape).astype(np.float32)) \
        .to(dtype)


def _i8(*shape, lo=-127, hi=128):
    return torch.from_numpy(G.integers(lo, hi, shape).astype(np.int8))


def _meta(obj):
    if isinstance(obj, torch.Tensor):
        return obj.to(META)
    if hasattr(obj, "residues"):
        return type(obj)(obj.residues.to(META), obj.scale.to(META),
                         obj.basis)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_meta(o) for o in obj)
    if isinstance(obj, dict):
        return {k: _meta(v) for k, v in obj.items()}
    return obj


def _sig(out):
    return [(tuple(t.shape), t.dtype) for t in residency.tensors(out)]


def _cases():
    """(name, wrapper, args, kwargs) of every variant of every wrapper."""
    M, K, N = 5, 64, 24
    b = basis_for_int8_matmul(K)
    w = encode(_f(K, N), b)
    x = _f(M, K)
    sx = quant_scale(x, dim=-1)
    chain = basis_for_chain(K)
    wc = encode(_f(K, N), chain)
    xa = encode_activation(x, chain)
    gate = _i8(M, K)
    mods = tuple(b.moduli)
    C = len(mods)
    res = torch.remainder(_i8(C, M, K).to(torch.int32),
                          torch.tensor(mods)[:, None, None]).to(torch.int8)
    plan = ConversionPlan.for_basis(b)
    cases = [
        ("fused f32 encoded", rns_fused_matmul, (x, w),
         dict(scale_row=sx, scale_col=w.scale)),
        ("fused bf16 encoded", rns_fused_matmul,
         (x.to(torch.bfloat16), w), dict(scale_row=sx, scale_col=w.scale)),
        ("fused live int8", rns_fused_matmul, (x, _i8(K, N), b),
         dict(scale_row=sx, scale_col=torch.ones(1, N))),
        ("fused residue-in", rns_fused_matmul, (xa, wc),
         dict(scale_row=xa.scale, scale_col=wc.scale)),
        ("fused gated", rns_fused_matmul, (xa, wc),
         dict(scale_row=xa.scale, scale_col=wc.scale, gate=gate)),
        ("fused emit residues", rns_fused_matmul, (xa, wc),
         dict(scale_row=xa.scale, scale_col=wc.scale, emit="residues")),
        ("matmul broadcast", rns_matmul, (_i8(1, M, K), w.residues, mods),
         dict(signed_a=True)),
        ("matmul planes", rns_matmul, (res, w.residues, mods), {}),
        ("modmul int8", rns_modmul, (res, res, mods),
         dict(out_dtype=torch.int8)),
        ("modmul int32", rns_modmul,
         (res.to(torch.int32), res.to(torch.int32), mods), {}),
        ("forward int8", rns_forward, (_i8(M, K), mods),
         dict(dtype=torch.int8)),
        ("forward int32", rns_forward,
         (torch.from_numpy(G.integers(-2**20, 2**20, (M, K)).astype(
             np.int32)), mods), {}),
        ("reverse", rns_reverse, (res.to(torch.int32), plan), {}),
        ("reverse scaled", rns_reverse, (res.to(torch.int32), plan),
         dict(scale=torch.rand(M, 1))),
        ("fold", fold, (torch.from_numpy(G.integers(
            0, 1000, (C, 40)).astype(np.int32)), mods, 1000), {}),
    ]
    for dt in (torch.float32, torch.bfloat16):
        q, k = _f(2, 3, 7, 16, dtype=dt), _f(2, 3, 9, 16, dtype=dt)
        cases.append((f"flash prefill {dt}", flash_attention,
                      (q, k, k.clone()), {}))
        cases.append((f"flash decode {dt}", flash_attention,
                      (q[:, :, :1], k, k.clone()), dict(window=4)))
    return cases


CASES = _cases()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_wrapper_meta_output_matches_plain(case):
    name, fn, args, kwargs = case
    want = fn(*args, **kwargs)
    with residency.TraceMode() as mode:
        got = fn(*_meta(args), **_meta(kwargs))
    assert _sig(got) == _sig(want)
    assert all(t.device.type == "meta" for t in residency.tensors(got))
    assert dict(mode.summary.kernel_calls) == {fn.__name__: 1}


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("residue_in", [False, True])
def test_crt_partial_meta_output_matches_plain(residue_in, gated):
    if gated and not residue_in:
        return
    K, N, M = 64, 24, 5
    basis = basis_for_int8_matmul(K)
    w = encode(_f(K, N), basis)
    x = _f(M, K)
    if residue_in:
        x = encode_activation(x, basis)
    kw = dict(scale_row=None if residue_in else quant_scale(x, dim=-1),
              gate=_i8(M, K) if gated else None)
    want = channel_partials(x, w, len(basis.moduli), **kw)
    with residency.TraceMode() as mode:
        got = channel_partials(_meta(x), _meta(w), len(basis.moduli),
                               **_meta(kw))
    assert _sig(got) == _sig(want)
    assert dict(mode.summary.kernel_calls) == {
        "rns_fused_crt_partial": len(basis.moduli)}


def test_inputs_are_meta_and_match_real_shapes():
    for arch in ("rns-smollm-135m-resident", "hymba-1.5b",
                 "phi-3-vision-4.2b"):
        cfg = get_smoke_config(arch)
        params = abstract_params(cfg)
        assert all(t.device.type == "meta"
                   for t in residency.tensors(params))
        real = T.make_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
        from repro_torch.serve.engine import encoded_params
        assert _sig(params) == _sig(encoded_params(cfg, real))
        assert _sig(abstract_cache(cfg, 2, 16)) == \
            _sig(T.init_cache(cfg, 2, 16, "cpu"))
        spec = input_specs(cfg, ShapeConfig("t", 16, 2, "train"))
        key = "embeds" if cfg.frontend == "embeddings" else "tokens"
        assert set(spec) == {key, "labels"}
        assert tuple(spec[key].shape[:2]) == (2, 16)
        dec = input_specs(cfg, ShapeConfig("d", 16, 2, "decode"))
        assert tuple(dec[key].shape[:2]) == (2, 1)


SMALL = [ShapeConfig("t", 32, 2, "train"), ShapeConfig("p", 32, 2, "prefill"),
         ShapeConfig("d", 32, 2, "decode")]


@pytest.mark.parametrize("arch", list_archs())
def test_smoke_cells(arch):
    """Every smoke config runs all three kinds of step on meta; the RNS
    configs call exactly the kernels their dispatch implies."""
    cfg = get_smoke_config(arch)
    for shape in SMALL:
        rec = dryrun.run_cell(cfg, shape, arch=arch)
        assert rec["status"] == "ok", rec.get("traceback")
        assert rec["fits"] and rec["cost"]["flops"] > 0
        assert rec["memory"]["temp_bytes"] > 0
        assert rec["analytic"] == analytic_cost(
            cfg, shape, n_pods=1, data=1, model=1).as_dict()
        assert rec["host_syncs"] == {}
        if shape.kind == "train":
            want = residency.expected_train_step(cfg)
        elif shape.kind == "prefill":
            want = residency.expected_prefill(cfg)
        else:
            want = residency.expected_step(cfg)
        if cfg.family == "dense":
            assert rec["kernel_calls"] == residency.kernel_calls(want)
        assert (rec["cost"]["int8_ops"] > 0) == cfg.linear_spec.is_rns


def test_train_cell_memory_is_the_state_and_the_step():
    """Argument bytes are the parameters, optimizer state and batch, byte
    for byte."""
    cfg = get_smoke_config("rns-smollm-135m-fused")
    rec = dryrun.run_cell(cfg, SMALL[0])
    params = T.make_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    n = sum(t.numel() * t.element_size()
            for t in residency.tensors(params))
    batch = 2 * 2 * 32 * 4                       # tokens and labels, int32
    assert rec["memory"]["argument_bytes"] == n + 2 * 2 * n + batch


def test_full_decode_cell_and_skips(tmp_path):
    out = tmp_path / "d.jsonl"
    dryrun.main(["--arch", "rns-smollm-135m-fused", "--shape", "decode_32k",
                 "--out", str(out)])
    dryrun.main(["--arch", "smollm-135m", "--shape", "long_500k", "--out",
                 str(out)])
    dryrun.main(["--arch", "mamba2-1.3b", "--shape", "long_500k", "--out",
                 str(out)])
    dec, skip, ssm = [json.loads(l) for l in out.read_text().splitlines()]
    cfg = get_config("rns-smollm-135m-fused")
    assert dec["status"] == "ok" and dec["mesh"] == "1x1"
    assert dec["kernel_calls"] == {"rns_fused_matmul": 210}
    assert dec["analytic"] == analytic_cost(
        cfg, SHAPES["decode_32k"], n_pods=1, data=1, model=1).as_dict()
    # a 128 × 32768-slot KV cache of 30 layers is the argument
    cache = 2 * 30 * 128 * 32768 * 3 * 64 * 2
    assert dec["memory"]["argument_bytes"] > cache
    assert dec["roofline"]["dominant"] == "memory"
    assert skip["status"] == "skip" and "long_500k" in \
        get_config("smollm-135m").skip_shapes
    assert ssm["status"] == "ok" and ssm["shape"] == "long_500k"


def test_errors_are_recorded_with_the_op(monkeypatch):
    """A step that reads the device on meta is an error line naming the
    op, never a dropped cell."""
    cfg = get_smoke_config("smollm-135m")
    norm = T.rms_norm

    def reads(x, *a, **k):
        x.abs().max().item()
        return norm(x, *a, **k)

    monkeypatch.setattr(T, "rms_norm", reads)
    rec = dryrun.run_cell(cfg, SMALL[1])
    assert rec["status"] == "error" and rec["op"] == \
        "aten._local_scalar_dense"
    assert "Error" in rec["error"]


def _digest(path):
    return hashlib.sha256(path.read_bytes()).hexdigest() \
        if path.exists() else None


def test_default_out_is_build_and_never_the_reference_log(tmp_path,
                                                         monkeypatch):
    ref = ROOT / "experiments" / "dryrun.jsonl"
    before = _digest(ref)
    assert dryrun.DEFAULT_OUT.parent.parent == ROOT / "build"
    assert "build/" in (ROOT / ".gitignore").read_text().split()
    out = tmp_path / "build" / "dryrun" / "dryrun.jsonl"
    monkeypatch.setattr(dryrun, "DEFAULT_OUT", out)
    dryrun.main(["--arch", "smollm-135m", "--batch", "2", "--seq", "16",
                 "--kind", "decode", "--jobs", "2"])
    (rec,) = [json.loads(l) for l in out.read_text().splitlines()]
    assert rec["status"] == "ok" and rec["shape"] == "decode_b2_s16"
    assert _digest(ref) == before


@pytest.mark.parametrize("arch,unused", [
    ("musicgen-large", "w_up"),          # a non-GLU MLP reads w_gate only
    ("phi-3-vision-4.2b", "embed")])     # an embeddings frontend
def test_train_step_gives_unused_params_zero_grads(arch, unused):
    """The dry run's train cells of these configs found autograd refusing
    a parameter the loss does not read; the reference's gradient there is
    zero, and so is the port's."""
    from repro_torch.launch import train as cli
    from repro_torch.train.trainstep import _value_and_grad

    cfg = get_smoke_config(arch)
    params = T.make_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    batch = cli.make_batch_fn(cfg, 0, 2, 8, "cpu")(0)
    _, _, grads = _value_and_grad(cfg, params, batch)

    def find(node, key):
        for k, v in node.items():
            if k == key:
                return v
            if isinstance(v, dict) and (hit := find(v, key)) is not None:
                return hit
        return None

    g = find(grads, unused)
    assert g is not None and g.shape == find(params, unused).shape
    assert not g.any()
    assert all(t.any() for k, t in grads["blocks"]["sub0"]["attn"].items())
