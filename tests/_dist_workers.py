"""Process groups of the port's distributed tests: `spawn_group` starts n
ranks (spawned processes, ``gloo`` over a `FileStore` in the test's own
directory, so concurrent groups never share a port), runs one task on
every rank and returns each rank's result; the task functions below are
what the ranks run.  Torch and the port only: the reference is compared in
the parent.  Every rank is joined with a deadline; a rank that fails or
outlives it fails the group, and the rest are killed."""
import pathlib
import time
import traceback

import numpy as np
import torch

PROMPTS = [[5, 6, 7, 8, 9], [3, 1, 4, 1, 5, 9, 2, 6], [2, 7], [11, 3, 8]]
NEW_TOKENS = 8
LAYOUTS = ("channel", "column")
# the scheduled serve: 2 slots of 24 tokens in blocks of 4, chunks of 2
# steps; five requests (two sharing a prefix) arriving staggered, so that
# admissions splice prefills into a running decode
SCHED = {"slots": 2, "block_size": 4, "slot_tokens": 24, "decode_chunk": 2}
SCHED_REQUESTS = [([5, 6, 7, 8, 9, 10], 6, 0.0),
                  ([5, 6, 7, 8, 2, 7, 1], 4, 1.0), ([3, 1, 4, 1, 5], 8, 2.0),
                  ([11, 3, 8], 7, 3.0), ([9, 2, 6, 5, 3, 5, 8, 9, 7], 5, 6.0)]


def _rank_main(task, rank, n, tmp, args, errq):
    try:
        import torch.distributed as dist

        torch.set_num_threads(1)
        store = dist.FileStore(str(pathlib.Path(tmp) / "store"), n)
        dist.init_process_group("gloo", store=store, rank=rank, world_size=n)
        from repro_torch.launch.mesh import make_host_mesh

        out = task(rank, n, make_host_mesh(model=n), *args)
        torch.save(out, pathlib.Path(tmp) / f"rank{rank}.pt")
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        errq.put((rank, traceback.format_exc()))
        raise


def spawn_group(task, n, tmp, *args, timeout=170.0):
    """``task(rank, n, mesh, *args)`` on n spawned ranks; the list of their
    results (whatever `torch.save` keeps), rank order."""
    import torch.multiprocessing as mp

    tmp = pathlib.Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    ctx = mp.get_context("spawn")
    errq = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(task, r, n, str(tmp), args,
                                                  errq), daemon=True)
             for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        late = [r for r, p in enumerate(procs) if p.is_alive()]
        errors = []
        while not errq.empty():
            errors.append(errq.get())
        if errors:
            raise AssertionError(f"ranks failed: {errors}")
        if late:
            raise AssertionError(f"ranks {late} of {n} outlived {timeout} s")
        bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode]
        if bad:
            raise AssertionError(f"ranks exited with {bad}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(n)]


# ------------------------------------------------------------------ tasks --
def launch_operands(seed=0, M=8, K=64, N=32):
    """The seeded numpy operands of the launch cases: x (M, K), w (K, N),
    a raw int8 gate (M, K)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    x[0, :2] = (40.0, -40.0)
    w = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    gate = rng.integers(-128, 128, (M, K)).astype(np.int8)
    return x, w, gate


LAUNCH_CASES = [(lay, form) for lay in LAYOUTS
                for form in ("residues:float", "residues:residues",
                             "quantize", "gated", "live")]


def launch_outputs(x, w, gate, layout, form, ctx=None):
    """One launch case through `sharded_fused_matmul` (``ctx`` None: the
    plain `rns_fused_matmul`, the one-process answer): the float output,
    or (residues, scale) for an ``emit="residues"`` launch."""
    from repro_torch.core import rns_tensor as rt
    from repro_torch.core.quant import quant_scale, quantize_int8
    from repro_torch.core.rns import basis_for_int8_matmul
    from repro_torch.dist.rns_shard import sharded_fused_matmul
    from repro_torch.kernels.rns_fused import rns_fused_matmul

    basis = basis_for_int8_matmul(x.shape[1])
    xt, wtf = torch.from_numpy(x), torch.from_numpy(w)
    xa, wt = rt.encode_activation(xt, basis), rt.encode(wtf, basis)
    fn = rns_fused_matmul if ctx is None else \
        (lambda *a, **k: sharded_fused_matmul(*a, ctx=ctx, layout=layout,
                                              **k))
    if form.startswith("residues:"):
        emit = form.split(":")[1]
        out = fn(xa, wt, scale_row=xa.scale, scale_col=wt.scale, emit=emit)
        return (out.residues, out.scale) if emit == "residues" else out
    if form == "gated":
        srow = xa.scale * 0.5
        return fn(xa, wt, scale_row=srow, scale_col=wt.scale,
                  gate=torch.from_numpy(gate))
    sx = quant_scale(xt, dim=-1)
    if form == "quantize":
        return fn(xt, wt, scale_row=sx, scale_col=wt.scale)
    wq, sw = quantize_int8(wtf, dim=0)
    return fn(xt, wq, basis, scale_row=sx, scale_col=sw)


def launch_task(rank, n, mesh, x, w, gate):
    from repro_torch.dist.context import DistContext

    return {(lay, form): launch_outputs(x, w, gate, lay, form,
                                        DistContext(mesh=mesh, layout=lay))
            for lay, form in LAUNCH_CASES}


def engine_task(rank, n, mesh, cases, params_path):
    """Each (arch, layout): a sharded smoke Engine's greedy tokens under
    ``engine="host"`` and the uncaptured ``"scan"``, its prefill logits,
    its crt / fused launches by kernel region over a generate of 2 tokens,
    and the decode step's as `dist.engine.decode_launches` reads them off
    the placed weights."""
    from repro_torch.analysis.residency import TraceMode
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.dist.engine import decode_launches
    from repro_torch.serve.engine import Engine

    params = torch.load(params_path, weights_only=False)
    out = {}
    for arch, layout in cases:
        eng = Engine(get_smoke_config(arch), params[arch], smax=64, lanes=4,
                     device="cpu", mesh=mesh, dist_layout=layout)
        res = {"host": eng.generate(PROMPTS, NEW_TOKENS, engine="host"),
               "scan": eng.generate(PROMPTS, NEW_TOKENS, engine="scan"),
               "logits": eng.prefill_logits(PROMPTS),
               "captured": eng.captured, "replays": eng.scan_replays}
        with TraceMode() as mode:
            eng.generate(PROMPTS[:1], 2, engine="host")
        res["generate_calls"] = dict(mode.summary.kernel_calls)
        res["decode_launches"] = decode_launches(eng.cfg, eng.params)
        out[(arch, layout)] = res
    return out


def sched_requests():
    from repro_torch.serve import Request

    return [Request(p, m, arrival=a) for p, m, a in SCHED_REQUESTS]


def sched_task(rank, n, mesh, cases, params_path):
    """Each (arch, layout): the tokens and stats of a `SlotScheduler`
    under the mesh serving `SCHED_REQUESTS`, its kernel calls by region,
    and whether its engine captured."""
    from repro_torch.analysis.residency import TraceMode
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.serve import SlotScheduler

    params = torch.load(params_path, weights_only=False)
    out = {}
    for arch, layout in cases:
        sched = SlotScheduler(get_smoke_config(arch), params[arch],
                              device="cpu", mesh=mesh, dist_layout=layout,
                              **SCHED)
        with TraceMode() as mode:
            tokens = sched.serve(sched_requests())
        out[(arch, layout)] = {"tokens": tokens,
                               "calls": dict(mode.summary.kernel_calls),
                               "stats": dict(sched.stats),
                               "admissions": sched.admissions,
                               "captured": sched.engine.captured}
    return out


def wire_task(rank, n, mesh, arch, params_path):
    """One channel-sharded decode step of ``arch``'s smoke twin under the
    residency pass, and a planted all-reduce of a (C, M, N) int8 residue
    stack: both traces' collectives."""
    from repro_torch.analysis.residency import TraceMode
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.dist import comms
    from repro_torch.dist import context as dc
    from repro_torch.dist.engine import make_context, place_params
    from repro_torch.models import transformer as T

    cfg = get_smoke_config(arch)
    params = torch.load(params_path, weights_only=False)[arch]
    ctx = make_context(cfg, mesh, layout="channel")
    with torch.inference_mode():
        placed = place_params(ctx, cfg, params)
        cache = T.init_cache(cfg, 2, 32, "cpu")
        tok = torch.zeros((2, 1), dtype=torch.int64)
        with dc.use(ctx), TraceMode() as mode:
            T.decode_step(cfg, placed, cache, {"tokens": tok}, 4)
        with TraceMode() as planted:
            comms.all_reduce(torch.zeros((4, 2, 16), dtype=torch.int8),
                             ctx.group)
    return {"step": mode.summary.collectives,
            "calls": dict(mode.summary.kernel_calls),
            "planted": planted.summary.collectives}


def dist_task(rank, n, mesh, operands, cases, params_path, wire_arch,
              sched_cases):
    """`launch_task`, `engine_task`, `sched_task` and `wire_task` in one
    group."""
    return {"launch": launch_task(rank, n, mesh, *operands),
            "engine": engine_task(rank, n, mesh, cases, params_path),
            "sched": sched_task(rank, n, mesh, sched_cases, params_path),
            "wire": wire_task(rank, n, mesh, wire_arch, params_path)}


def int8_operands(n, seed=1, M=8, N=40):
    """Raw int8 x (M, K), w (K, N) and the scale forms of the
    `rns_int_matmul` cases of an n-rank group: K = 64 (C = 4) for 2 ranks,
    K = 128 (C = 5) for 5, so that the channel layout splits C evenly; N
    splits over 2 and 5."""
    K = {2: 64, 5: 128}[n]
    rng = np.random.default_rng(seed + n)
    x = rng.integers(-128, 128, (M, K)).astype(np.int8)
    w = rng.integers(-128, 128, (K, N)).astype(np.int8)
    scales = {"none": None,
              "n": rng.uniform(0.01, 1.0, (N,)).astype(np.float32),
              "m1": rng.uniform(0.01, 1.0, (M, 1)).astype(np.float32),
              "mn": rng.uniform(0.01, 1.0, (M, N)).astype(np.float32)}
    return x, w, scales


def int8_outputs(x, w, scales, mesh=None):
    """{(layout, weight, scale): output} of `rns_int_matmul` on its fused
    route, under a context of each layout on ``mesh`` (None: no context,
    the unsharded launch), with the layout each launch resolved to."""
    from repro_torch.core import rns_tensor as rt
    from repro_torch.core.rns_linear import rns_int_matmul
    from repro_torch.dist import context
    from repro_torch.dist.rns_shard import rank_launch

    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    weights = {"live": wt, "encoded": rt.RNSTensor.from_int8(wt)}
    out = {}
    for lay in LAYOUTS:
        ctx = None if mesh is None else context.DistContext(mesh=mesh,
                                                            layout=lay)
        with context.use(ctx):
            for wname, wq in weights.items():
                for sname, s in scales.items():
                    sc = None if s is None else torch.from_numpy(s)
                    out[(lay, wname, sname)] = rns_int_matmul(xt, wq,
                                                              scale=sc)
        if ctx is not None:
            out[(lay, "resolved")] = rank_launch(xt, wt, ctx=ctx).layout
    return out


def int8_task(rank, n, mesh, x, w, scales):
    return int8_outputs(x, w, scales, mesh)


def compression_task(rank, n, mesh, grads_path):
    """`compressed_mean_all_reduce` of this rank's gradients (entry
    ``rank`` of the saved per-rank lists)."""
    from repro_torch.train.compression import compressed_mean_all_reduce

    grads = torch.load(grads_path, weights_only=False)[rank]
    return compressed_mean_all_reduce(grads, mesh.group("model"))


# ------------------------------------------------- the families on meshes --
def _mesh2(shape):
    """A ("data", "model") DeviceMesh of the given shape over the group."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))


def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def moe_task(rank, n, mesh, arch, overrides, shapes, B, S, seed):
    """`moe_apply` plain and on DTensors, on each ("data", "model") mesh
    shape of ``shapes``: tokens sharded over "data", experts over "model"
    (the dry run's expert rule).  Returns [(y, aux) plain, then (y, aux)
    a mesh]."""
    import dataclasses

    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models import moe

    cfg = dataclasses.replace(get_smoke_config(arch), **overrides)
    g = torch.Generator().manual_seed(seed)
    params = moe.make_moe_params(cfg, g, "cpu")
    x = torch.randn(B, S, cfg.d_model, generator=g).to(
        getattr(torch, cfg.param_dtype))
    out = [moe.moe_apply(params, x, cfg)]
    for shape in shapes:
        dm = _mesh2(shape)

        def place(t, path):
            expert = path in ("w_gate", "w_up", "w_down")
            return distribute_tensor(t, dm, [Replicate(),
                                             Shard(0) if expert
                                             else Replicate()])

        pd = {k: ({kk: place(vv, "") for kk, vv in v.items()}
                  if isinstance(v, dict) else place(v, k))
              for k, v in params.items()}
        xd = distribute_tensor(x, dm, [Shard(0), Replicate()])
        y, aux = moe.moe_apply(pd, xd, cfg)
        out.append((_full(y), _full(aux)))
    return out


def ssm_decode_task(rank, n, mesh, arch, overrides, B, seed):
    """`ssm_decode_step` plain and on DTensors placed by the dry run's rules
    (`launch.sharding.param_specs` in "tp" mode, `cache_specs`), one token
    against a seeded state.  Returns (y, state) of each."""
    import dataclasses

    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs.base import get_smoke_config
    from repro_torch.launch.sharding import (cache_specs, distribute,
                                             param_specs)
    from repro_torch.models import ssm

    cfg = dataclasses.replace(get_smoke_config(arch), **overrides)
    g = torch.Generator().manual_seed(seed)
    params = ssm.make_ssm_params(cfg, g, "cpu")
    cache = ssm.init_ssm_cache(cfg, B, "cpu")
    cache = {k: torch.randn(v.shape, generator=g).to(v.dtype)
             for k, v in cache.items()}
    x = torch.randn(B, 1, cfg.d_model, generator=g).to(
        getattr(torch, cfg.param_dtype))
    y0, c0 = ssm.ssm_decode_step(params, x, {k: v.clone()
                                             for k, v in cache.items()}, cfg)
    pd = distribute(mesh, params, param_specs(mesh, cfg, params, "tp"))
    cd = distribute(mesh, cache, cache_specs(mesh, cfg, cache))
    # the hidden state as a layer hands it on: its features over "model"
    xd = distribute_tensor(x, mesh.device_mesh, [Replicate(), Shard(2)])
    with implicit_replication():
        y, c = ssm.ssm_decode_step(pd, xd, cd, cfg)
    return (y0, c0["state"]), (_full(y), _full(c["state"]))


def ring_attention_task(rank, n, mesh, B, W, Hq, Hk, D, seed,
                        shape=None, window=None):
    """`layers.attention` of one query token over a cache, plain and on a
    ("pod", "data", "model") mesh (``shape``, default (n, 1, 1)) with the
    cache's slots sharded over "model" (the dry run's `cache_specs`) and
    the query replicated.  Returns (plain, mesh) outputs."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models.layers import attention

    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, 1, Hq, D, generator=g)
    k = torch.randn(B, W, Hk, D, generator=g)
    v = torch.randn(B, W, Hk, D, generator=g)
    kpos = torch.randint(-1, 3 * W, (W,), generator=g)
    qpos = torch.full((1,), 3 * W)
    kw = {} if window is None else dict(window=window)
    want = attention(q, k, v, qpos, kpos, **kw)
    dm = init_device_mesh("cpu", shape or (n, 1, 1),
                          mesh_dim_names=("pod", "data", "model"))
    rep = [Replicate()] * 3
    cache = [Replicate(), Replicate(), Shard(1)]
    qd, kd, vd = (distribute_tensor(q, dm, rep),
                  distribute_tensor(k, dm, cache),
                  distribute_tensor(v, dm, cache))
    with implicit_replication():
        got = attention(qd, kd, vd, qpos, kpos, **kw)
    return want, _full(got)


def ssm_apply_task(rank, n, mesh, arch, overrides, B, S, seed):
    """`ssm_apply` (the chunked prefill, its causal conv without a state)
    plain and on DTensors placed by the dry run's rules (`param_specs` in
    "tp" mode), the batch over "data" and the features over "model".
    Returns (plain, mesh) outputs."""
    import dataclasses

    from torch.distributed.tensor import Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs.base import get_smoke_config
    from repro_torch.launch.sharding import distribute, param_specs
    from repro_torch.models import ssm

    cfg = dataclasses.replace(get_smoke_config(arch), **overrides)
    g = torch.Generator().manual_seed(seed)
    params = ssm.make_ssm_params(cfg, g, "cpu")
    x = torch.randn(B, S, cfg.d_model, generator=g).to(
        getattr(torch, cfg.param_dtype))
    want = ssm.ssm_apply(params, x, cfg)
    pd = distribute(mesh, params, param_specs(mesh, cfg, params, "tp"))
    xd = distribute_tensor(x, mesh.device_mesh, [Shard(0), Shard(2)])
    with implicit_replication():
        got = ssm.ssm_apply(pd, xd, cfg)
    return want, _full(got)


def local_matmul_task(rank, n, mesh, seed):
    """`layers.local_matmul` of the attention's shapes, (B, Hk, G, Sq, D) ·
    (B, Hk, 1, D, Sk), on a (1, n) ("data", "model") mesh, against
    torch.matmul of the whole operands, for each pair of placements of
    the "model" dim: heads on both, the query's heads against the keys'
    slots (the decode cache), the batch on one operand only, and the
    contraction on both (a partial sum).  Returns [(want, got), ...]."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models.layers import local_matmul

    dm = _mesh2((1, n))
    g = torch.Generator().manual_seed(seed)
    a = torch.randn(4, 2 * n, 3, 1, 8, generator=g, dtype=torch.float64)
    b = torch.randn(4, 2 * n, 1, 8, 6 * n, generator=g, dtype=torch.float64)
    want = torch.matmul(a, b)
    out = []
    for pa, pb in ((Shard(1), Shard(1)), (Shard(1), Shard(4)),
                   (Shard(0), Replicate()), (Shard(4), Shard(3))):
        got = local_matmul(distribute_tensor(a, dm, [Replicate(), pa]),
                           distribute_tensor(b, dm, [Replicate(), pb]))
        out.append((want, _full(got)))
    return out


def tp_matmul_task(rank, n, mesh, seed):
    """`layers.matmul` (x @ w on DTensors: `tp_matmul`) and its gradients,
    float64, on each one-axis ("data", "model") mesh of the group, x's
    batch over "data" and w's columns, rows or (over "data") its FSDP
    rows sharded, against the plain product and autograd.  Returns
    [(want, got) for y, dx, dw of each case]."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models.layers import matmul

    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2 * n, 3, 4 * n, generator=g, dtype=torch.float64)
    w = torch.randn(4 * n, 6 * n, generator=g, dtype=torch.float64)
    r = torch.randn(2 * n, 3, 6 * n, generator=g, dtype=torch.float64)
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    (matmul(xg, wg) * r).sum().backward()
    want = (x @ w, xg.grad, wg.grad)
    out = []
    for shape in ((n, 1), (1, n)):
        dm = _mesh2(shape)
        for pw in (Shard(1), Shard(0)):
            xd = distribute_tensor(x, dm, [Shard(0), Replicate()]
                                   ).requires_grad_()
            wd = distribute_tensor(w, dm, [Shard(0), pw]).requires_grad_()
            with implicit_replication():
                y = matmul(xd, wd)
                (y * distribute_tensor(r, dm, [Shard(0), Replicate()])
                 ).sum().backward()
            out += list(zip(want, (_full(y), _full(xd.grad),
                                   _full(wd.grad))))
    return out


def prefill_attention_task(rank, n, mesh, B, S, Hq, Hk, D, seed):
    """`layers.attention` of a causal prefill and its query gradient,
    plain and on a (1, n) ("data", "model") mesh whose "model" dim shards
    neither the batch nor the KV heads (``Hk`` it does not divide): the
    mesh run takes a share of the batch where ``n`` divides ``B``, else of
    the query rows.  Returns (plain, mesh) (output, dq) pairs."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models.layers import attention

    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, S, Hq, D, generator=g)
    k = torch.randn(B, S, Hk, D, generator=g)
    v = torch.randn(B, S, Hk, D, generator=g)
    r = torch.randn(B, S, Hq, D, generator=g)
    pos = torch.arange(S)
    qg = q.clone().requires_grad_()
    want = attention(qg, k, v, pos, pos)
    (want * r).sum().backward()
    dm = _mesh2((1, n))
    rep = [Replicate()] * 2
    qd = distribute_tensor(q, dm, rep).requires_grad_()
    kd, vd = distribute_tensor(k, dm, rep), distribute_tensor(v, dm, rep)
    with implicit_replication():
        got = attention(qd, kd, vd, pos, pos)
        (got * distribute_tensor(r, dm, rep)).sum().backward()
    return (want.detach(), _full(got)), (qg.grad, _full(qd.grad))


def local_weight_task(rank, n, mesh, seed):
    """`layers.local_weight`: each rank applies a weight to its share of
    the tokens (x's rows over "data" of an (n, 1) mesh), and the weight's
    gradient is the sum over the shares, reduced into its placement
    (whole, or an FSDP row shard over "data").  Returns [(want, got)]."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models.layers import local_weight

    g = torch.Generator().manual_seed(seed)
    x = torch.randn(4 * n, 2 * n, generator=g, dtype=torch.float64)
    w = torch.randn(2 * n, 5, generator=g, dtype=torch.float64)
    r = torch.randn(4 * n, 5, generator=g, dtype=torch.float64)
    wg = w.clone().requires_grad_()
    ((x @ wg) * r).sum().backward()
    dm = _mesh2((n, 1))
    out = []
    for pw in (Replicate(), Shard(0)):
        wd = distribute_tensor(w, dm, [pw, Replicate()]).requires_grad_()
        xl = distribute_tensor(x, dm, [Shard(0), Replicate()]).to_local()
        rl = distribute_tensor(r, dm, [Shard(0), Replicate()]).to_local()
        wl = local_weight(wd, dm, [Replicate(), Replicate()], [0])
        ((xl @ wl) * rl).sum().backward()
        out.append((wg.grad, _full(wd.grad)))
    return out


def vocab_loss_task(rank, n, mesh, seed):
    """`trainstep._lse_and_label_on_shards` of float64 logits with the
    batch over "data" and the vocab over "model", on each one-axis mesh
    of the group, against `torch.logsumexp`, the labels' logits and the
    logits' gradient of their mean difference.  Returns [(want, got)]."""
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.train.trainstep import _lse_and_label_on_shards

    g = torch.Generator().manual_seed(seed)
    logits = torch.randn(2 * n, 3, 5 * n, generator=g, dtype=torch.float64)
    labels = torch.randint(0, 5 * n, (2 * n, 3), generator=g)
    lg = logits.clone().requires_grad_()
    lse = torch.logsumexp(lg, dim=-1)
    ll = torch.gather(lg, -1, labels[..., None])[..., 0]
    (lse - ll).mean().backward()
    out = []
    for shape in ((n, 1), (1, n)):
        dm = _mesh2(shape)
        ld = distribute_tensor(logits, dm, [Shard(0), Shard(2)]
                               ).requires_grad_()
        got = _lse_and_label_on_shards(
            ld, distribute_tensor(labels, dm, [Shard(0), Shard(0)]))
        (got[0] - got[1]).mean().backward()
        out += [(lse.detach(), _full(got[0])), (ll.detach(), _full(got[1])),
                (lg.grad, _full(ld.grad))]
    return out


def mesh_ops_task(rank, n, mesh, seed):
    """The model code's DTensor paths in one group: `tp_matmul_task`,
    `local_weight_task`, `vocab_loss_task` and `prefill_attention_task`
    with B 2 and 1 (8 tokens, 6 query heads over 3 KV heads of 16)."""
    return {"tp_matmul": tp_matmul_task(rank, n, mesh, seed),
            "local_weight": local_weight_task(rank, n, mesh, seed),
            "vocab_loss": vocab_loss_task(rank, n, mesh, seed),
            **{f"attention_b{B}": prefill_attention_task(
                rank, n, mesh, B, 8, 6, 3, 16, seed) for B in (2, 1)}}
