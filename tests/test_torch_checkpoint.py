"""Checkpoints, the fault-tolerant loop and the data pipeline of the port
(`train/checkpoint.py`, `train/runtime.py`, `data/pipeline.py`) on the
CPU: round trip, atomicity, ``keep_last``, asynchronous saves; a whole
training state (bf16 parameters and AdamW's float32 moments) written by
the reference's `ckpt.save` restores into the port bit for bit and the
reverse; `TrainLoop`'s auto-resume (resumed steps bit-equal to straight
ones) and its emergency save on SIGTERM; the pipeline bit-equal to the
reference's, host shards included.  Every comparison is exact."""
import json
import os
import signal

import jax
import numpy as np
import pytest
import torch

import _train_compare as tc
from repro.data import pipeline as JP
from repro.train import checkpoint as jckpt
from repro.train import optimizer as JO
from repro.train import trainstep as JS
from repro_torch.data import pipeline as TP
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import make_optimizer
from repro_torch.train.runtime import TrainLoop
from repro_torch.train.trainstep import make_train_step
from repro_torch.train.tree import leaves


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(6, 4, generator=g).to(torch.bfloat16),
            "blocks": {"b": torch.randn(3, 4, generator=g),
                       "i": torch.arange(5, dtype=torch.int32)}}


def _equal(a, b):
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def test_roundtrip_and_atomic_publish(tmp_path):
    d = str(tmp_path)
    state = _state()
    path = ckpt.save(d, 7, state)
    assert path == os.path.join(d, "step-7") and ckpt.latest_step(d) == 7
    like = {"w": torch.zeros(6, 4, dtype=torch.bfloat16),
            "blocks": {"b": torch.zeros(3, 4),
                       "i": torch.zeros(5, dtype=torch.int32)}}
    got, step = ckpt.restore(d, 7, like)
    assert step == 7 and _equal(got, state)
    assert not any(x.startswith("tmp-") for x in os.listdir(d))
    with open(os.path.join(path, "manifest.json")) as f:
        man = json.load(f)
    # leaves in the reference's order: blocks/b, blocks/i, w
    assert man["dtypes"] == ["float32", "int32", "bfloat16"]
    assert man["shapes"] == [[3, 4], [5], [6, 4]] and man["n_leaves"] == 3
    # a save cut off before its rename leaves only tmp-8: never restored
    os.makedirs(os.path.join(d, "tmp-8"))
    np.save(os.path.join(d, "tmp-8", "0.npy"), np.zeros(3))
    assert ckpt.latest_step(d) == 7
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(d, 7, {**like, "w": torch.zeros(4, 6)})


def test_keep_last_and_async(tmp_path):
    d = str(tmp_path)
    for s in range(5):
        ckpt.save(d, s, {"w": torch.full((4,), float(s))}, keep_last=2,
                  blocking=False)
        ckpt.wait_for_pending()
    assert sorted(int(x.split("-")[1]) for x in os.listdir(d)) == [3, 4]
    got, _ = ckpt.restore(d, 4, {"w": torch.zeros(4)})
    assert torch.equal(got["w"], torch.full((4,), 4.0))


def _trained(steps=1):
    """Reference and port training states of smollm-smoke after ``steps``
    AdamW steps each (nonzero moments), and the port's zero state."""
    jcfg, tcfg = tc.configs("smollm-135m")
    jp, tp = tc.params(jcfg, tcfg)
    jopt = JO.make_optimizer(jcfg, total_steps=10, base_lr=1e-2, warmup=1)
    topt = make_optimizer(tcfg, total_steps=10, base_lr=1e-2, warmup=1)
    jstep = jax.jit(JS.make_train_step(jcfg, jopt))
    tstep = make_train_step(tcfg, topt)
    js, ts = jopt.init(jp), topt.init(tp)
    like = (tp, topt.init(tp))
    for s in range(steps):
        jb, tb = tc.batches(jcfg, step=s)
        jp, js, _ = jstep(jp, js, jb, s + 1)
        tp, ts, _ = tstep(tp, ts, tb, s + 1)
    return (jp, js), (tp, ts), like


def _np(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def test_reference_checkpoint_restores_into_port(tmp_path):
    (jp, js), _, like = _trained()
    jckpt.save(str(tmp_path), 3, (jp, js), blocking=True)
    (tp, ts), step = ckpt.restore(str(tmp_path), 3, like)
    assert step == 3
    want = jax.tree.leaves((jp, js))
    got = leaves((tp, ts))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(_np(g), _np(w))
    assert tp["embed"].dtype == torch.bfloat16 and ts["m"]["embed"].dtype \
        == torch.float32


def test_port_checkpoint_restores_into_reference(tmp_path):
    (jp, js), (tp, ts), _ = _trained()
    ckpt.save(str(tmp_path), 4, (tp, ts))
    (rp, rs), step = jckpt.restore(str(tmp_path), 4, (jp, js))
    assert step == 4
    for g, w in zip(jax.tree.leaves((rp, rs)), leaves((tp, ts))):
        assert np.asarray(g).dtype.name == str(w.dtype).removeprefix(
            "torch.")
        assert np.array_equal(_np(g), _np(w))


def _loop(workdir, tcfg, tp, opt, **kw):
    step = make_train_step(tcfg, opt)

    def batch_fn(s):
        return tc.batches(tcfg, step=s)[1]

    return TrainLoop(train_step=step, batch_fn=batch_fn, params=tp,
                     opt_state=opt.init(tp), workdir=workdir, **kw)


def test_auto_resume_bit_equal(tmp_path):
    """2 steps, a checkpoint, a new loop that resumes and 2 more steps
    equal 4 straight steps: parameters and both moments, bit for bit."""
    jcfg, tcfg = tc.configs("smollm-135m")
    _, tp = tc.params(jcfg, tcfg)
    opt = make_optimizer(tcfg, total_steps=10, base_lr=1e-2, warmup=1)
    straight = _loop(str(tmp_path / "a"), tcfg, tp, opt, ckpt_every=0)
    straight.run(4)
    first = _loop(str(tmp_path / "b"), tcfg, tp, opt, ckpt_every=2)
    assert first.run(2)["last_step"] == 1
    resumed = _loop(str(tmp_path / "b"), tcfg, tp, opt, ckpt_every=2)
    assert resumed.start_step == 2
    res = resumed.run(4)
    assert len(res["losses"]) == 2 and res["last_step"] == 3
    assert _equal((resumed.params, resumed.opt_state),
                  (straight.params, straight.opt_state))
    assert ckpt.latest_step(str(tmp_path / "b" / "ckpt")) == 3


def test_reference_checkpoint_resumes_in_port_loop(tmp_path):
    (jp, js), _, _ = _trained()
    jckpt.save(str(tmp_path / "ckpt"), 5, (jp, js), blocking=True)
    jcfg, tcfg = tc.configs("smollm-135m")
    _, tp = tc.params(jcfg, tcfg)
    opt = make_optimizer(tcfg, total_steps=10, base_lr=1e-2, warmup=1)
    loop = _loop(str(tmp_path), tcfg, tp, opt, ckpt_every=0)
    assert loop.start_step == 6
    assert np.array_equal(_np(loop.params["embed"]), _np(jp["embed"]))
    assert np.array_equal(_np(loop.opt_state["v"]["final_norm"]),
                          _np(js["v"]["final_norm"]))


def test_sigterm_saves_and_exits(tmp_path):
    jcfg, tcfg = tc.configs("smollm-135m")
    _, tp = tc.params(jcfg, tcfg)
    opt = make_optimizer(tcfg, total_steps=10, base_lr=1e-2, warmup=1)
    step = make_train_step(tcfg, opt)

    def batch_fn(s):
        if s == 3:                           # a preemption notice
            os.kill(os.getpid(), signal.SIGTERM)
        return tc.batches(tcfg, step=s)[1]

    before = signal.getsignal(signal.SIGTERM)
    loop = TrainLoop(train_step=step, batch_fn=batch_fn, params=tp,
                     opt_state=opt.init(tp), workdir=str(tmp_path),
                     ckpt_every=0, log_every=1)
    res = loop.run(10)
    assert len(res["losses"]) == 4 and res["last_step"] == 3
    assert ckpt.latest_step(str(tmp_path / "ckpt")) == 3
    assert signal.getsignal(signal.SIGTERM) == before
    events = [json.loads(x) for x in open(tmp_path / "metrics.jsonl")]
    assert events[-1] == {"step": 3, "event": "sigterm_save"}
    assert [e["step"] for e in events if "loss" in e] == [0, 1, 2, 3]
    again = TrainLoop(train_step=step, batch_fn=batch_fn, params=tp,
                      opt_state=opt.init(tp), workdir=str(tmp_path))
    assert again.start_step == 4
    assert _equal(again.params, loop.params)


@pytest.mark.parametrize("seed,step,batch,seq,vocab", [
    (0, 0, 8, 32, 128), (0, 5, 8, 16, 100), (3, 11, 4, 64, 49152),
    (7, 1 << 10, 2, 9, 17)])
def test_pipeline_bit_equal_reference(seed, step, batch, seq, vocab):
    want = JP.batch_for_step(seed, step, batch, seq, vocab)
    got = TP.batch_for_step(seed, step, batch, seq, vocab)
    for k in ("tokens", "labels"):
        assert got[k].dtype == want[k].dtype
        assert np.array_equal(got[k], want[k])
    for h in range(2):
        w = JP.host_shard_batch(seed, step, batch, seq, vocab, h, 2)
        g = TP.host_shard_batch(seed, step, batch, seq, vocab, h, 2)
        assert np.array_equal(g["tokens"], w["tokens"])
        assert np.array_equal(g["labels"], w["labels"])
    with pytest.raises(ValueError, match="split"):
        TP.host_shard_batch(seed, step, batch, seq, vocab, 0, 3)
