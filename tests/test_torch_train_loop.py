"""The port's fault-tolerant training loop and its machinery, mirroring
``tests/test_fault_tolerance.py`` on the port:

- a run killed by ``FailureInjector`` and resumed from its latest
  checkpoint ends with bitwise the same parameters and optimizer state as a
  straight run (the restart-exactness contract), on the CPU;
- preemption checkpoints and the next run resumes from it;
- the straggler detector on a fake clock;
- the atomic ``Heartbeat``: a reader polling while it rewrites the file
  never sees it empty or half written (the reference's heartbeat opens its
  file with "w" before writing, so its reader can; the reference is not
  changed);
- the synthetic LM stream equals the reference's, and the prefetch loader
  copies each batch before handing it over.
"""

import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.usefixtures("one_torch_thread")

from _torch_parity import one_torch_thread  # noqa: E402,F401

from repro.data.synthetic import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.data.synthetic import SyntheticLMConfig as JSyntheticLMConfig  # noqa: E402
from repro_torch.configs import TrainConfig, get_config  # noqa: E402
from repro_torch.data import PrefetchLoader, SyntheticLM, SyntheticLMConfig  # noqa: E402
from repro_torch.data.synthetic import make_batch_fn  # noqa: E402
from repro_torch.train import (  # noqa: E402
    FailureInjector,
    Heartbeat,
    PreemptionHandler,
    StepTimer,
    run_training,
)

CFG = get_config("granite-8b", reduced=True)


def _ds(seq=16, batch=4):
    return SyntheticLM(SyntheticLMConfig(vocab_size=CFG.vocab_size, seq_len=seq,
                                         global_batch=batch))


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], path + (k,))]
    return [(path, tree)]


def test_failure_injection_then_restart_is_bitwise_exact(tmp_path):
    ds = _ds()
    tc = TrainConfig(total_steps=12, warmup_steps=2, checkpoint_every=4, learning_rate=1e-3)
    res_a = run_training(CFG, tc, ds.batch, workdir=str(tmp_path / "straight"), log_every=1,
                         device="cpu")
    w2 = str(tmp_path / "faulty")
    with pytest.raises(RuntimeError, match="injected failure"):
        run_training(CFG, tc, ds.batch, workdir=w2, log_every=1, device="cpu",
                     failure_injector=FailureInjector(fail_at_step=7))
    res_b = run_training(CFG, tc, ds.batch, workdir=w2, log_every=1, device="cpu")
    assert res_b.metrics_history[0]["step"] == 5  # resumed from the step-4 checkpoint
    la = {m["step"]: m["loss"] for m in res_a.metrics_history}
    lb = {m["step"]: m["loss"] for m in res_b.metrics_history}
    assert all(la[s] == lb[s] for s in lb)
    for (pa, ta), (pb, tb) in zip(_leaves(res_a.state), _leaves(res_b.state)):
        assert pa == pb and torch.equal(ta, tb), pa
    assert int(res_b.state["opt"]["step"]) == 12
    # the final checkpoints hold the same bits too
    from repro_torch.checkpoint import Checkpointer

    ca = Checkpointer(str(tmp_path / "straight" / "checkpoints")).restore(res_a.state)
    cb = Checkpointer(os.path.join(w2, "checkpoints")).restore(res_b.state)
    for (_, ta), (_, tb), (_, t) in zip(_leaves(ca), _leaves(cb), _leaves(res_a.state)):
        assert torch.equal(ta, tb) and torch.equal(ta, t)


def test_preemption_checkpoint_and_resume(tmp_path):
    ds = _ds()
    tc = TrainConfig(total_steps=12, warmup_steps=2, checkpoint_every=5, learning_rate=1e-3)
    pre = PreemptionHandler(signals=())
    calls = {"n": 0}

    def batch_fn(step, shard, n_shards):
        calls["n"] += 1
        if calls["n"] == 7:
            pre.request_stop()
        return ds.batch(step, shard, n_shards)

    res1 = run_training(CFG, tc, batch_fn, workdir=str(tmp_path), preemption=pre, log_every=1,
                        device="cpu")
    assert res1.stopped_early and res1.final_step == 7
    res2 = run_training(CFG, tc, ds.batch, workdir=str(tmp_path), log_every=1, device="cpu")
    assert not res2.stopped_early and res2.final_step == 12
    assert res2.metrics_history[0]["step"] == 8


def test_step_timer_flags_stragglers():
    t = {"now": 0.0}
    timer = StepTimer(window=16, threshold=2.0, clock=lambda: t["now"])
    for _ in range(10):
        timer.start()
        t["now"] += 1.0
        assert not timer.stop()[1]
    timer.start()
    t["now"] += 5.0
    assert timer.stop()[1]
    assert len(timer.straggler_events) == 1
    with pytest.raises(RuntimeError, match="start"):
        timer.stop()


def test_heartbeat_reader_never_sees_a_partial_file(tmp_path):
    path = str(tmp_path / "hb")
    hb = Heartbeat(path, interval=0.0).start()  # rewrites as fast as it can
    try:
        deadline = time.time() + 5.0
        while not os.path.exists(path) and time.time() < deadline:
            time.sleep(0.001)
        reads, stop = [0], threading.Event()

        def reader():
            while not stop.is_set():
                with open(path) as f:
                    text = f.read()
                assert text and float(text) > 0, repr(text)
                assert Heartbeat.is_alive(path, timeout=30.0)
                reads[0] += 1

        errors = []
        threads = [threading.Thread(target=lambda: _catch(reader, errors)) for _ in range(4)]
        for t in threads:
            t.start()
        time.sleep(0.5)
        stop.set()
        for t in threads:
            t.join(timeout=5.0)
            assert not t.is_alive()
        assert not errors, errors[0]
        assert reads[0] > 100
    finally:
        hb.stop()
    assert not os.path.exists(path)


def _catch(fn, errors):
    try:
        fn()
    except BaseException as e:  # noqa: BLE001 - reported by the test
        errors.append(e)


def test_synthetic_stream_equals_the_reference():
    ours = SyntheticLM(SyntheticLMConfig(vocab_size=97, seq_len=12, global_batch=6, seed=3))
    ref = JSyntheticLM(JSyntheticLMConfig(vocab_size=97, seq_len=12, global_batch=6, seed=3))
    for step in (0, 5, 123):
        for shard, n in ((0, 1), (1, 3)):
            np.testing.assert_array_equal(ours.batch(step, shard, n)["tokens"],
                                          ref.batch(step, shard, n)["tokens"])
    np.testing.assert_array_equal(make_batch_fn(97, 12, 6, 3)(7)["tokens"],
                                  ours.batch(7)["tokens"])
    with pytest.raises(ValueError, match="shards"):
        ours.batch(0, 0, 4)


def test_prefetch_loader_copies_each_batch():
    """A batch_fn that reuses one buffer (as a ring buffer would) must not
    change batches already handed over."""
    buf = np.zeros((2, 3), np.int32)

    def batch_fn(step, shard, n_shards):
        buf[:] = step
        return {"tokens": buf}

    loader = PrefetchLoader(batch_fn, device="cpu", prefetch=2)
    try:
        got = [next(loader) for _ in range(4)]
    finally:
        loader.close()
    assert [int(b["tokens"][0, 0]) for b in got] == [0, 1, 2, 3]
    assert loader.step == 4 and all(isinstance(b["tokens"], torch.Tensor) for b in got)
