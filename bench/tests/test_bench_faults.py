"""A run whose timed path is broken underneath comes out not correct.

These drive the rest of a run on the CPU at a small size (the look for a
card skipped), once sound and once with each fault the cells can have: an
answer altered where the program produces it (the encoder's logits of one
event; one served token).  The other faults of the contract (a step that
returns its state unchanged, half of the batch left out of a mean, the
exchange between chips left out) belong to training and multi-chip cells,
which this benchmark has none of."""

import json
import time

import pytest
import torch

from bench import harness

ROOT = harness.ROOT


def _gw_run(policy: str, reference: str | None = None) -> harness.Run:
    conf = json.load(open(ROOT / "bench" / "configs" / f"gw.{policy}.json"))
    conf["reference"] = reference or conf["reference"]
    mix = json.load(open(ROOT / "bench" / "traffic" / "reprocess-8192.json"))
    mix.update(batch=32, pool_batches=2)
    r = harness.Run(workload="w", cell={"chips": 1}, config=conf, traffic=mix, seed=2**31 + 21,
                    seconds=3.0, trace=False, device=torch.device("cpu"),
                    t_process=time.perf_counter())
    harness.driver(mix).run(r)
    return r


def _serve_run(policy: str, monkeypatch=None, fault=None,
               reference: str | None = None) -> harness.Run:
    conf = json.load(open(ROOT / "bench" / "configs" / f"granite-8b.{policy}.json"))
    conf["reference"] = reference or conf["reference"]
    # head_dim and d_model large enough that the logits spread as the real
    # model's do (their scale grows with the embedding width)
    conf["model_config"].update(n_layers=2, d_model=512, n_heads=4, n_kv_heads=2, head_dim=128,
                                d_ff=1024, vocab_size=256, dtype="float32")
    conf["serve"].update(max_batch=4, max_seq_len=64, kv_page_size=8)
    conf["check"]["requests"] = 4
    mix = json.load(open(ROOT / "bench" / "traffic" / "code-completion.json"))
    mix.update(clients=6, prompt_tokens=[20, 50], output_tokens=[2, 8],
               warmup_prompt_tokens=[20, 40])
    if fault is not None:
        from repro_torch.serve import executor

        original = executor.sample_tokens

        def altered(logits, *a, **kw):
            return fault(original(logits, *a, **kw), logits)

        monkeypatch.setattr(executor, "sample_tokens", altered)
    r = harness.Run(workload="w", cell={"chips": 1}, config=conf, traffic=mix, seed=2**31 + 22,
                    seconds=5.0, trace=False, device=torch.device("cpu"),
                    t_process=time.perf_counter())
    harness.driver(mix).run(r)
    return r


@pytest.mark.parametrize("policy", ["paper_vu13p", "float"])
def test_a_sound_encoder_run_is_correct(policy):
    r = _gw_run(policy)
    assert r.correct, r.checks
    assert r.metrics["events_per_s"] > 0


@pytest.mark.parametrize("policy", ["paper_vu13p", "float"])
def test_an_altered_answer_is_not_correct(policy, monkeypatch):
    from repro_torch.models import physics

    original = physics.forward

    def forward(*a, **kw):
        return original(*a, **kw) + 0.05  # the answers, where they are produced

    monkeypatch.setattr(physics, "forward", forward)
    r = _gw_run(policy)
    assert not r.correct, r.checks


@pytest.mark.parametrize("policy", ["int8_serve", "bf16"])
def test_a_sound_serving_run_is_correct(policy):
    r = _serve_run(policy)
    assert r.correct, r.checks
    assert r.metrics["output_tokens_per_s"] > 0 and r.failed == 0


@pytest.mark.parametrize("policy", ["int8_serve", "bf16"])
def test_an_altered_token_is_not_correct(policy, monkeypatch):
    def fault(tok, logits):
        # every 5th row's token replaced by its least likely one
        out = tok.clone()
        out[::5] = logits[::5].argmin(-1).to(out.dtype)
        return out

    r = _serve_run(policy, monkeypatch, fault)
    assert not r.correct, r.checks
