"""The port's token sampling (``repro_torch.serve.sampling``) against the JAX
package's (``repro.serve.sampling``).

- The top-k and top-p masks are exactly equal to the reference's on the
  same numpy logits, in float32 and bfloat16, with ties.
- Greedy rows (temperature <= 0) take the argmax, beside sampled rows in
  the same call.
- The port's draws are its own (Gumbel-max over a counter-based hash of
  (seed, position, vocab index)), so seeded streams are held to the
  reference's invariances, not its tokens: a seeded row's token depends
  only on (seed, position), never on the batch, the row, the engine's
  generator or the replica; unseeded rows follow the engine's generator.
- Two tests of ``tests/test_sampling_spec.py``, ported: the tie-inclusive,
  dtype-aware top-k mask and the scalar path's top-k ties.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import numpy_tree  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import sampling as jsampling  # noqa: E402
from repro_torch.configs import ServeConfig, get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.serve import sampling  # noqa: E402
from repro_torch.serve.api import Engine  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are tiny: one intra-op thread is as fast, and leaves
    the cores to the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tied_logits(seed, rows=6, vocab=40):
    """Logits on a coarse grid, so that many values tie (also across the
    k-th largest)."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-8, 8, (rows, vocab)) * 0.5).astype(np.float32)


def _both(x, dtype):
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("seed", [0, 1])
def test_top_k_mask_matches_reference(dtype, seed):
    x = _tied_logits(seed)
    top_k = np.array([0, 1, 3, 7, 40, 55], np.int32)
    jx, tx = _both(x, dtype)
    ref = jsampling._mask_top_k(jx, jnp.asarray(top_k))
    ours = sampling._mask_top_k(tx, torch.from_numpy(top_k))
    assert ours.dtype == tx.dtype
    np.testing.assert_array_equal(ours.float().numpy(), np.asarray(ref, np.float32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("seed", [0, 1])
def test_top_p_mask_matches_reference(dtype, seed):
    x = _tied_logits(seed)
    top_p = np.array([1.0, 0.05, 0.3, 0.62, 0.9, 0.999], np.float32)
    jx, tx = _both(x, dtype)
    ref = jsampling._mask_top_p(jx, jnp.asarray(top_p))
    ours = sampling._mask_top_p(tx, torch.from_numpy(top_p))
    assert ours.dtype == tx.dtype
    np.testing.assert_array_equal(ours.float().numpy(), np.asarray(ref, np.float32))


def _knobs(temps, top_k=None, top_p=None, seeds=None, positions=None):
    b = len(temps)
    return dict(
        temperature=torch.tensor(temps, dtype=torch.float32),
        top_k=torch.tensor(top_k if top_k is not None else [0] * b, dtype=torch.int32),
        top_p=torch.tensor(top_p if top_p is not None else [1.0] * b, dtype=torch.float32),
        seed=torch.tensor(seeds if seeds is not None else [-1] * b, dtype=torch.int32),
        positions=torch.tensor(positions if positions is not None else [0] * b,
                               dtype=torch.int32),
    )


def test_greedy_rows_take_the_argmax_beside_sampled_rows():
    logits = torch.from_numpy(np.random.default_rng(3).normal(size=(5, 64)).astype(np.float32))
    drawn = sampling.draw_keys(torch.Generator().manual_seed(0), 5, "cpu")
    temps = [0.0, 1.3, 0.0, -1.0, 0.8]
    out = sampling.sample_tokens(logits, drawn, **_knobs(temps, seeds=[-1, 4, 5, -1, -1]))
    assert out.dtype == torch.int32
    greedy = logits.argmax(-1).to(torch.int32)
    for i, t in enumerate(temps):
        if t <= 0:
            assert out[i] == greedy[i]
    # the whole batch greedy: exactly the argmax
    out = sampling.sample_tokens(logits, drawn, **_knobs([0.0] * 5, top_k=[3] * 5))
    assert torch.equal(out, greedy)


def test_seeded_row_depends_only_on_seed_and_position():
    """The same (seed, position) draws the same token whatever the other
    rows, the row index and the engine's generator (the replica)."""
    rng = np.random.default_rng(5)
    row = rng.normal(size=(1, 96)).astype(np.float32)
    knob = dict(temp=0.9, top_k=20, top_p=0.95)
    for seed, pos in [(7, 0), (7, 1), (123456, 40), (0, 2047)]:
        tokens = set()
        for trial, (b, r) in enumerate([(1, 0), (4, 0), (4, 3), (7, 5)]):
            logits = rng.normal(size=(b, 96)).astype(np.float32)
            logits[r] = row[0]
            seeds = [int(s) for s in rng.integers(0, 100, b)]
            seeds[r] = seed
            positions = [int(p) for p in rng.integers(0, 500, b)]
            positions[r] = pos
            drawn = sampling.draw_keys(torch.Generator().manual_seed(trial), b, "cpu")
            out = sampling.sample_tokens(
                torch.from_numpy(logits), drawn,
                **_knobs([knob["temp"]] * b, top_k=[knob["top_k"]] * b,
                         top_p=[knob["top_p"]] * b, seeds=seeds, positions=positions))
            tokens.add(int(out[r]))
        assert len(tokens) == 1, (seed, pos, tokens)


def test_seeded_draws_follow_the_softmax():
    """Gumbel-max over the hash: token frequencies over 4000 positions of
    one seed match softmax(logits / T) within 0.03."""
    logits = torch.tensor([[0.0, 1.0, 2.0, 0.5, -1.0]])
    n, temp = 4000, 1.5
    out = sampling.sample_tokens(
        logits.expand(n, -1).contiguous(), torch.zeros(n, dtype=torch.int64),
        **_knobs([temp] * n, seeds=[11] * n, positions=list(range(n))))
    freq = np.bincount(out.numpy(), minlength=5) / n
    np.testing.assert_allclose(freq, torch.softmax(logits[0] / temp, -1).numpy(), atol=0.03)


def test_unseeded_rows_follow_the_generator():
    logits = torch.zeros(64, 50)
    knobs = _knobs([1.0] * 64)
    a = sampling.sample_tokens(logits, sampling.draw_keys(torch.Generator().manual_seed(1), 64,
                                                          "cpu"), **knobs)
    b = sampling.sample_tokens(logits, sampling.draw_keys(torch.Generator().manual_seed(1), 64,
                                                          "cpu"), **knobs)
    c = sampling.sample_tokens(logits, sampling.draw_keys(torch.Generator().manual_seed(2), 64,
                                                          "cpu"), **knobs)
    assert torch.equal(a, b) and not torch.equal(a, c)


# ------------------------------------------ ported from test_sampling_spec --


def test_top_k_mask_is_tie_inclusive_and_dtype_aware():
    """Values tied with the k-th largest all survive, and masked slots
    carry the dtype minimum (a hardcoded -1e30 would overflow to -inf
    under float16 and corrupt the masked softmax)."""
    scaled = torch.tensor([[1.0, 3.0, 3.0, 2.0, 0.0]], dtype=torch.float16)
    out = sampling._mask_top_k(scaled, torch.tensor([2]))
    lo = torch.finfo(torch.float16).min
    assert torch.equal(out[0], torch.tensor([lo, 3.0, 3.0, lo, lo], dtype=torch.float16))
    assert torch.isfinite(out).any() and not torch.isinf(out).any()
    # top_k <= 0 disables the mask entirely
    assert torch.equal(sampling._mask_top_k(scaled, torch.tensor([0])), scaled)


def test_scalar_sample_top_k_ties_and_finfo_min():
    """The scalar path: top_k=1 with a tied maximum keeps *both* argmaxes
    in support, everything else never appears, and float16 logits don't
    produce inf/nan."""
    logits = torch.tensor([[0.0, 5.0, 5.0, 1.0]], dtype=torch.float16)
    seen = set()
    for i in range(64):
        tok = sampling.sample(logits, torch.Generator().manual_seed(i), temperature=1.0, top_k=1)
        seen.add(int(tok[0]))
    assert seen <= {1, 2}
    assert 1 in seen and 2 in seen  # ties genuinely reachable


# ------------------------------------------------------- through the engine --


@pytest.fixture(scope="module")
def lm_setup():
    jcfg = jax_get_config("granite-8b", reduced=True)
    cfg = get_config("granite-8b", reduced=True)
    return cfg, params_from_numpy(numpy_tree(jlm.param_spec(jcfg), 0), "cpu")


def _stream(cfg, params, prompts, sp, **engine_kw):
    sc = ServeConfig(max_batch=3, max_seq_len=64, prefill_buckets=(8, 16), decode_steps=3)
    eng = Engine(cfg, params, sc, device="cpu", **engine_kw)
    handles = [eng.submit(p, s) for p, s in zip(prompts, sp)]
    res = eng.generate()
    return [res[h.uid].generated for h in handles]


def test_seeded_request_stream_is_schedule_and_replica_independent(lm_setup):
    """A seeded sampled request emits the same stream alone, inside a mixed
    greedy/sampled batch, and on another replica with another engine seed;
    unseeded sampled streams differ between replicas."""
    cfg, params = lm_setup
    seeded = sampling.SamplingParams(max_new_tokens=6, temperature=0.9, top_k=12, top_p=0.95,
                                     seed=7)
    prompt = [2, 4, 6, 8, 1]
    alone = _stream(cfg, params, [prompt], [seeded])[0]
    others = [[5, 9, 3], list(range(1, 12)), [7] * 9]
    mixed = _stream(cfg, params, others + [prompt],
                    [sampling.SamplingParams(max_new_tokens=5, temperature=0.0),
                     sampling.SamplingParams(max_new_tokens=4, temperature=1.2),
                     sampling.SamplingParams(max_new_tokens=7, temperature=0.5, seed=3),
                     seeded])[-1]
    replica = _stream(cfg, params, [prompt], [seeded], seed=5, replica=1)[0]
    assert alone == mixed == replica and len(alone) == 6
    unseeded = sampling.SamplingParams(max_new_tokens=8, temperature=1.0)
    r0 = _stream(cfg, params, [prompt], [unseeded], replica=0)[0]
    r1 = _stream(cfg, params, [prompt], [unseeded], replica=1)[0]
    assert r0 != r1
