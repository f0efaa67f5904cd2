"""Port parity of seeded sampling: ``repro_torch.serving.prng`` (threefry2x32
in torch) and ``generate.sample_row`` against ``jax.random`` and the
reference's ``_sample_row``.

Every key, counter and logit is drawn from a seeded numpy generator.
Tolerances:

* threefry outputs, ``fold_in`` key data, ``random_bits`` and ``uniform``:
  bit for bit;
* ``gumbel``: within 4 ulps of max(|g|, 1) — ``log`` on XLA's CPU backend
  and in torch may differ by an ulp, and the inner ``log(u)`` of u near 1
  is a small number whose ulp-sized absolute error is many ulps of the
  (small) result;
* ``sample_row`` tokens: equal, except where the top-1 minus top-2 gap of
  the reference's perturbed scores ``logits/T + gumbel`` is under 1e-5;
  margins within 1e-4 of the same quantity computed in numpy from the
  reference's noise.
"""
import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

jax = pytest.importorskip("jax")  # the parity side; absent where only the port runs
import jax.numpy as jnp  # noqa: E402
from jax.extend.random import threefry_2x32  # noqa: E402

from repro.serving import generate as jgen
from repro_torch.serving import generate as tgen
from repro_torch.serving import prng

SEEDS = (0, 1234, 2**31 - 1)
F32_TINY = np.finfo(np.float32).tiny


def _i64(a) -> np.ndarray:
    return np.asarray(a).astype(np.int64)


def test_threefry2x32_matches_reference():
    rng = np.random.default_rng(0)
    for _ in range(4):
        key = rng.integers(0, 2**32, 2, dtype=np.uint32)
        x = rng.integers(0, 2**32, (2, 257), dtype=np.uint32)
        ref = _i64(threefry_2x32(jnp.asarray(key), jnp.asarray(x.reshape(-1)))).reshape(2, -1)
        y0, y1 = prng.threefry2x32(*(torch.tensor(int(k)) for k in key),
                                   *(torch.from_numpy(_i64(r)) for r in x))
        np.testing.assert_array_equal(y0.numpy(), ref[0])
        np.testing.assert_array_equal(y1.numpy(), ref[1])


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_bits_and_uniforms_match_reference(seed):
    key, tkey = jax.random.PRNGKey(seed), prng.prng_key(seed)
    np.testing.assert_array_equal(tkey.numpy(), _i64(key))
    for sample_idx in (0, 1, 5):
        for pos in (0, 17, 300):
            jk = jax.random.fold_in(jax.random.fold_in(key, sample_idx), pos)
            tk = prng.fold_in(prng.fold_in(tkey, sample_idx), pos)
            np.testing.assert_array_equal(tk.numpy(), _i64(jk))
            np.testing.assert_array_equal(tgen.sampling_key(tgen.SamplingParams(1.0, 0, seed),
                                                            sample_idx, pos).numpy(), _i64(jk))
            for n in (999, 1000):
                np.testing.assert_array_equal(prng.random_bits(tk, n).numpy(),
                                              _i64(jax.random.bits(jk, (n,), jnp.uint32)))
            u = prng.uniform(tk, 1000, prng.F32_TINY, 1.0).numpy()
            ju = np.asarray(jax.random.uniform(jk, (1000,), minval=F32_TINY, maxval=1.0))
            np.testing.assert_array_equal(u.view(np.int32), ju.view(np.int32))
            np.testing.assert_array_equal(prng.uniform(tk, 64).numpy(),
                                          np.asarray(jax.random.uniform(jk, (64,))))


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_within_ulps_of_reference(seed):
    for sample_idx, pos in ((0, 0), (3, 41), (7, 511)):
        jk = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed), sample_idx), pos)
        tk = prng.fold_in(prng.fold_in(prng.prng_key(seed), sample_idx), pos)
        ref = np.asarray(jax.random.gumbel(jk, (4096,), mode="low"))
        got = prng.gumbel(tk, 4096).numpy()
        ulp = np.spacing(np.maximum(np.abs(ref), 1).astype(np.float32))
        assert (np.abs(got - ref) <= 4 * ulp).all()


def test_batched_keys_and_bits_equal_one_call_per_row():
    rng = np.random.default_rng(1)
    rows = np.stack([rng.integers(0, 2**31, 6), rng.integers(0, 4, 6), rng.integers(0, 900, 6)], 1)
    keys = tgen.sampling_keys(torch.from_numpy(rows))
    bits = prng.random_bits(keys, 333)
    for r, (seed, si, pos) in enumerate(rows):
        k = tgen.sampling_key(tgen.SamplingParams(1.0, 0, int(seed)), int(si), int(pos))
        assert torch.equal(keys[r], k)
        assert torch.equal(bits[r], prng.random_bits(k, 333))


@pytest.mark.parametrize("top_k", [0, 40])
def test_sample_row_matches_reference(top_k):
    rng = np.random.default_rng(2 + top_k)
    n, vocab = 24, 512
    logits = (rng.standard_normal((n, vocab)) * 3).astype(np.float32)
    temps = rng.choice(np.array([0.5, 0.8, 1.0, 1.7], np.float32), n)
    meta = np.stack([rng.integers(0, 2**31, n), rng.integers(0, 4, n), rng.integers(0, 600, n)], 1)
    tok, margin = tgen.sample_row(torch.from_numpy(logits), tgen.sampling_keys(torch.from_numpy(meta)),
                                  torch.from_numpy(temps), torch.full((n,), top_k))
    compared = 0
    for r in range(n):
        sp = jgen.SamplingParams(float(temps[r]), top_k, int(meta[r, 0]))
        key = jgen.sampling_key(sp, int(meta[r, 1]), int(meta[r, 2]))
        ref = int(jgen._sample_row(jnp.asarray(logits[r]), key, jnp.float32(temps[r]), top_k))
        x = np.asarray(jnp.asarray(logits[r]) / jnp.float32(temps[r]))
        g = np.asarray(jax.random.gumbel(key, (vocab,)))
        kth = np.sort(x)[-top_k] if top_k else -np.inf
        scores = np.sort(np.where(x < kth, -np.inf, x) + g)
        if scores[-1] - scores[-2] < 1e-5:
            continue
        compared += 1
        assert int(tok[r]) == ref
        want = scores[-1] - scores[-2]
        if top_k:
            assert ref in np.argsort(logits[r])[-top_k:]
            shut_out = (x < kth) & (x + g > scores[-1])
            want = min(want, x[ref] - kth, *(kth - x[shut_out]))
        assert abs(float(margin[r]) - temps[r] * want) < 1e-4
    assert compared >= n - 1


def test_top_k_keeps_ties_at_the_kth_value():
    logits = torch.tensor([[4.0, 3.0, 3.0, 3.0, 1.0, 0.0]])
    hits = set()
    for pos in range(200):
        tok, _ = tgen.sample_row(logits, tgen.sampling_keys(torch.tensor([[5, 0, pos]])),
                                 torch.tensor([1.0]), torch.tensor([2]))
        hits.add(int(tok[0]))
    assert hits == {0, 1, 2, 3}  # the three tied at the 2nd value survive, 4 and 5 never


def test_pick_token_passes_greedy_through():
    req = tgen.Request(rid=0, prompt=np.arange(3), max_new=1)
    assert tgen.pick_token(torch.zeros(8), 5, 0.25, req, 3) == (5, 0.25)
    hot = tgen.Request(rid=0, prompt=np.arange(3), max_new=1,
                       sampling=tgen.SamplingParams(temperature=1.0, seed=3))
    row = torch.from_numpy(np.random.default_rng(4).standard_normal(64).astype(np.float32))
    first = tgen.pick_token(row, 5, 0.25, hot, 10)
    assert first == tgen.pick_token(row, 5, 0.25, hot, 10)  # position-keyed, reproducible
    ref = int(jgen.sample_token(row.numpy(), jgen.SamplingParams(1.0, 0, 3), 0, 10))
    assert first[0] == ref


def test_categorical_matches_reference():
    rng = np.random.default_rng(6)
    logits = (rng.standard_normal((8, 300)) * 2).astype(np.float32)
    keys = [jax.random.fold_in(jax.random.PRNGKey(int(s)), 3) for s in rng.integers(0, 2**31, 8)]
    tkeys = torch.from_numpy(np.stack([_i64(k) for k in keys]))
    tok, noise = prng.categorical(tkeys, torch.from_numpy(logits))
    ref = [int(jax.random.categorical(k, jnp.asarray(row))) for k, row in zip(keys, logits)]
    assert tok.tolist() == ref
    assert torch.equal(noise, prng.gumbel(tkeys, logits.shape[-1]))
