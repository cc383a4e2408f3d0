"""lidp_tpu_torch.threefry against jax.random (threefry2x32, the
partitionable layout, x64 on as the JAX package's tests run it):

  * prng_key of seeds 1, 904297, 2^31 + 12345 (as uint32 and as int) and
    2^33 + 7 (as int: a high word): the key's two words equal;
  * fold_in of steps 0-3 and 10^6, and split into 3: every key equal;
  * bits (uint32 and uint64) and uniform (float32 and float64) of shapes
    (7, 3), (8, 3) and (): equal bit for bit;
  * normal: within 1e-12 relative in float64 and 1e-5 in float32 (torch's
    erfinv against XLA's erf_inv), the uniform it maps equal bit for bit.

The draws of the last case also run through the CPU path that fix
langevin and temp/csld take (device "cpu"); on the card the same integer
arithmetic gives the same bits (chip_smoke.py path W holds them).

  * gamma (fix temp/csvr's draw, threefry.gamma_draw on the host) and the
    scalar normal inside it: equal to jax.random.gamma's and
    jax.random.normal's eager draws bit for bit, float32 and float64, for
    alpha below 1 (the boost), at 1 and near it, and at ~1.6e4 (a 32,000
    atom thermostat's (dof - 1)/2), every seed and step above.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
# one torch thread, for time, as the port's other parity files: under
# pytest-xdist torch's threads spin on the cores the other workers use
torch.set_num_threads(1)
import jax.numpy as jnp  # noqa: E402

from lidp_tpu_torch import threefry  # noqa: E402

SEEDS = [(1, True), (1, False), (904297, True), (904297, False),
         (2 ** 31 + 12345, True), (2 ** 31 + 12345, False),
         (2 ** 33 + 7, False)]
STEPS = (0, 1, 2, 3, 10 ** 6)
SHAPES = ((7, 3), (8, 3), ())
DTYPES = ((jnp.float32, torch.float32), (jnp.float64, torch.float64))
NORMAL_REL = {torch.float32: 1e-5, torch.float64: 1e-12}


def _words(key):
    return tuple(int(w) for w in np.asarray(key))


def _jax_key(seed, as_uint32):
    return jax.random.PRNGKey(jnp.asarray(seed, jnp.uint32) if as_uint32
                              else seed)


def _same_bits(a, b):
    a, b = np.asarray(a).reshape(-1), np.asarray(b).reshape(-1)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("seed,as_uint32", SEEDS)
def test_keys_match_jax(seed, as_uint32):
    key = _jax_key(seed, as_uint32)
    tkey = threefry.prng_key(seed)
    assert _words(key) == tkey
    assert tkey[0] == (seed >> 32)
    for step in STEPS:
        kf = jax.random.fold_in(key, step)
        tkf = threefry.fold_in(tkey, step)
        assert _words(kf) == tkf
        assert [_words(k) for k in jax.random.split(kf, 3)] \
            == threefry.split(tkf, 3)


@pytest.mark.parametrize("seed,as_uint32", SEEDS)
def test_bits_and_uniforms_match_jax_bit_for_bit(seed, as_uint32):
    key = _jax_key(seed, as_uint32)
    tkey = threefry.prng_key(seed)
    for step in STEPS:
        kf, tkf = jax.random.fold_in(key, step), threefry.fold_in(tkey, step)
        for shape in SHAPES:
            b32 = np.asarray(jax.random.bits(kf, shape, jnp.uint32))
            np.testing.assert_array_equal(
                threefry.random_bits(tkf, 32, shape).numpy(),
                b32.astype(np.int64))
            b64 = np.asarray(jax.random.bits(kf, shape, jnp.uint64))
            np.testing.assert_array_equal(
                threefry.random_bits(tkf, 64, shape).numpy(),
                b64.view(np.int64))
            for jd, td in DTYPES:
                got = threefry.uniform(tkf, shape, td, "cpu")
                assert tuple(got.shape) == shape and got.dtype == td
                _same_bits(got.numpy(), jax.random.uniform(kf, shape, jd))


@pytest.mark.parametrize("seed,as_uint32", SEEDS)
def test_normal_matches_jax(seed, as_uint32):
    key = _jax_key(seed, as_uint32)
    tkey = threefry.prng_key(seed)
    for step in STEPS:
        kf, tkf = jax.random.fold_in(key, step), threefry.fold_in(tkey, step)
        for shape in SHAPES:
            for jd, td in DTYPES:
                # the uniform on (nextafter(-1, 0), 1) that normal maps
                lo = np.nextafter(np.array(-1.0, jd), np.array(0.0, jd))
                _same_bits(
                    threefry.uniform(tkf, shape, td, "cpu",
                                     minval=float(lo)).numpy(),
                    jax.random.uniform(kf, shape, jd, lo, 1.0))
                got = threefry.normal(tkf, shape, td, "cpu").numpy()
                want = np.asarray(jax.random.normal(kf, shape, jd))
                assert got.dtype == want.dtype and got.shape == want.shape
                np.testing.assert_allclose(got, want, rtol=NORMAL_REL[td],
                                           atol=0)


def test_a_draw_of_many_atoms_matches_jax():
    """fix langevin's draw at in.chain's seed on 1,001 atoms, at the step
    of a long run: the counter's high word stays 0, every element of the
    (n, 3) draw comes from its own counter."""
    key = jax.random.fold_in(jax.random.PRNGKey(jnp.asarray(904297,
                                                            jnp.uint32)),
                             123456)
    tkey = threefry.fold_in(threefry.prng_key(904297), 123456)
    for jd, td in DTYPES:
        got = threefry.uniform(tkey, (1001, 3), td, "cpu")
        _same_bits(got.numpy(), jax.random.uniform(key, (1001, 3), jd))
        if td == torch.float64:
            assert len(np.unique(got.numpy())) == got.numel()


GAMMA_ALPHAS = (0.3, 0.97, 1.0, 1.03, 2.5, 16000.5)


@pytest.mark.parametrize("jdt, tdt", DTYPES)
@pytest.mark.parametrize("alpha", GAMMA_ALPHAS)
def test_gamma_matches_jax_bit_for_bit(alpha, jdt, tdt):
    tries = 0
    for seed, as_uint32 in SEEDS:
        jkey = jax.random.PRNGKey(np.uint32(seed) if as_uint32 else seed)
        key = threefry.prng_key(seed)
        for step in STEPS:
            jk = jax.random.fold_in(jkey, step)
            k = threefry.fold_in(key, step)
            want = np.asarray(jax.random.gamma(jk, alpha, dtype=jdt))
            got, n = threefry.gamma_draw(k, alpha, tdt)
            tries += n
            assert got.dtype == want.dtype
            assert got.tobytes() == want.tobytes(), (seed, step, got, want)
            t = threefry.gamma(k, alpha, tdt, "cpu")
            assert t.numpy().tobytes() == want.tobytes()
            want = np.asarray(jax.random.normal(jk, (), dtype=jdt))
            assert threefry.normal_scalar(k, tdt).tobytes() \
                == want.tobytes()
    # the rejection loop ran: at least one try a draw
    assert tries >= len(SEEDS) * len(STEPS)
