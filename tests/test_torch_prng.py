"""The port's threefry draws (tube_mpc_tpu_torch/utils/prng.py) against jax.random's, on the
CPU, every check bitwise:

- the hash, jax._src.prng.threefry_2x32, on seeded random keys and counts (odd and even
  sizes, a batch of keys against jax.vmap);
- PRNGKey of small, large (>= 2**32) and negative seeds, under jax_enable_x64 as the tests
  run it;
- split into 1, 2, 3 and 1000 keys, and of a batch of keys;
- uniform in f32 and f64 at four shapes, with bounds, and over a batch of keys against
  jax.vmap. The bounds' widths are exact in binary (1 and 4): jax.random.uniform is one
  jitted function, and XLA's CPU compiler fuses its u * (maxval - minval) + minval into one
  fused multiply-add, which rounds once where the port (and the expression) rounds twice;
  the two agree where the product is exact, as for the package's draws on [0, 1);
- System.sample_disturbance of every family's system against the JAX package's, from one
  key and from a batch of keys, in f32 and f64;
- bench.py's Dubins draw at full size, sample_disturbance(PRNGKey(0), (16384, 300)) in f32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import prng as jax_prng

from tube_mpc_tpu.presets import dubins_paper_setup as j_dubins_paper_setup

from tube_mpc_tpu_torch.presets import dubins_paper_setup
from tube_mpc_tpu_torch.utils import prng

from torch_xla_cases import built_pair, raw_of

FAMILIES = ("dubins", "double_integrator", "quadrotor2d", "cartpole")
DTYPES = {"f32": (jnp.float32, torch.float32), "f64": (jnp.float64, torch.float64)}


def words(a):
    """A JAX uint32 array as the port's int64 words."""
    return torch.as_tensor(np.asarray(a).astype(np.int64))


def same_bits(port, ref):
    """Bitwise equality of a port tensor and a JAX array of one shape and dtype."""
    a, b = np.atleast_1d(port.numpy()), np.atleast_1d(np.asarray(ref))
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
    view = {4: np.uint32, 8: np.uint64}[a.dtype.itemsize]
    mismatch = np.flatnonzero(a.view(view) != b.view(view))
    assert mismatch.size == 0, f"{mismatch.size} of {a.size} differ, first at {mismatch[:5]}"


@pytest.mark.parametrize("size", [1, 2, 7, 64, 1001])
def test_threefry_2x32_matches_jax(size):
    rng = np.random.default_rng(size)
    key = rng.integers(0, 2 ** 32, (2,), dtype=np.uint32)
    count = rng.integers(0, 2 ** 32, (size,), dtype=np.uint32)
    ref = jax_prng.threefry_2x32(jnp.asarray(key), jnp.asarray(count))
    got = prng.threefry_2x32(words(key), words(count))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref).astype(np.int64))


def test_threefry_2x32_over_a_batch_of_keys_matches_vmap():
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 2 ** 32, (4, 2), dtype=np.uint32)
    count = rng.integers(0, 2 ** 32, (3, 5), dtype=np.uint32)
    ref = jax.vmap(jax_prng.threefry_2x32, in_axes=(0, None))(jnp.asarray(keys),
                                                              jnp.asarray(count))
    got = prng.threefry_2x32(words(keys), words(count))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref).astype(np.int64))


@pytest.mark.parametrize("seed", [0, 1, 42, 2 ** 31 - 1, 2 ** 32 + 5, -1])
def test_prng_key_matches_jax(seed):
    got = prng.PRNGKey(seed)
    assert got.dtype == torch.int64 and tuple(got.shape) == (2,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax.random.PRNGKey(seed)).astype(np.int64))


@pytest.mark.parametrize("num", [1, 2, 3, 1000])
def test_split_matches_jax(num):
    ref = jax.random.split(jax.random.PRNGKey(42), num)
    got = prng.split(prng.PRNGKey(42), num)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref).astype(np.int64))


def test_split_of_a_batch_of_keys_matches_vmap():
    keys = jax.random.split(jax.random.PRNGKey(3), 4)
    ref = jax.vmap(lambda k: jax.random.split(k, 3))(keys)
    got = prng.split(words(keys), 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref).astype(np.int64))


@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("shape", [(), (7,), (3, 5, 2), (64, 300, 6)], ids=str)
def test_uniform_matches_jax(dname, shape):
    jdt, tdt = DTYPES[dname]
    key = jax.random.PRNGKey(11)
    same_bits(prng.uniform(prng.PRNGKey(11), shape, tdt),
              jax.random.uniform(key, shape, dtype=jdt))
    # bounds: the affine map and the final max, each rounded on its own
    same_bits(prng.uniform(prng.PRNGKey(11), shape, tdt, -0.3, 0.7),
              jax.random.uniform(key, shape, dtype=jdt, minval=-0.3, maxval=0.7))


@pytest.mark.parametrize("dname", list(DTYPES))
def test_uniform_over_a_batch_of_keys_matches_vmap(dname):
    jdt, tdt = DTYPES[dname]
    keys = jax.random.split(jax.random.PRNGKey(9), 6)
    ref = jax.vmap(lambda k: jax.random.uniform(k, (5, 3), dtype=jdt, minval=-2.0,
                                                maxval=2.0))(keys)
    same_bits(prng.uniform(words(keys), (5, 3), tdt, -2.0, 2.0), ref)
    # the keys of a split, made by the port
    same_bits(prng.uniform(prng.split(prng.PRNGKey(9), 6), (5, 3), tdt, -2.0, 2.0), ref)


def test_uniform_refuses_other_dtypes():
    with pytest.raises(TypeError, match="float32 or float64"):
        prng.uniform(prng.PRNGKey(0), (3,), torch.float16)


@pytest.fixture(scope="module", params=FAMILIES)
def systems(request):
    """(the JAX package's system, the port's) of configs/<family>.yaml."""
    jb, pb = built_pair(raw_of(request.param, 6, 3))
    return request.param, jb.system, pb.system


@pytest.mark.parametrize("dname", list(DTYPES))
def test_sample_disturbance_matches_jax(systems, dname):
    family, jsys, psys = systems
    jdt, tdt = DTYPES[dname]
    same_bits(psys.sample_disturbance(prng.PRNGKey(7), (5, 9), dtype=tdt),
              jsys.sample_disturbance(jax.random.PRNGKey(7), (5, 9), dtype=jdt))
    keys = jax.random.split(jax.random.PRNGKey(7), 5)
    ref = jax.vmap(lambda k: jsys.sample_disturbance(k, (9,), dtype=jdt))(keys)
    same_bits(psys.sample_disturbance(prng.split(prng.PRNGKey(7), 5), (9,), dtype=tdt), ref)


def test_bench_draw_matches_jax_at_full_size():
    """bench.py:267's draw on its default setup, the Dubins paper setup in f32:
    sample_disturbance(PRNGKey(0), (16384, 300)) (~3 s)."""
    jsys = j_dubins_paper_setup(N=4, H=2).system
    psys = dubins_paper_setup(N=4, H=2, device="cpu", dtype=torch.float32).system
    ref = jsys.sample_disturbance(jax.random.PRNGKey(0), (16384, 300), dtype=jnp.float32)
    same_bits(psys.sample_disturbance(prng.PRNGKey(0), (16384, 300), dtype=torch.float32), ref)
