"""Port parity: LO-BCQ numerics of ``repro_torch`` against the JAX package.

Tolerance: none — E4M3 codes, packed index/selector/scale bytes and
decoded values are compared for equality.  The one allowed difference is
the contract of tests/test_kernels.py:3-6: where a block ties between two
codebooks the selector bytes may differ, and then the decoded values must
still be equal.  Inputs are made with numpy from fixed seeds.
"""
import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")  # the parity side; absent where only the port runs

from repro.core import bcq as jbcq
from repro.core import formats as jfmt
from repro.core.calibrate import default_universal_codebooks
from repro.kernels import common as jcommon
from repro_torch.core import bcq as tbcq
from repro_torch.core import formats as tfmt
from repro_torch.core.calibrate import default_universal_codebooks as t_universal
from repro_torch.kernels import common as tcommon
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

CFGS = [  # the sweep of tests/test_kernels.py:19-24
    (8, 64, 8),
    (8, 128, 16),
    (4, 32, 4),
    (2, 16, 2),
]


def _cfgs(lb, la, nc):
    return (
        jbcq.BCQConfig(block_len=lb, array_len=la, n_codebooks=nc),
        tbcq.BCQConfig(block_len=lb, array_len=la, n_codebooks=nc),
    )


def _codebooks(jcfg):
    if jcfg == jbcq.BCQConfig():
        return default_universal_codebooks(jcfg).levels
    data = np.random.default_rng(0).laplace(size=60000).astype(np.float32)
    return np.asarray(jbcq.fit_lobcq(jnp.asarray(data), jcfg, iters=4, max_blocks=4096).levels)


def _inputs(kind, shape, seed=7):
    rng = np.random.default_rng(seed)
    if kind == "normal":
        x = rng.standard_normal(shape)
    elif kind == "heavy":
        x = rng.standard_t(3.0, shape)
    else:  # outlier
        x = rng.standard_normal(shape)
        x = np.where(rng.random(shape) < 0.005, x * 40.0, x)
    return x.astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------------ E4M3
def _e4m3_probe_values():
    """Every E4M3 code's value and its float neighbours, the midpoints
    between codes, and tiny / huge / subnormal-flush inputs."""
    grid = np.asarray(jfmt.E4M3.levels(), np.float32)
    mids = ((grid[1:] + grid[:-1]) / 2).astype(np.float32)
    up = np.nextafter(grid, np.float32(np.inf))
    down = np.nextafter(grid, np.float32(0))
    extra = np.float32([1e-45, 1e-39, 1e-38, 1.2e-38, 2.0**-10, 2.0**-9.5, 447.9, 448.0,
                        449.0, 464.0, 480.0, 1e6, 3e38])
    return np.concatenate([grid, mids, up, down, extra, -extra]).astype(np.float32)


def test_e4m3_quantize_matches_reference():
    x = _e4m3_probe_values()
    np.testing.assert_array_equal(
        tfmt.E4M3.quantize(_t(x)).numpy(), np.asarray(jfmt.E4M3.quantize(jnp.asarray(x)))
    )


def test_e4m3_snap_matches_reference():
    x = np.abs(_e4m3_probe_values())
    np.testing.assert_array_equal(
        tcommon.e4m3_snap(_t(x)).numpy(), np.asarray(jcommon.e4m3_snap(jnp.asarray(x)))
    )


def test_e4m3_bit_codecs_match_reference():
    grid = np.asarray(jfmt.E4M3.levels(), np.float32)
    grid = grid[grid > 0]
    np.testing.assert_array_equal(
        tfmt.e4m3_to_bits(_t(grid)).numpy(), np.asarray(jfmt.e4m3_to_bits(jnp.asarray(grid)))
    )
    codes = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(
        tfmt.bits_to_e4m3(_t(codes)).numpy(), np.asarray(jfmt.bits_to_e4m3(jnp.asarray(codes)))
    )


def test_pow2_is_exact():
    e = torch.arange(-126, 128, dtype=torch.float32)
    np.testing.assert_array_equal(tfmt.pow2(e).numpy(), np.ldexp(np.float32(1), np.arange(-126, 128)))


# ------------------------------------------------------------------ packing
def test_nibble_packing_matches_reference():
    x = np.random.default_rng(1).integers(0, 16, (5, 3, 32)).astype(np.uint8)
    packed = tbcq.pack_nibbles(_t(x))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jbcq.pack_nibbles(jnp.asarray(x))))
    np.testing.assert_array_equal(tbcq.unpack_nibbles(packed).numpy(), x)
    x2 = x.reshape(15, 32)
    np.testing.assert_array_equal(
        tcommon.pack_u4(_t(x2)).numpy(), np.asarray(jcommon.pack_u4(jnp.asarray(x2)))
    )
    np.testing.assert_array_equal(tcommon.unpack_u4(tcommon.pack_u4(_t(x2))).numpy(), x2)


def test_nearest_level_idx_ties_round_up():
    levels = np.float32([-3, -1, 0, 2, 5])
    y = np.float32([-2.0, -0.5, 1.0, 3.5, -9, 9, 0.0, 2.0, 1.0000001, 0.9999999])
    np.testing.assert_array_equal(
        tbcq.nearest_level_idx(_t(y), _t(levels)).numpy(),
        np.asarray(jbcq.nearest_level_idx(jnp.asarray(y), jnp.asarray(levels))),
    )


# ------------------------------------------------------------------ encode
@pytest.mark.parametrize("cfg_t", CFGS, ids=lambda c: f"Lb{c[0]}_LA{c[1]}_Nc{c[2]}")
@pytest.mark.parametrize("kind", ["normal", "heavy", "outlier"])
def test_encode_bytes_match_reference(cfg_t, kind):
    jcfg, tcfg = _cfgs(*cfg_t)
    cb = _codebooks(jcfg)
    x = _inputs(kind, (64, 512))
    ej = jbcq.encode(jnp.asarray(x), jnp.asarray(cb), jcfg)
    et = tbcq.encode(_t(x), _t(cb), tcfg)
    np.testing.assert_array_equal(et.scale_code.numpy(), np.asarray(ej.scale_code))
    np.testing.assert_array_equal(et.s_x.numpy(), np.asarray(ej.s_x))
    dj = np.asarray(jbcq.decode(ej, jnp.asarray(cb), jcfg, x.shape[-1]))
    dt = tbcq.decode(et, _t(cb), tcfg, x.shape[-1]).numpy()
    # decoded values are equal even where a codebook tie flips bytes
    np.testing.assert_array_equal(dt, dj)
    same_sel = np.array_equal(et.packed_sel.numpy(), np.asarray(ej.packed_sel))
    if same_sel:
        np.testing.assert_array_equal(et.packed_idx.numpy(), np.asarray(ej.packed_idx))
    fq = tbcq.fake_quant(_t(x), _t(cb), tcfg).numpy()
    np.testing.assert_array_equal(fq, np.asarray(jbcq.fake_quant(jnp.asarray(x), jnp.asarray(cb), jcfg)))


@pytest.mark.parametrize("kind", ["normal", "heavy", "outlier"])
def test_encode_tile_matches_reference(kind):
    """The plain version of the CUDA encode (threshold compares, running
    argmin) equals the reference's kernel encode, with a caller s_x."""
    jcfg, tcfg = _cfgs(8, 64, 8)
    cb = _codebooks(jcfg)
    x = _inputs(kind, (16, 256), seed=3)
    s_x = np.float32(31.0 / np.abs(x).max() * 0.7)
    ij, sj, rj = jcommon.encode_tile(jnp.asarray(x), jnp.asarray(cb), jnp.float32(s_x), jcfg, 256)
    it, st, rt = tcommon.encode_tile(_t(x), _t(cb), torch.tensor(s_x), tcfg)
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    # and the tile encode agrees with the searchsorted encode path
    sel, idx = tbcq._select_and_index(
        (_t(x).reshape(16, 4, 64) * (rt * torch.tensor(s_x))[..., None]).reshape(16, 32, 8), _t(cb)
    )
    np.testing.assert_array_equal(sel.numpy(), st.numpy())
    np.testing.assert_array_equal(idx.reshape(16, 256).numpy(), it.numpy())


def test_tensor_scale_is_ieee_division():
    x = _inputs("heavy", (7, 96), seed=11)
    jcfg, tcfg = _cfgs(8, 64, 8)
    np.testing.assert_array_equal(
        tbcq.tensor_scale(_t(x), tcfg).numpy(), np.asarray(jbcq.tensor_scale(jnp.asarray(x), jcfg))
    )
    assert tbcq.tensor_scale(torch.zeros(4, 64), tcfg).item() == 1.0


def test_port_codebooks_are_a_byte_copy():
    ours = t_universal()
    theirs = default_universal_codebooks(jbcq.BCQConfig())
    np.testing.assert_array_equal(ours.levels, theirs.levels)
    with pytest.raises(FileNotFoundError):
        t_universal(tbcq.BCQConfig(block_len=2, array_len=16, n_codebooks=2))
