"""Tensor-parallel SwiGLU FFN on the virtual CPU mesh.

The TP block (``parallel/ffn.py``) quantizes the hidden activations
per-SHARD (each device scales its own hidden slice), so the reference here
computes exactly that with dense numpy math: per shard, the SwiGLU on the
shard's gate/up columns and down rows with the shard's own per-row int8
requantize, then the sum — what the ``psum`` computes. The p=1 case must
also match the single-device block directly.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from ternary_spgemm_tpu.formats import TiledBitplane, generate_ternary, generate_x
from ternary_spgemm_tpu.models.exported import requantize_rows
from ternary_spgemm_tpu.parallel import make_mesh, tensor_parallel_fused_swiglu
from ternary_spgemm_tpu.parallel.ffn import swiglu_a8

GAMMAS = dict(gamma_gate=0.021, gamma_up=0.034, gamma_down=1.3)


def _problem(M=8, K=128, N1=512, N2=128, s=4, *, tile_n=256, tkb_down=16):
    Wg = generate_ternary(K, N1, s, seed=0)
    Wu = generate_ternary(K, N1, s, seed=1)
    Wd = generate_ternary(N1, N2, s, seed=2)
    fmt_g = TiledBitplane.from_dense(Wg, tile_n=tile_n)
    fmt_u = TiledBitplane.from_dense(Wu, tile_n=tile_n)
    fmt_d = TiledBitplane.from_dense(Wd, tkb=tkb_down)
    x = generate_x(M, K, seed=3)
    xq, sx = requantize_rows(jnp.asarray(x, jnp.float32))
    return (Wg, Wu, Wd), (fmt_g, fmt_u, fmt_d), (xq, sx)


def _per_shard_reference(Ws, xq, sx, n_dev):
    """Sum of per-shard dense SwiGLU blocks — the TP block's semantics."""
    Wg, Wu, Wd = (np.asarray(w, np.float64) for w in Ws)
    xq, sx = np.asarray(xq, np.float64), np.asarray(sx, np.float64)
    w = Wg.shape[1] // n_dev
    y = 0.0
    for d in range(n_dev):
        cols = slice(d * w, (d + 1) * w)
        g = GAMMAS["gamma_gate"] * sx * (xq @ Wg[:, cols])
        u = GAMMAS["gamma_up"] * sx * (xq @ Wu[:, cols])
        h = g / (1.0 + np.exp(-g)) * u
        hq, s = (np.asarray(a, np.float64)
                 for a in requantize_rows(jnp.asarray(h, jnp.float32)))
        y = y + (hq @ Wd[cols]) * (s * GAMMAS["gamma_down"])
    return y


@pytest.mark.parametrize("n_dev,tile_n", [(1, 256), (2, 256), (4, 128)])
def test_tp_fused_swiglu_matches_per_shard_reference(n_dev, tile_n):
    Ws, fmts, (xq, sx) = _problem(tile_n=tile_n)
    mesh = make_mesh({"tp": n_dev})
    got = np.asarray(tensor_parallel_fused_swiglu(
        xq, sx, *fmts, mesh=mesh, axis="tp", **GAMMAS))
    want = _per_shard_reference(Ws, xq, sx, n_dev)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0.01)


def test_tp_p1_equals_single_device():
    Ws, fmts, (xq, sx) = _problem()
    mesh = make_mesh({"tp": 1})
    got = np.asarray(tensor_parallel_fused_swiglu(
        xq, sx, *fmts, mesh=mesh, axis="tp", **GAMMAS))
    want = np.asarray(swiglu_a8(xq, sx, *fmts, **GAMMAS))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0.01)


def test_tp_scatter_output():
    Ws, fmts, (xq, sx) = _problem()
    mesh = make_mesh({"tp": 2})
    got = np.asarray(tensor_parallel_fused_swiglu(
        xq, sx, *fmts, mesh=mesh, axis="tp", scatter_output=True, **GAMMAS))
    want = _per_shard_reference(Ws, xq, sx, 2)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0.01)


def test_tp_subtile_output_width():
    # N2=64 < the 128-lane tile: localize() reports the padded width, the
    # wrapper must slice back to the true N2 (caught by the dryrun scheme)
    Ws, fmts, (xq, sx) = _problem(K=64, N1=256, N2=64, tile_n=128)
    mesh = make_mesh({"tp": 2})
    got = np.asarray(tensor_parallel_fused_swiglu(
        xq, sx, *fmts, mesh=mesh, axis="tp", **GAMMAS))
    assert got.shape == (8, 64)
    want = _per_shard_reference(Ws, xq, sx, 2)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0.01)


def test_tp_misaligned_raises():
    Ws, fmts, (xq, sx) = _problem(tile_n=128)     # gn=4 splits over 4
    mesh = make_mesh({"tp": 4})
    fmt_d_big = TiledBitplane.from_dense(Ws[2])   # tkb=32 -> B2=256 > shard
    with pytest.raises(ValueError, match="multiple of the K-block"):
        tensor_parallel_fused_swiglu(xq, sx, fmts[0], fmts[1], fmt_d_big,
                                     mesh=mesh, axis="tp", **GAMMAS)
