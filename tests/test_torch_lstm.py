"""The port's LSTM scans against the JAX package's: the plain scan
(ops/lstm.py) against `multi_lstm_scan`, and the CUDA kernel's plain
version (ops/kernels/lstm_scan.py) against the Pallas kernel run in
interpret mode, as tests/test_pallas_lstm.py runs it. Weights come from
the JAX init through the numpy parameter bridge."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from efficientvideoclassification_youtube8m_tpu.ops import lstm as jlstm
from efficientvideoclassification_youtube8m_tpu.ops.pallas.lstm_scan import (
    lstm_chunk_scan_pallas,
    multi_lstm_scan_pallas,
)
from efficientvideoclassification_youtube8m_torch.ops import lstm as tlstm
from efficientvideoclassification_youtube8m_torch.ops.kernels import _build
from efficientvideoclassification_youtube8m_torch.ops.kernels.lstm_scan import (
    lstm_chunk_scan,
    lstm_chunk_scan_reference,
    multi_lstm_scan_fused,
)
from efficientvideoclassification_youtube8m_torch.weights import load_jax_params

torch.set_num_threads(1)

SEQ = np.r_[0, 1, 3, 7, 15, 15, 10, 2, 14, 5, 0, 9, 15, 4, 6, 11]


def _params(num_layers, D, H, seed=0):
    jparams = jlstm.init_multi_lstm(jax.random.PRNGKey(seed), D, H, num_layers)
    tree = jax.tree.map(np.asarray, jparams)
    # a non-zero bias, so that the bias paths are exercised
    for layer in tree:
        layer["bias"] = np.random.default_rng(seed).normal(
            0, 0.3, layer["bias"].shape).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, tree)
    return jparams, load_jax_params(tlstm.init_multi_lstm(None, D, H, num_layers),
                                    tree)


def _np(t):
    return t.detach().float().numpy()


def _bf16_exact(x):
    """float32 values that bf16 represents exactly, so that both
    frameworks start from the same bf16 tensor."""
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("num_layers", [1, 2])
def test_plain_scan_matches_jax_f32(num_layers):
    B, T, D, H = 16, 15, 12, 8
    jparams, tparams = _params(num_layers, D, H)
    xs = np.random.default_rng(0).normal(size=(B, T, D)).astype(np.float32)
    want_state, want_outs = jlstm.multi_lstm_scan(
        jparams, jnp.asarray(xs), jnp.asarray(SEQ), return_outputs=True)
    state, outs = tlstm.multi_lstm_scan(
        tparams, torch.from_numpy(xs), torch.from_numpy(SEQ),
        return_outputs=True)
    # same f32 math; only the summation order of the matmuls differs
    np.testing.assert_allclose(_np(state), np.asarray(want_state),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(outs), np.asarray(want_outs),
                               rtol=1e-5, atol=1e-6)


def test_plain_scan_matches_jax_bf16():
    B, T, D, H = 16, 15, 12, 8
    jparams, tparams = _params(2, D, H, seed=1)
    xs = np.random.default_rng(1).normal(size=(B, T, D)).astype(np.float32)
    want = jlstm.multi_lstm_scan(jparams, jnp.asarray(xs), jnp.asarray(SEQ),
                                 compute_dtype=jnp.bfloat16)
    got = tlstm.multi_lstm_scan(tparams, torch.from_numpy(xs),
                                torch.from_numpy(SEQ),
                                compute_dtype=torch.bfloat16)
    assert got.dtype == torch.float32
    # both round x_proj and the stacked outputs to bf16 at the same
    # places and accumulate in f32, so they agree to f32 summation order
    # (2.4e-7 measured at this seed)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5)


def test_lstm_cell_step_matches_jax():
    jparams, tparams = _params(1, 5, 8, seed=2)
    rng = np.random.default_rng(2)
    x, c, h = (rng.normal(size=(3, n)).astype(np.float32) for n in (5, 8, 8))
    want = jlstm.lstm_cell_step(jparams[0], *map(jnp.asarray, (x, c, h)))
    got = tlstm.lstm_cell_step(tparams[0], *map(torch.from_numpy, (x, c, h)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)


def test_kernel_reference_matches_pallas_interpret():
    T, B, H = 15, 16, 8
    jparams, _ = _params(1, 4, H, seed=3)
    w_h = np.array(jparams[0]["kernel"][4:])
    bias = np.array(jparams[0]["bias"])
    xp = _bf16_exact(np.random.default_rng(3).normal(
        size=(T, B, 4 * H)).astype(np.float32))
    want = lstm_chunk_scan_pallas(jnp.asarray(xp, jnp.bfloat16),
                                  jnp.asarray(w_h), jnp.asarray(bias),
                                  jnp.asarray(SEQ), tile_b=8, interpret=True)
    got = lstm_chunk_scan_reference(
        torch.from_numpy(xp).bfloat16(), torch.from_numpy(w_h),
        torch.from_numpy(bias), torch.from_numpy(SEQ))
    outs, c_fin, h_fin = map(_np, got)
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    # same math in f32 on the same bf16 operands: the finals differ only
    # by summation order; the bf16 outs by at most one bf16 ulp of |h|<1
    np.testing.assert_allclose(c_fin, np.asarray(want[1]), atol=1e-5)
    np.testing.assert_allclose(h_fin, np.asarray(want[2]), atol=1e-5)
    np.testing.assert_allclose(outs, np.asarray(want[0], np.float32),
                               atol=2 ** -8)
    for b, s in enumerate(SEQ):
        assert np.all(outs[s:, b] == 0.0)
    assert np.all(c_fin[SEQ == 0] == 0.0) and np.all(h_fin[SEQ == 0] == 0.0)


@pytest.mark.parametrize("num_layers", [1, 2])
def test_fused_stack_matches_pallas_interpret(num_layers):
    B, T, D, H = 16, 15, 12, 8
    jparams, tparams = _params(num_layers, D, H, seed=4)
    xs = np.random.default_rng(4).normal(size=(B, T, D)).astype(np.float32)
    want = multi_lstm_scan_pallas(jparams, jnp.asarray(xs), jnp.asarray(SEQ),
                                  tile_b=8, interpret=True)
    with torch.no_grad():
        got = multi_lstm_scan_fused(tparams, torch.from_numpy(xs),
                                    torch.from_numpy(SEQ))
    # bf16 roundings at the same places as the Pallas path, f32 sums:
    # agreement to f32 summation order (2.4e-7 measured at this seed)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5)


def test_cpu_wrapper_counts_no_launch_and_builds_nothing(monkeypatch):
    def no_build(*_):
        raise AssertionError("a CPU tensor must not build the CUDA kernel")

    monkeypatch.setattr(_build, "load_library", no_build)
    assert _build.loaded() == {}  # importing built and loaded nothing
    before = lstm_chunk_scan.launches
    T, B, H = 3, 5, 8
    rng = np.random.default_rng(5)
    xp = torch.from_numpy(rng.normal(size=(T, B, 4 * H)).astype(np.float32))
    args = (xp.bfloat16(), torch.randn(H, 4 * H), torch.zeros(4 * H),
            torch.tensor([0, 1, 2, 3, 3]))
    got = lstm_chunk_scan(*args)
    want = lstm_chunk_scan_reference(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert lstm_chunk_scan.launches == before
    assert _build.loaded() == {}


@pytest.mark.parametrize("needs_grad", ["x_proj_tm", "w_h", "bias"])
def test_forward_only_scan_refuses_to_drop_gradients(needs_grad):
    """Under grad mode, an input that requires grad would get no gradient
    from the forward-only kernel, so the wrapper raises (on the CPU as on
    the card) and points to the train path; under no_grad it runs."""
    T, B, H = 2, 3, 8
    args = {"x_proj_tm": torch.zeros(T, B, 4 * H, dtype=torch.bfloat16),
            "w_h": torch.zeros(H, 4 * H), "bias": torch.zeros(4 * H)}
    args[needs_grad].requires_grad_(True)
    seq = torch.full((B,), T)
    with pytest.raises(RuntimeError, match="lstm_train"):
        lstm_chunk_scan(args["x_proj_tm"], args["w_h"], args["bias"], seq)
    with torch.no_grad():
        outs, _, _ = lstm_chunk_scan(args["x_proj_tm"], args["w_h"],
                                     args["bias"], seq)
    assert outs.shape == (T, B, H)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    T, B, H = 2, 3, 8
    xp = torch.zeros(T, B, 4 * H, dtype=torch.bfloat16)
    w, b, seq = torch.zeros(H, 4 * H), torch.zeros(4 * H), torch.zeros(B, dtype=torch.int32)
    with pytest.raises(TypeError):
        lstm_chunk_scan(xp.float(), w, b, seq)
    with pytest.raises(ValueError):
        lstm_chunk_scan(xp, w[:, :-1], b, seq)
    with pytest.raises(ValueError):
        lstm_chunk_scan(xp, w, b[:-1], seq)
    with pytest.raises(ValueError):
        lstm_chunk_scan(xp, w, b, seq[:-1])
    with pytest.raises(TypeError):
        lstm_chunk_scan(xp, w, b, seq.float())
    with pytest.raises(ValueError):
        lstm_chunk_scan(xp[0], w, b, seq)
