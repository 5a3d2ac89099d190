"""The port's train-mode LSTM against the JAX package's: the train
kernels' plain versions (ops/kernels/lstm_train.py) against the Pallas
train kernels run in interpret mode, `LstmLayerTrain` against `jax.vjp`
of `make_lstm_layer_train_pallas`, the fused stack's gradients against
the port's plain bf16 scan autograd (as tests/test_pallas_lstm.py holds
the Pallas kernels to XLA's), and the plain scan's gradients in float64
against `jax.grad` of the JAX scan."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from efficientvideoclassification_youtube8m_tpu.ops import lstm as jlstm
from efficientvideoclassification_youtube8m_tpu.ops.pallas.lstm_scan import (
    _train_fwd_pallas,
    make_lstm_layer_train_pallas,
)
from efficientvideoclassification_youtube8m_torch.ops import lstm as tlstm
from efficientvideoclassification_youtube8m_torch.ops.kernels import _build
from efficientvideoclassification_youtube8m_torch.ops.kernels.lstm_train import (
    LstmLayerTrain,
    lstm_train_bwd,
    lstm_train_bwd_reference,
    lstm_train_fwd,
    lstm_train_fwd_reference,
    multi_lstm_scan_train_fused,
)
from efficientvideoclassification_youtube8m_torch.weights import load_jax_params

torch.set_num_threads(1)

SEQ = np.r_[0, 1, 3, 7, 15, 15, 10, 2, 14, 5, 0, 9, 15, 4, 6, 11]
B, T, D, H = 16, 15, 12, 8


def _layer(seed):
    """JAX-initialized kernel with a non-zero bias, as numpy."""
    p = jax.tree.map(np.array, jlstm.init_multi_lstm(
        jax.random.PRNGKey(seed), D, H, 1))[0]
    p["bias"] = np.random.default_rng(seed).normal(
        0, 0.3, p["bias"].shape).astype(np.float32)
    return p


def _inputs(seed):
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(B, T, D)).astype(np.float32)
    # cotangents: the outputs' arrives as bf16 values (the outputs are bf16)
    d_outs = torch.from_numpy(rng.normal(size=(B, T, H)).astype(np.float32)
                              ).bfloat16().float().numpy()
    d_c, d_h = (rng.normal(size=(B, H)).astype(np.float32) for _ in range(2))
    return xs, d_outs, d_c, d_h


@pytest.fixture(scope="module")
def fwd_case():
    """The JAX train forward in interpret mode, and its bf16 x @ Wx
    (computed as `_train_fwd_pallas` computes it) for the port."""
    p = _layer(0)
    xs, *_ = _inputs(0)
    xs_tm = jnp.swapaxes(jnp.asarray(xs), 0, 1)
    want = _train_fwd_pallas(jnp.asarray(p["kernel"]), jnp.asarray(p["bias"]),
                             xs_tm, jnp.asarray(SEQ), 1.0, 8, True)
    x_proj = jax.lax.dot_general(
        xs_tm.astype(jnp.bfloat16), jnp.asarray(p["kernel"][:D], jnp.bfloat16),
        dimension_numbers=(((2,), (0,)), ((), ())),
        preferred_element_type=jnp.bfloat16)
    xp = torch.from_numpy(np.asarray(x_proj, np.float32)).bfloat16()
    args = (xp, torch.from_numpy(p["kernel"][D:]), torch.from_numpy(p["bias"]),
            torch.from_numpy(SEQ))
    return args, [np.asarray(w, np.float32) for w in want]


def test_fwd_reference_matches_pallas_interpret(fwd_case):
    args, (w_outs, w_gates, w_cs, w_c, w_h) = fwd_case
    outs, gates, cs, c_fin, h_fin = lstm_train_fwd_reference(*args)
    assert outs.dtype == torch.bfloat16 and gates.dtype == torch.float32
    # same f32 math on the same bf16 operands: the f32 streams agree to
    # summation order, the bf16 outs to one bf16 ulp of |h| < 1
    for got, want in ((gates, w_gates), (cs, w_cs), (c_fin, w_c), (h_fin, w_h)):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(outs.float().numpy(), w_outs, atol=2 ** -8)
    for b, s in enumerate(SEQ):
        assert np.all(outs[s:, b].float().numpy() == 0.0)
    # post-activations are written at EVERY step, past seq included
    assert np.all(gates[:, SEQ == 0].numpy() != 0.0)


def test_bwd_reference_matches_the_pallas_bwd_math(fwd_case):
    """Step by step, the plain backward against numpy of the Pallas bwd
    kernel body (f32 gate derivatives, hi/lo split products)."""
    args, _ = fwd_case
    _, gates, cs, _, _ = lstm_train_fwd_reference(*args)
    rng = np.random.default_rng(1)
    d_outs = rng.normal(size=(T, B, H)).astype(np.float32)
    d_c, d_h = (rng.normal(size=(B, H)).astype(np.float32) for _ in range(2))
    got = lstm_train_bwd_reference(args[1], gates, cs, torch.from_numpy(d_outs),
                                   torch.from_numpy(d_c), torch.from_numpy(d_h),
                                   args[3])
    g, c = gates.numpy(), cs.numpy()
    w_t = args[1].bfloat16().float().numpy().T
    bf = lambda x: torch.from_numpy(x).bfloat16().float().numpy()  # noqa: E731
    dc, dh = d_c, d_h
    for t in reversed(range(T)):
        si, tj, sf, so = np.split(g[t], 4, axis=-1)
        tc = np.tanh(c[t])
        c_prev = c[t - 1] if t else np.zeros_like(c[t])
        valid = (t < SEQ)[:, None]
        dnew_h = np.where(valid, dh + d_outs[t], 0.0)
        dnew_c = np.where(valid, dc, 0.0) + dnew_h * so * (1 - tc * tc)
        dg = np.concatenate([dnew_c * tj * si * (1 - si),
                             dnew_c * si * (1 - tj * tj),
                             dnew_c * c_prev * sf * (1 - sf),
                             dnew_h * tc * so * (1 - so)], -1)
        # the emitted stream is bf16(dg): one bf16 ulp apart at most
        np.testing.assert_allclose(got[t].float().numpy(), bf(dg),
                                   rtol=2 ** -7, atol=1e-6)
        hi = bf(got[t].float().numpy())
        lo = bf(dg - hi)
        dh = hi @ w_t + lo @ w_t + np.where(valid, 0.0, dh)
        dc = dnew_c * sf + np.where(valid, 0.0, dc)


@pytest.fixture(scope="module")
def layer_case():
    """`jax.vjp` of the Pallas train layer (interpret mode) and the port's
    LstmLayerTrain on the CPU, same weights, inputs and cotangents."""
    p = _layer(2)
    xs, d_outs, d_c, d_h = _inputs(2)
    layer = make_lstm_layer_train_pallas(1.0, tile_b=8, bwd_tile_b=8,
                                         interpret=True)
    prim, vjp = jax.vjp(lambda k, b, x: layer(k, b, x, jnp.asarray(SEQ)),
                        jnp.asarray(p["kernel"]), jnp.asarray(p["bias"]),
                        jnp.asarray(xs))
    want = vjp((jnp.asarray(d_outs, jnp.bfloat16), jnp.asarray(d_c),
                jnp.asarray(d_h)))
    kernel, bias, x = (torch.from_numpy(a).requires_grad_(True)
                       for a in (p["kernel"], p["bias"], xs))
    outs, c_fin, h_fin = LstmLayerTrain.apply(kernel, bias, x,
                                              torch.from_numpy(SEQ), 1.0)
    got = torch.autograd.grad((outs, c_fin, h_fin), (kernel, bias, x),
                              (torch.from_numpy(d_outs).bfloat16(),
                               torch.from_numpy(d_c), torch.from_numpy(d_h)))
    return (outs, c_fin, h_fin), prim, got, want


def test_layer_forward_matches_jax(layer_case):
    (outs, c_fin, h_fin), prim, _, _ = layer_case
    assert outs.shape == (B, T, H) and outs.dtype == torch.bfloat16
    np.testing.assert_allclose(outs.detach().float().numpy(),
                               np.asarray(prim[0], np.float32),
                               atol=2 ** -8)
    np.testing.assert_allclose(c_fin.detach().numpy(), np.asarray(prim[1]), atol=1e-5)
    np.testing.assert_allclose(h_fin.detach().numpy(), np.asarray(prim[2]), atol=1e-5)


@pytest.mark.parametrize("index,name", [(0, "d_kernel"), (1, "d_bias"),
                                        (2, "d_xs")])
def test_layer_gradients_match_jax_vjp(layer_case, index, name):
    _, _, got, want = layer_case
    g, w = got[index].numpy(), np.asarray(want[index])
    assert g.shape == w.shape
    # the same algorithm in f32 on both sides (0, 0 and 1.3e-7 of the max
    # measured); the bound leaves room for a dgates element that rounds to
    # bf16 one ulp apart after the dh chain summed in another order
    scale = np.abs(w).max()
    assert np.abs(g - w).max() / scale < 1e-4, name


def _stack_params(num_layers=2, seed=7):
    tree = jax.tree.map(np.asarray, jlstm.init_multi_lstm(
        jax.random.PRNGKey(seed), 12, 8, num_layers))
    return load_jax_params(tlstm.init_multi_lstm(None, 12, 8, num_layers), tree)


def test_fused_stack_gradients_track_the_plain_bf16_scan():
    """tests/test_pallas_lstm.py:150-179 for the port: values equal to
    summation order, gradients within the bf16-residual bar."""
    xs = torch.from_numpy(np.random.default_rng(6).normal(size=(8, 15, 12))
                          .astype(np.float32))
    seq = torch.tensor([0, 1, 3, 7, 15, 15, 10, 2], dtype=torch.int32)
    tgt = torch.from_numpy(np.random.default_rng(7).normal(size=(8, 32))
                           .astype(np.float32))
    params = _stack_params()

    def loss(fused):
        s = (multi_lstm_scan_train_fused(params, xs, seq) if fused else
             tlstm.multi_lstm_scan(params, xs, seq, compute_dtype=torch.bfloat16))
        return torch.sum((s - tgt) ** 2)

    weights = [t for p in params for t in (p.kernel, p.bias)]
    v0, v1 = loss(False), loss(True)
    np.testing.assert_allclose(v1.item(), v0.item(), rtol=1e-6)
    g0 = torch.autograd.grad(v0, weights)
    g1 = torch.autograd.grad(v1, weights)
    for a, b in zip(g0, g1):
        scale = max(a.abs().max().item(), 1e-6)
        assert (a - b).abs().max().item() / scale < 0.03


@pytest.mark.parametrize("num_layers", [1, 2])
def test_plain_scan_gradients_match_jax_in_float64(num_layers):
    """The plain scan is the oracle of the train kernels: its autograd
    gradients agree with `jax.grad` of the JAX scan in float64."""
    rng = np.random.default_rng(3)
    Bq, Tq, Dq, Hq = 4, 15, 12, 8
    xs = rng.normal(size=(Bq, Tq, Dq))
    seq = np.array([0, 1, 7, 15], np.int32)
    tgt = rng.normal(size=(Bq, num_layers * 2 * Hq))
    tgt_outs = rng.normal(size=(Bq, Tq, Hq))
    with jax.enable_x64(True):
        tree = [{k: rng.normal(0, 0.3, np.shape(v)) for k, v in p.items()}
                for p in jlstm.init_multi_lstm(jax.random.PRNGKey(0), Dq, Hq,
                                               num_layers)]

        def jloss(params, x):
            state, outs = jlstm.multi_lstm_scan(
                params, x, jnp.asarray(seq), compute_dtype=jnp.float64,
                return_outputs=True)
            return jnp.sum((state - tgt) ** 2) + jnp.sum((outs - tgt_outs) ** 2)

        want_p, want_x = jax.grad(jloss, argnums=(0, 1))(
            jax.tree.map(jnp.asarray, tree), jnp.asarray(xs))
        want_p = jax.tree.map(np.asarray, want_p)
        want_x = np.asarray(want_x)
    params = load_jax_params(
        tlstm.init_multi_lstm(None, Dq, Hq, num_layers, dtype=torch.float64), tree)
    x = torch.from_numpy(xs).requires_grad_(True)
    state, outs = tlstm.multi_lstm_scan(params, x, torch.from_numpy(seq),
                                        compute_dtype=torch.float64,
                                        return_outputs=True)
    assert state.dtype == torch.float64
    loss = (torch.sum((state - torch.from_numpy(tgt)) ** 2)
            + torch.sum((outs - torch.from_numpy(tgt_outs)) ** 2))
    weights = [t for p in params for t in (p.kernel, p.bias)]
    grads = torch.autograd.grad(loss, weights + [x])
    for layer in range(num_layers):
        np.testing.assert_allclose(grads[2 * layer].numpy(),
                                   want_p[layer]["kernel"], rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(grads[2 * layer + 1].numpy(),
                                   want_p[layer]["bias"], rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(grads[-1].numpy(), want_x, rtol=1e-10, atol=1e-12)


def test_train_wrappers_on_cpu_count_no_launch_and_build_nothing(monkeypatch):
    def no_build(*_):
        raise AssertionError("a CPU tensor must not build the CUDA kernels")

    monkeypatch.setattr(_build, "load_library", no_build)
    monkeypatch.setattr(_build, "build", no_build)
    assert _build.loaded() == {}
    before = (lstm_train_fwd.launches, lstm_train_bwd.launches)
    rng = np.random.default_rng(5)
    Tq, Bq, Hq = 3, 5, 8
    xp = torch.from_numpy(rng.normal(size=(Tq, Bq, 4 * Hq)).astype(np.float32))
    w_h, bias = torch.randn(Hq, 4 * Hq), torch.zeros(4 * Hq)
    seq = torch.tensor([0, 1, 2, 3, 3])
    fwd = lstm_train_fwd(xp.bfloat16(), w_h, bias, seq)
    for g, w in zip(fwd, lstm_train_fwd_reference(xp.bfloat16(), w_h, bias, seq)):
        assert torch.equal(g, w)
    cot = (torch.randn(Tq, Bq, Hq), torch.randn(Bq, Hq), torch.randn(Bq, Hq))
    dg = lstm_train_bwd(w_h, fwd[1], fwd[2], *cot, seq)
    assert torch.equal(dg, lstm_train_bwd_reference(w_h, fwd[1], fwd[2], *cot, seq))
    assert dg.dtype == torch.bfloat16 and dg.shape == (Tq, Bq, 4 * Hq)
    assert (lstm_train_fwd.launches, lstm_train_bwd.launches) == before
    assert _build.loaded() == {}


def test_train_bwd_wrapper_rejects_what_the_kernel_does_not_take():
    Tq, Bq, Hq = 2, 3, 8
    ok = dict(w_h=torch.zeros(Hq, 4 * Hq), gates=torch.zeros(Tq, Bq, 4 * Hq),
              cs=torch.zeros(Tq, Bq, Hq), d_outs=torch.zeros(Tq, Bq, Hq),
              d_cfin=torch.zeros(Bq, Hq), d_hfin=torch.zeros(Bq, Hq),
              seq_len=torch.zeros(Bq, dtype=torch.int32))
    assert lstm_train_bwd(**ok).shape == (Tq, Bq, 4 * Hq)
    for name, bad, error in [
            ("gates", torch.zeros(Tq, Bq, 4 * Hq + 1), ValueError),
            ("cs", torch.zeros(Tq, Bq, Hq + 1), ValueError),
            ("d_outs", torch.zeros(Tq, Bq, Hq, dtype=torch.bfloat16), TypeError),
            ("d_hfin", torch.zeros(Bq + 1, Hq), ValueError),
            ("seq_len", torch.zeros(Bq), TypeError),
            ("w_h", torch.zeros(Hq, 4 * Hq, dtype=torch.int32), TypeError)]:
        with pytest.raises(error):
            lstm_train_bwd(**{**ok, name: bad})
