"""Port parity: the DeepAR model (``sitewhere_tpu_torch.models.deepar``, the
plain versions of kernels KD and KF) against ``sitewhere_tpu.models.deepar``
on identical numpy inputs and one param tree carried across as numpy.

Tolerances are the reference's bars (``tests/test_fused_step.py:110-112``):
float32 compute 5e-5, bfloat16 compute 2e-2.

The forecast is held against the reference's own ``forecast`` fed JAX's
noise: the draws the reference makes (``keys = jax.random.split(key,
horizon)``, then ``jax.random.normal(keys[t], (S * B,))``) are made here in
numpy and handed to the port as ``eps``. With f32 compute every sample path
holds to 5e-5. With bf16 compute a one-ulp gap in a rounded op is carried
through the autoregressive steps (x feeds the next step): measured here
(hidden 16, context 16, horizon 4, 4 samples, 3 series, raw values of
magnitude up to 2.4), the largest gap over all paths per horizon step was
1.2e-3, 9.1e-4, 1.4e-3, 2.0e-3, and 6.1e-4 on the mean; the first step, the
mean and every path are held at 2e-2."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sitewhere_tpu.models as jm
import sitewhere_tpu.models.common as jc
import sitewhere_tpu_torch.models as tm
import sitewhere_tpu_torch.models.common as tc

TOL = {"float32": 5e-5, "bfloat16": 2e-2}
S, B, W, H = 3, 16, 12, 16
CONTEXT, HORIZON, SAMPLES = 16, 4, 4

# tiny tensors: one intra-op thread, so the suite's parallel workers keep
# their cores
torch.set_num_threads(1)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _configs(dtype):
    over = {"hidden": H, "dtype": dtype, "context": CONTEXT, "horizon": HORIZON,
            "num_samples": SAMPLES}
    return jm.make_config("deepar", over), tm.make_config("deepar", over)


def _params_np(seed, rng):
    """A JAX param tree as numpy, with non-zero biases so the bias rounding
    paths are exercised; the sigma head's bias near -2 (sigma ~0.13) makes
    the NLL scores take both signs."""
    jcfg, _ = _configs("float32")
    p = _np_tree(jm.get_model("deepar").init(jax.random.PRNGKey(seed), jcfg))
    for layer in p.values():
        layer["b"] = rng.normal(scale=0.1, size=layer["b"].shape).astype(np.float32)
    p["sigma"]["b"] -= 2.0
    return p


def _stacked_np(rng):
    trees = [_params_np(i, rng) for i in range(S)]
    return jax.tree_util.tree_map(lambda *xs: np.stack(xs), *trees)


def _windows(rng):
    wins = rng.normal(size=(S, B, W)).astype(np.float32)
    wins[1] = np.cumsum(wins[1], -1)  # a drifting series too
    wins[2] = np.sin(np.arange(W) / 2.0)[None] + 0.05 * wins[2]  # a predictable one
    nv = np.full((S, B), W, np.int32)
    nv[0, :3] = [0, 3, 5]  # cold starts around the 4-sample gate
    return wins, nv


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_score_stacked_matches_reference(dtype, k):
    jcfg, tcfg = _configs(dtype)
    rng = np.random.default_rng(30)
    stacked = _stacked_np(rng)
    wins, nv = _windows(rng)
    js = np.asarray(jm.deepar.score_stacked(
        stacked, jcfg, jnp.asarray(wins), jnp.asarray(nv), k=k
    ))
    ts = tm.deepar.score_stacked(
        tc.params_from_numpy(stacked, "cpu"), tcfg, torch.from_numpy(wins),
        torch.from_numpy(nv), k=k,
    ).numpy()
    assert ts.shape == js.shape == (S, B, k)
    np.testing.assert_allclose(ts, js, rtol=TOL[dtype], atol=TOL[dtype])
    np.testing.assert_array_equal(ts == 0.0, js == 0.0)  # same cold-start mask
    assert (ts < 0).any() and (ts > 0).any()  # NLL scores of both signs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_score_legacy_matches_reference(dtype):
    jcfg, tcfg = _configs(dtype)
    rng = np.random.default_rng(31)
    one = _params_np(0, rng)
    wins, nv = _windows(rng)
    wins, nv = wins.reshape(S * B, W), nv.reshape(S * B)
    js = np.asarray(jm.deepar.score(one, jcfg, jnp.asarray(wins), jnp.asarray(nv)))
    ts = tm.deepar.score(
        tc.params_from_numpy(one, "cpu"), tcfg, torch.from_numpy(wins),
        torch.from_numpy(nv),
    ).numpy()
    np.testing.assert_allclose(ts, js, rtol=TOL[dtype], atol=TOL[dtype])
    assert np.all(ts[:2] == 0.0) and np.any(ts != 0.0)


def _jax_noise(key, n_series):
    keys = jax.random.split(key, HORIZON)
    return np.stack([
        np.asarray(jax.random.normal(keys[t], (SAMPLES * n_series,)))
        for t in range(HORIZON)
    ]).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forecast_matches_reference_on_its_noise(dtype):
    jcfg, tcfg = _configs(dtype)
    rng = np.random.default_rng(32)
    one = _params_np(1, rng)
    wins = (2.0 + np.sin(np.arange(CONTEXT)[None] / 3.0 + np.arange(3)[:, None])
            + 0.1 * rng.normal(size=(3, CONTEXT))).astype(np.float32)
    key = jax.random.PRNGKey(5)
    j_samples, j_mean = (np.asarray(x) for x in jm.deepar.forecast(
        one, jcfg, jnp.asarray(wins), key))
    eps = _jax_noise(key, 3)
    t_samples, t_mean = (x.numpy() for x in tm.deepar.forecast(
        tc.params_from_numpy(one, "cpu"), tcfg, torch.from_numpy(wins),
        eps=torch.from_numpy(eps)))
    assert t_samples.shape == j_samples.shape == (SAMPLES, 3, HORIZON)
    assert t_mean.shape == j_mean.shape == (3, HORIZON)
    tol = TOL[dtype]
    np.testing.assert_allclose(t_samples[..., 0], j_samples[..., 0], rtol=tol, atol=tol)
    np.testing.assert_allclose(t_mean, j_mean, rtol=tol, atol=tol)
    np.testing.assert_allclose(t_samples, j_samples, rtol=tol, atol=tol)
    np.testing.assert_allclose(t_mean, t_samples.mean(0), rtol=1e-6, atol=1e-6)
    # the noise is what moves the paths: other draws give other samples
    other, _ = tm.deepar.forecast(
        tc.params_from_numpy(one, "cpu"), tcfg, torch.from_numpy(wins),
        generator=torch.Generator().manual_seed(0))
    assert other.shape == (SAMPLES, 3, HORIZON) and not np.allclose(other.numpy(), t_samples)
    with pytest.raises(ValueError, match="exactly one"):
        tm.deepar.forecast(tc.params_from_numpy(one, "cpu"), tcfg, torch.from_numpy(wins))


def test_quantiles_match_reference():
    samples = np.random.default_rng(33).normal(size=(7, 3, HORIZON)).astype(np.float32)
    for qs in [(0.1, 0.5, 0.9), (0.0, 0.25, 1.0)]:
        np.testing.assert_allclose(
            tm.deepar.quantiles(torch.from_numpy(samples), qs).numpy(),
            np.asarray(jm.deepar.quantiles(jnp.asarray(samples), qs)),
            rtol=1e-6, atol=1e-6,
        )


def test_flop_accounting_matches_reference():
    for hidden, steps in [(64, 31), (16, 127)]:
        assert tc.gru_scan_flops(hidden, steps) == jc.gru_scan_flops(hidden, steps)
    cfg, jcfg = tm.make_config("deepar", {}), jm.make_config("deepar", {})
    for w, k, pd in [(32, None, "f32"), (32, 1, "f32"), (32, 3, "int8"), (12, 99, "bf16")]:
        assert tc.deepar_flops_per_row(cfg, w, k=k, param_dtype=pd) == \
            jc.deepar_flops_per_row(jcfg, w, k=k, param_dtype=pd)
    assert tc.deepar_flops_per_row(cfg, 32, k=1) == 774016.0
    assert tm.get_model("deepar").flops_per_row is tc.deepar_flops_per_row


def test_registry_init_and_param_round_trip():
    spec = tm.get_model("deepar")
    jspec = jm.get_model("deepar")
    assert spec.score_stacked is tm.deepar.score_stacked
    assert spec.score_flush is tm.deepar.gru_score
    assert spec.forecast is tm.deepar.forecast
    assert spec.score_range == jspec.score_range
    cfg = tm.make_config("deepar", {"context": 128, "bogus": 1})
    assert (cfg.context, cfg.horizon, cfg.hidden, cfg.num_samples, cfg.dtype) == \
        (128, 24, 64, 64, "bfloat16")
    p = spec.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    jp = jspec.init(jax.random.PRNGKey(0), jm.make_config("deepar", {}))
    assert set(p) == set(jp) == {"wx", "wh", "mu", "sigma"}
    for layer in jp:
        assert set(p[layer]) == set(jp[layer]) == {"w", "b"}
        for leaf in jp[layer]:
            assert tuple(p[layer][leaf].shape) == tuple(jp[layer][leaf].shape)
            assert p[layer][leaf].dtype == torch.float32
    # the recurrent kernel is scaled by 1/sqrt(hidden), as the reference's
    assert abs(float(p["wh"]["w"].std()) - float(np.asarray(jp["wh"]["w"]).std())) < 0.02
    again = spec.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert all(torch.equal(again[k]["w"], p[k]["w"]) for k in p)
    back = tc.params_to_numpy(tc.params_from_numpy(_np_tree(jp), "cpu"))
    for layer in jp:
        for leaf in jp[layer]:
            np.testing.assert_array_equal(back[layer][leaf], np.asarray(jp[layer][leaf]))
