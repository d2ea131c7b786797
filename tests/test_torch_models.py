"""Port parity: the LSTM-AD model (``sitewhere_tpu_torch.models``, the
plain version of kernel KS) against ``sitewhere_tpu.models`` on identical
numpy inputs and one param tree carried across as numpy.

Tolerances: float32 compute ``rtol=atol=5e-5`` (reassociation noise only —
the reference's f32 bar, ``tests/test_fused_step.py:110``); bfloat16 compute
``2e-2`` (the reference's bf16 bar, same line)."""

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
S, B, W, H = 3, 6, 12, 8

# tiny tensors: one intra-op thread, so the suite's parallel workers keep
# their cores
torch.set_num_threads(1)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _stacked_np(dtype, hidden=H, window=W):
    """S per-slot JAX param trees (distinct keys, non-zero biases so the
    bias rounding path is exercised), stacked, as numpy."""
    cfg = jm.make_config("lstm_ad", {"window": window, "hidden": hidden, "dtype": dtype})
    rng = np.random.default_rng(5)
    trees = []
    for i in range(S):
        p = _np_tree(jm.get_model("lstm_ad").init(jax.random.PRNGKey(i), cfg))
        for layer in p.values():
            layer["b"] = rng.normal(scale=0.1, size=layer["b"].shape).astype(np.float32)
        trees.append(p)
    stacked = jax.tree_util.tree_map(lambda *xs: np.stack(xs), *trees)
    return cfg, tm.make_config("lstm_ad", {"window": window, "hidden": hidden, "dtype": dtype}), stacked


def _windows(rng):
    wins = rng.normal(size=(S, B, W)).astype(np.float32)
    wins[1] = np.cumsum(wins[1], -1)  # a drifting series too
    nv = np.full((S, B), W, np.int32)
    nv[0, :3] = [0, 3, 5]  # cold starts around the 4-sample gate
    return wins, nv


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_score_legacy_matches_reference(dtype):
    jcfg, tcfg, stacked = _stacked_np(dtype)
    one = jax.tree_util.tree_map(lambda x: x[0], stacked)
    wins, nv = _windows(np.random.default_rng(6))
    js = np.asarray(jm.lstm_ad.score(one, jcfg, jnp.asarray(wins[0]), jnp.asarray(nv[0])))
    ts = tm.lstm_ad.score(
        tc.params_from_numpy(one, "cpu"), tcfg, torch.from_numpy(wins[0]),
        torch.from_numpy(nv[0]),
    ).numpy()
    np.testing.assert_allclose(ts, js, rtol=TOL[dtype], atol=TOL[dtype])
    assert np.all(ts[:2] == 0.0) and np.any(ts != 0.0)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_score_stacked_matches_reference(dtype, k):
    jcfg, tcfg, stacked = _stacked_np(dtype)
    wins, nv = _windows(np.random.default_rng(7))
    js = np.asarray(jm.lstm_ad.score_stacked(
        stacked, jcfg, jnp.asarray(wins), jnp.asarray(nv), k=k
    ))
    ts = tm.lstm_ad.score_stacked(
        tc.params_from_numpy(stacked, "cpu"), tcfg, torch.from_numpy(wins),
        torch.from_numpy(nv), k=k,
    ).numpy()
    assert ts.shape == js.shape == (S, B, k)
    np.testing.assert_allclose(ts, js, rtol=TOL[dtype], atol=TOL[dtype])
    np.testing.assert_array_equal(ts == 0.0, js == 0.0)  # same cold-start mask


@pytest.mark.parametrize("param_dtype", ["bf16", "int8"])
def test_quantized_params_and_scores_match_reference(param_dtype):
    jcfg, tcfg, stacked = _stacked_np("float32")
    jq = _np_tree(jc.quantize_params(jax.tree_util.tree_map(jnp.asarray, stacked), param_dtype))
    tq = tc.quantize_params(tc.params_from_numpy(stacked, "cpu"), param_dtype)
    assert set(jq["wh"]) == set(tq["wh"])
    for layer in jq:
        for leaf in jq[layer]:
            got = tq[layer][leaf]
            if got.dtype == torch.bfloat16:
                got = got.to(torch.float32)
            np.testing.assert_array_equal(got.numpy(), np.asarray(jq[layer][leaf], np.float32)
                                          if jq[layer][leaf].dtype != np.int8 else jq[layer][leaf])
    assert tc.kernel_shape(tq["wh"]) == tuple(jc.kernel_shape(jq["wh"]))
    wins, nv = _windows(np.random.default_rng(8))
    js = np.asarray(jm.lstm_ad.score_stacked(
        jax.tree_util.tree_map(jnp.asarray, jq), jcfg, jnp.asarray(wins), jnp.asarray(nv)
    ))
    ts = tm.lstm_ad.score_stacked(tq, tcfg, torch.from_numpy(wins), torch.from_numpy(nv)).numpy()
    np.testing.assert_allclose(ts, js, rtol=TOL["float32"], atol=TOL["float32"])


def test_helpers_match_reference():
    cfg = tm.make_config("lstm_ad", {})
    jcfg = jm.make_config("lstm_ad", {})
    for k, pd in [(None, "f32"), (1, "f32"), (3, "int8"), (99, "bf16")]:
        assert tc.lstm_ad_flops_per_row(cfg, 32, k=k, param_dtype=pd) == \
            jc.lstm_ad_flops_per_row(jcfg, 32, k=k, param_dtype=pd)
    assert tc.lstm_scan_flops(64, 31) == jc.lstm_scan_flops(64, 31)
    assert tc.dense_flops(64, 256) == jc.dense_flops(64, 256)
    assert tc.QUANT_MAC_WIDTH == jc.QUANT_MAC_WIDTH
    assert tc.PARAM_DTYPES == jc.PARAM_DTYPES
    assert (tc.SKETCH_NBINS, tc.DEFAULT_SCORE_RANGE) == (jc.SKETCH_NBINS, jc.DEFAULT_SCORE_RANGE)
    np.testing.assert_array_equal(tc.sketch_edges(), jc.sketch_edges())
    for k, w in [(1, 32), (5, 4), (0, 8)]:
        assert tc.clamp_fuse_k(k, w) == jc.clamp_fuse_k(k, w)
    nv = np.array([[0, 3, 4, 5, 9]], np.int32)
    np.testing.assert_array_equal(
        tc.kstep_mask(torch.from_numpy(nv), 3).numpy(),
        np.asarray(jc.kstep_mask(jnp.asarray(nv), 3)),
    )
    wins = np.random.default_rng(9).normal(size=(4, W)).astype(np.float32)
    for a, b in zip(tc.normalize_windows(torch.from_numpy(wins)),
                    jc.normalize_windows(jnp.asarray(wins))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=5e-6, atol=5e-6)


def test_registry_init_and_param_round_trip():
    spec = tm.get_model("lstm_ad")
    assert spec.score_stacked is tm.lstm_ad.score_stacked
    assert spec.score_range == jm.get_model("lstm_ad").score_range
    assert tm.get_model("vit_b16").apply is tm.vit.apply
    with pytest.raises(KeyError, match="unknown model 'no_such_model'"):
        tm.get_model("no_such_model")
    cfg = tm.make_config("lstm_ad", {"window": 16, "bogus": 1})
    assert (cfg.window, cfg.hidden, cfg.dtype) == (16, 64, "bfloat16")
    p = spec.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    jp = jm.get_model("lstm_ad").init(jax.random.PRNGKey(0), jm.make_config("lstm_ad", {}))
    for layer in jp:
        for leaf in jp[layer]:
            assert tuple(p[layer][leaf].shape) == tuple(jp[layer][leaf].shape)
            assert p[layer][leaf].dtype == torch.float32
    again = spec.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert all(torch.equal(again[k]["w"], p[k]["w"]) for k in p)
    back = tc.params_to_numpy(tc.params_from_numpy(_np_tree(jp), "cpu"))
    for layer in jp:
        for leaf in jp[layer]:
            np.testing.assert_array_equal(back[layer][leaf], np.asarray(jp[layer][leaf]))


def test_bf16_sigmoid_rounds_as_the_reference():
    """XLA lowers ``jax.nn.sigmoid`` to ``1 / (1 + exp(-x))`` as three ops, so
    with bf16 compute it rounds three times; ``torch.sigmoid`` rounds once
    and differs in the last bit on about a third of inputs. The port's
    ``sigmoid`` (both families' gates, and KS/KD on the card) rounds as the
    reference does: bitwise equal."""
    x = np.random.default_rng(12).normal(scale=3.0, size=20000).astype(np.float32)
    ref = np.asarray(jax.nn.sigmoid(jnp.asarray(x).astype(jnp.bfloat16))).astype(np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    np.testing.assert_array_equal(tc.sigmoid(xt).to(torch.float32).numpy(), ref)
    assert (torch.sigmoid(xt).to(torch.float32).numpy() != ref).mean() > 0.1
    np.testing.assert_allclose(
        tc.sigmoid(torch.from_numpy(x)).numpy(), np.asarray(jax.nn.sigmoid(jnp.asarray(x))),
        rtol=1e-6, atol=1e-7,
    )
