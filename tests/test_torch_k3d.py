"""Port parity of the attention families past their earlier caps: the
transformer's forecast over raw histories longer than KE's context mode
takes (KE's raw form), the ViT's top-k at any k and on a bf16-stored tree
(KT), and attention at head dims past 256 (KA's split form), each plain
version against ``sitewhere_tpu`` on identical numpy inputs, with one param
tree carried across as numpy.

Bars: the transformer's and the ViT's (``tests/test_fused_step.py``),
float32 2e-4 (``:144``), bfloat16 2e-2 (``:110``); the normalization's mu,
sigma and context within 2e-4 relative; attention f32 per element at rtol
1e-4 / atol 1e-5, bf16 by relative norm at 2e-2; the top-k's ids exactly
``jax.lax.top_k``'s (lower index first on ties). The forecast is fed the
reference's own noise (``tests/test_torch_transformer.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import sitewhere_tpu.models as jm
import sitewhere_tpu.models.common as jc
import sitewhere_tpu_torch.models as tm
import sitewhere_tpu_torch.models.common as tc
import sitewhere_tpu_torch.models.transformer as tt
import sitewhere_tpu_torch.models.vit as tv
from sitewhere_tpu.models import vit as jv

TOL = {"float32": 2e-4, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
CONTEXT, DIM, DEPTH, HEADS, HORIZON = 16, 32, 2, 2, 4
VIT = dict(image_size=32, patch_size=8, dim=64, depth=2, heads=2, num_classes=10)

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _rel_norm(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


# -- KE: raw histories of any length ---------------------------------------------------

def _tf_configs(dtype):
    over = {"context": CONTEXT, "dim": DIM, "depth": DEPTH, "heads": HEADS,
            "horizon": HORIZON, "dtype": dtype}
    return jm.make_config("transformer", over), tm.make_config("transformer", over)


def _history(n, length, seed):
    """n raw series of ``length`` 1 Hz points: a daily cycle around a
    per-series level, a slow drift and noise (a temperature sensor's day)."""
    rng = np.random.default_rng(seed)
    t = np.arange(length)[None]
    return (20.0 + np.arange(n)[:, None] + 4.0 * np.sin(2 * np.pi * t / 86400.0)
            + 1e-5 * t + 0.3 * rng.normal(size=(n, length))).astype(np.float32)


@pytest.mark.parametrize("length", [5000, 20001])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forecast_over_long_raw_history_matches_reference(dtype, length):
    """Raw histories past KE's context mode (4,096 values): the route
    sends them to KE's raw form; the plain normalization (mu, sigma and
    the last ``context`` values) within 2e-4 relative of the reference's
    ``normalize_windows``, and the forecast, plain and over the kernels'
    wrappers, against the reference's fed the same noise."""
    jcfg, tcfg = _tf_configs(dtype)
    assert tt.ke_raw_route(length) == "raw" and tt.ke_raw_route(tt.KE_MAX_RAW) == "context"
    wins = _history(3, length, length)
    one = jax.tree_util.tree_map(np.array, jm.get_model("transformer").init(
        jax.random.PRNGKey(1), jcfg))
    tp = tc.params_from_numpy(one, "cpu")
    jn, jmu, jsg = (np.asarray(a) for a in jc.normalize_windows(jnp.asarray(wins)))
    _, ctx, mu, sigma = tt.tf_embed_context_plain(tc.tree_map(lambda a: a[None], tp), tcfg,
                                                  raw=_t(wins))
    np.testing.assert_allclose(mu.numpy(), jmu[:, 0], rtol=2e-4)
    np.testing.assert_allclose(sigma.numpy(), jsg[:, 0], rtol=2e-4)
    np.testing.assert_allclose(ctx.numpy(), jn[:, -CONTEXT:], rtol=2e-4, atol=2e-4)
    key = jax.random.PRNGKey(7)
    j_samples, j_means = (np.asarray(x) for x in jm.transformer.forecast(
        one, jcfg, jnp.asarray(wins), key))
    keys = jax.random.split(key, HORIZON)
    eps = _t(np.stack([np.asarray(jax.random.normal(keys[i], (3,)))
                       for i in range(HORIZON)]).astype(np.float32))
    for samples, means in (tm.transformer.forecast(tp, tcfg, _t(wins), eps=eps),
                           tt._forecast(tp, tcfg, _t(wins), eps, tt.KERNEL_OPS)):
        assert samples.shape == means.shape == (3, HORIZON)
        _close(samples, j_samples, TOL[dtype])
        _close(means, j_means, TOL[dtype])


def test_ke_fault_probe_is_rejected():
    """``chip_smoke``'s KE check (ctx, mu and sigma against a float64
    normalization at 2e-4) passes the plain version and rejects a KE that
    normalizes over only the last 4,096 values."""
    raw = _t(_history(2, 9000, 3))
    cfg = tm.make_config("transformer", {"context": CONTEXT, "dim": DIM, "depth": 1,
                                         "heads": HEADS, "dtype": "float32"})
    one = tc.tree_map(lambda a: a[None], tt.init(torch.Generator().manual_seed(0), cfg, "cpu"))
    _, ctx, mu, sigma = tt.tf_embed_context_plain(one, cfg, raw=raw)
    assert chip_smoke.ke_raw_check(raw, cfg.context, ctx, mu, sigma)["ok"]
    _, fctx, fmu, fsigma = chip_smoke.ke_last_4096_fault(one, cfg, raw)
    assert not chip_smoke.ke_raw_check(raw, cfg.context, fctx, fmu, fsigma)["ok"]


# -- KT: any top-k, a bf16-stored tree --------------------------------------------------

@pytest.mark.parametrize("k", [100, 257])
def test_topk_past_64_matches_lax_top_k_on_ties(k):
    """Top-k at k 100 and k = C (257 classes) of logits with many exact
    ties: the plain top-k (KT's plain version) gives ``jax.lax.top_k``'s
    ids, lower index first on ties, and its probabilities; ``vit_head``'s
    plain version on CPU tensors the same, and k > C raises in both."""
    rng = np.random.default_rng(k)
    c = 257
    logits = rng.integers(-4, 4, size=(5, c)).astype(np.float32) / 2.0  # 16 values: ties
    jp, ji = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits), axis=-1), k)
    tp_, ti = tv.softmax_topk_plain(_t(logits), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tp_.numpy(), np.asarray(jp), rtol=1e-6)
    ties = np.asarray(jp)[:, 1:] == np.asarray(jp)[:, :-1]
    assert ties.sum() > 50 and (np.diff(np.asarray(ji), axis=1)[ties] > 0).all()
    x = rng.normal(size=(5, 3, 8)).astype(np.float32)
    head = {"w": _t(rng.normal(size=(8, c)).astype(np.float32)), "b": torch.zeros(c)}
    ln_f = {"scale": torch.ones(8), "bias": torch.zeros(8)}
    lg, probs, ids = tv.vit_head(_t(x), ln_f, head, k)
    jp2, ji2 = jax.lax.top_k(jax.nn.softmax(jnp.asarray(lg.numpy()), axis=-1), k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ji2))
    np.testing.assert_allclose(probs.numpy(), np.asarray(jp2), rtol=1e-6)
    with pytest.raises(ValueError):
        jax.lax.top_k(jnp.asarray(logits), c + 1)
    with pytest.raises(ValueError, match="top-k"):
        tv.vit_head(_t(x), ln_f, head, c + 1)


def test_kt_sort_keys_and_tie_fault():
    """KT's sort path keys: 1,024 at ViT-B/16's 1,000 classes (in shared
    memory), a scratch row past it; ``chip_smoke``'s tie-order check
    passes the plain top-k and rejects one that breaks ties higher index
    first."""
    assert tv.kt_sort_keys(768, 1000) == (1024, True)
    assert tv.kt_sort_keys(64, 30000) == (32768, False)
    logits = torch.zeros((2, 1000))
    logits[:, :100] = torch.linspace(0, 1, 100)
    logits[:, 900:] = logits[:, :100]  # pairs (c, c + 900) tie
    _, ids = tv.softmax_topk_plain(logits, 1000)
    assert chip_smoke.tie_order_ok(ids, 100, 900)
    _, bad = chip_smoke.topk_ties_high_first(logits, 1000)
    assert not chip_smoke.tie_order_ok(bad, 100, 900)


def _vit_params(cfg, seed=0):
    rng = np.random.default_rng(seed)
    p = jax.tree_util.tree_map(np.array, jv.init(jax.random.PRNGKey(seed), cfg))
    return jax.tree_util.tree_map(
        lambda x: (x + 0.05 * rng.normal(size=x.shape)).astype(np.float32) if x.ndim == 1 else x,
        p)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vit_on_bf16_tree_matches_reference(dtype):
    """The ViT's logits and top-k on a bf16-stored tree (``quantize_params``
    in both packages) against the reference on the same tree. At bf16
    compute the reference's dense rounds an f32 w to bf16, so its bf16 tree
    gives bitwise its f32 tree's logits (asserted in the reference first),
    and so does the port's."""
    jcfg, tcfg = jv.ViTConfig(**VIT, dtype=dtype), tv.ViTConfig(**VIT, dtype=dtype)
    pn = _vit_params(jcfg, 3)
    jq = jax.tree_util.tree_map(np.asarray, jc.quantize_params(
        jax.tree_util.tree_map(jnp.asarray, pn), "bf16"))
    assert jq["head"]["w"].dtype == jnp.bfloat16 and jq["cls"].dtype == np.float32
    images = np.random.default_rng(4).normal(size=(3, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jv.apply(jq, jcfg, jnp.asarray(images)))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(want, np.asarray(jv.apply(pn, jcfg, jnp.asarray(images))))
    tp = tc.params_from_numpy(pn, "cpu")
    tq = tc.quantize_params(tp, "bf16")
    assert tq["head"]["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tq["head"]["w"].float().numpy(),
                                  np.asarray(jq["head"]["w"], np.float32))
    logits, probs, ids = tv.classify(tq, tcfg, _t(images), 5)
    _close(logits.numpy(), want, TOL[dtype])
    if dtype == "bfloat16":
        assert torch.equal(logits, tv.apply(tp, tcfg, _t(images)))
    jp, ji = jax.lax.top_k(jax.nn.softmax(jnp.asarray(want), axis=-1), 5)
    rec = chip_smoke.topk_agreement(probs.numpy(), ids.numpy(), np.asarray(jp), np.asarray(ji),
                                    np.asarray(jax.nn.softmax(want, axis=-1)), TOL[dtype])
    assert rec["ok"], rec


def test_int8_vit_tree_raises_in_both():
    """An int8 tree (``qw`` and ``scale``, no ``w``): the reference's
    ``dense`` reads ``p["w"]`` and fails; the port refuses it on any device
    with a message that names that limit, and its train form refuses a
    bf16 tree (it differentiates f32 masters)."""
    jcfg, tcfg = jv.ViTConfig(**VIT), tv.ViTConfig(**VIT)
    pn = _vit_params(jcfg)
    images = np.zeros((1, 32, 32, 3), np.float32)
    jq = jc.quantize_params(jax.tree_util.tree_map(jnp.asarray, pn), "int8")
    with pytest.raises(KeyError):
        jv.apply(jq, jcfg, jnp.asarray(images))
    tq = tc.quantize_params(tc.params_from_numpy(pn, "cpu"), "int8")
    with pytest.raises(NotImplementedError, match="common.py:31-34"):
        tv.apply(tq, tcfg, _t(images))
    with pytest.raises(NotImplementedError, match="common.py:31-34"):
        tv.classify(tq, tcfg, _t(images).to(torch.uint8), 5)
    assert tv.TRAIN_MASTERS and "vit.py:127" in tv.TRAIN_MASTERS


# -- KA: head dims past 256 ---------------------------------------------------------------

@pytest.mark.parametrize("hd, t, causal", [(288, 9, True), (300, 7, False)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_plain_wide_heads_match_reference(dtype, hd, t, causal):
    """``attention_plain`` at head dims 288 and 300, forward, its plain
    backward and torch's autograd through it, against ``attn_core`` and its
    ``jax.vjp``: f32 per element at rtol 1e-4 / atol 1e-5 (the backward's
    atol scaled by the gradient's size), bf16 by relative norm at 2e-2.
    The wrappers route these head dims to the split form and take the
    plain versions on CPU tensors."""
    jdt, tdt = DTYPES[dtype]
    n, heads = 2, 2 if hd == 288 else 1
    assert tc.attn_route(False, tdt, hd, t) == tc.attn_route(True, tdt, hd, t) == "split"
    rng = np.random.default_rng(hd + t)
    q, k, v, do = (rng.normal(size=(n, t, heads * hd)).astype(np.float32) for _ in range(4))

    def split(a):
        return jnp.asarray(a).astype(jdt).reshape(n, t, heads, hd)

    want, vjp = jax.vjp(lambda a, b, c: jc.attn_core(a, b, c, causal, jdt),
                        split(q), split(k), split(v))
    jgrads = [np.asarray(g.astype(jnp.float32)).reshape(n, t, heads * hd)
              for g in vjp(jnp.asarray(do).astype(jdt).reshape(n, t, heads * hd))]
    want = np.asarray(want.astype(jnp.float32))
    tq, tk, tv_, tdo = (_t(a).to(tdt) for a in (q, k, v, do))
    got = tc.attention_plain(tq, tk, tv_, heads, causal)
    plain_grads = tc.attention_bwd_plain(tq, tk, tv_, tdo, heads, causal)
    leaves = [a.clone().requires_grad_(True) for a in (tq, tk, tv_)]
    auto = torch.autograd.grad(tc.attention_plain(*leaves, heads, causal), leaves, tdo)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
        for grads in (plain_grads, auto):
            for g, w in zip(grads, jgrads):
                scale = max(1.0, float(np.abs(w).max()))
                np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-5 * scale)
    else:
        assert _rel_norm(got.float(), want) <= 2e-2
        for grads in (plain_grads, auto):
            for g, w in zip(grads, jgrads):
                assert _rel_norm(g.float(), w) <= 2e-2
    assert torch.equal(tc.attention(tq, tk, tv_, heads, causal), got)
    assert torch.equal(tc.attention_split(tq, tk, tv_, heads, causal), got)
    for a, b in zip(tc.attention_bwd(tq, tk, tv_, tdo, heads, causal), plain_grads):
        assert torch.equal(a, b)


def test_attention_own_columns_fault_is_rejected():
    """``chip_smoke``'s injected fault of the split form (each column
    chunk's logits from its own columns of q and k only) is rejected by
    its f32 bar (2e-4 against float64), which the plain version meets."""
    rng = np.random.default_rng(5)
    q, k, v = (_t(rng.normal(size=(2, 9, 512)).astype(np.float32)) for _ in range(3))
    want = tc.attention_plain(q.double(), k.double(), v.double(), 1, True)
    assert float((tc.attention_plain(q, k, v, 1, True).double() - want).abs().max()) <= 2e-4
    bad = chip_smoke.attention_own_columns_fault(q, k, v, 1, True)
    assert bad.shape == q.shape
    assert float((bad.double() - want).abs().max()) > 2e-4
