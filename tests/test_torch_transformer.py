"""Port parity: the transformer forecaster (``sitewhere_tpu_torch.models.
transformer`` and the block math of ``models/common.py``; the plain versions
of kernels KE, KL, KA, KU and KN) against ``sitewhere_tpu.models`` on
identical numpy inputs and one param tree carried across as numpy.

The port's stacked paths are one composition each (``_blocks`` inside
``_score_stacked``, ``_tf_score``, ``_forecast``), over the kernels'
wrappers (``KERNEL_OPS``, which on CPU tensors run each kernel's plain
version at the kernel's layout: KL/KU over rows, KA over [N, T, D], KE/KN
around them) or the plain versions themselves (``PLAIN_OPS``, the
``*_plain`` entry points and the card's plain twin); the block math of
``models/common.py`` (``transformer_block_stacked``) is held on its own.

Bars are the reference's transformer bars (``tests/test_fused_step.py``):
float32 compute 2e-4 (``:144``), bfloat16 compute 2e-2 (``:110``). The
forecast is fed the reference's own noise: the draws it makes (``keys =
jax.random.split(key, horizon)``, ``jax.random.normal(keys[t], (B,))``)
are made here in numpy and handed to the port as ``eps``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sitewhere_tpu.models as jm
import sitewhere_tpu.models.common as jc
import sitewhere_tpu_torch.models as tm
import sitewhere_tpu_torch.models.common as tc
import sitewhere_tpu_torch.models.transformer as tt

TOL = {"float32": 2e-4, "bfloat16": 2e-2}
S, B, W = 3, 16, 12
CONTEXT, DIM, DEPTH, HEADS, HORIZON = 16, 32, 2, 2, 4
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}

# tiny tensors: one intra-op thread, so the suite's parallel workers keep
# their cores
torch.set_num_threads(1)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)  # writable copies


def _configs(dtype):
    over = {"context": CONTEXT, "dim": DIM, "depth": DEPTH, "heads": HEADS,
            "horizon": HORIZON, "dtype": dtype}
    return jm.make_config("transformer", over), tm.make_config("transformer", over)


def _params_np(seed, rng, sigma_bias=0.0):
    """A JAX transformer tree as numpy, with non-zero biases and LayerNorm
    scales off 1 so every bias and affine path is exercised, and
    ``sigma_bias`` added to the head's raw-sigma bias."""
    jcfg, _ = _configs("float32")
    p = _np_tree(jm.get_model("transformer").init(jax.random.PRNGKey(seed), jcfg))

    def jiggle(path, x):
        name = jax.tree_util.keystr(path)
        if name.endswith("['b']") or name.endswith("['bias']"):
            return rng.normal(scale=0.1, size=x.shape).astype(np.float32)
        if name.endswith("['scale']"):
            return (1.0 + rng.normal(scale=0.1, size=x.shape)).astype(np.float32)
        return x

    p = jax.tree_util.tree_map_with_path(jiggle, p)
    p["head"]["b"][1] += sigma_bias
    return p


def _stacked_np(rng):
    """Slot 2 scores the predictable series of ``_windows`` with a small
    sigma (raw bias near -2, sigma ~0.13) and a mu head held at the clean
    sine's newest normalized value, so its NLL scores go negative."""
    trees = [_params_np(i, rng, -2.0 if i == 2 else 0.0) for i in range(S)]
    sine = np.sin(np.arange(W) / 2.0)
    trees[2]["head"]["w"][:, 0] = 0.0
    trees[2]["head"]["b"][0] = (sine[-1] - sine.mean()) / sine.std()
    return jax.tree_util.tree_map(lambda *xs: np.stack(xs), *trees)


def _windows(rng):
    wins = rng.normal(size=(S, B, W)).astype(np.float32)
    wins[1] = np.cumsum(wins[1], -1)  # a drifting series too
    wins[2] = np.sin(np.arange(W) / 2.0)[None] + 0.05 * wins[2]  # a predictable one
    nv = np.full((S, B), W, np.int32)
    nv[0, :3] = [0, 3, 5]  # cold starts around the 4-sample gate
    return wins, nv


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_stacked_matches_reference(dtype):
    """``layernorm_stacked`` and KL's plain version over rows, per-slot
    scale/bias."""
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(40)
    x = (rng.normal(size=(S, 5, 7, DIM)) * 3 + 1).astype(np.float32)
    p = {"scale": (1 + 0.2 * rng.normal(size=(S, DIM))).astype(np.float32),
         "bias": (0.1 * rng.normal(size=(S, DIM))).astype(np.float32)}
    want = np.asarray(jc.layernorm_stacked(p, jnp.asarray(x).astype(jd))).astype(np.float32)
    xt = _t(x).to(td)
    got = tc.layernorm_stacked(tc.params_from_numpy(p, "cpu"), xt)
    assert got.dtype == td
    _close(got.float(), want, TOL[dtype])
    rows = tc.layernorm_rows(xt.reshape(-1, DIM), _t(p["scale"]), _t(p["bias"]), 35)
    assert torch.equal(rows.reshape(got.shape), got)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attn_core_matches_reference(dtype, causal):
    """``attn_core`` on [S, B, T, H, hd], and KA's plain version on the
    projections' [N, T, D] layout."""
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(41)
    q, k, v = (rng.normal(size=(S, 4, 11, HEADS, DIM // HEADS)).astype(np.float32) * 2
               for _ in range(3))
    want = np.asarray(jc.attn_core(*(jnp.asarray(a).astype(jd) for a in (q, k, v)),
                                   causal, jd)).astype(np.float32)
    qt, kt, vt = (_t(a).to(td) for a in (q, k, v))
    got = tc.attn_core(qt, kt, vt, causal, td)
    assert got.shape == (S, 4, 11, DIM) and got.dtype == td
    _close(got.float(), want, TOL[dtype])
    flat = tc.attention(*(a.reshape(S * 4, 11, DIM) for a in (qt, kt, vt)), HEADS, causal)
    assert torch.equal(flat.reshape(got.shape), got)


def test_bf16_gelu_rounds_as_the_reference():
    """XLA lowers ``jax.nn.gelu`` (tanh form) op by op, each op rounded in
    bf16, with the constants cast to bf16 and ``x**3`` as ``(x*x)*x``; the
    port's ``gelu`` does the same. Over every finite bf16 input (65,280
    values) it is bitwise equal to ``jax.jit(jax.nn.gelu)`` wherever the
    reference's output is not 0: the 508 inputs that differ (|x| < 2.4e-38)
    have a subnormal product in f32, which XLA's CPU flushes to 0 and the
    port rounds to a bf16 of at most the smallest normal.
    On 200,000 draws of N(0,1)*3 it is bitwise equal (0 of 200,000 differ),
    where ``F.gelu(x, approximate="tanh")`` differs on over 40%."""
    bits = np.arange(65536, dtype=np.uint32) << 16
    f = bits.view(np.float32)
    f = f[np.isfinite(f)]
    ref = np.asarray(jax.jit(jax.nn.gelu)(jnp.asarray(f).astype(jnp.bfloat16))).astype(np.float32)
    got = tc.gelu(_t(f).to(torch.bfloat16)).float().numpy()
    differ = got != ref
    assert differ.sum() == 508
    assert np.all(ref[differ] == 0.0) and np.all(np.abs(got[differ]) <= np.finfo(np.float32).tiny)
    x = (np.random.default_rng(42).normal(size=200_000) * 3).astype(np.float32)
    ref = np.asarray(jax.jit(jax.nn.gelu)(jnp.asarray(x).astype(jnp.bfloat16))).astype(np.float32)
    xb = _t(x).to(torch.bfloat16)
    assert (tc.gelu(xb).float().numpy() != ref).sum() == 0
    lib = torch.nn.functional.gelu(xb, approximate="tanh").float().numpy()
    assert (lib != ref).mean() > 0.4
    # f32 compute: the same formula in f32, within reassociation noise
    np.testing.assert_allclose(tc.gelu(_t(x)).numpy(), np.asarray(jax.nn.gelu(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_transformer_block_stacked_matches_reference(dtype):
    """One stacked block, plain, and the kernel path's ``_blocks`` (KL,
    KA, KU at their layouts) over the same block."""
    jd, td = DTYPES[dtype]
    jcfg, tcfg = _configs(dtype)
    rng = np.random.default_rng(43)
    stacked = _stacked_np(rng)
    blk = stacked["blocks"][0]
    x = rng.normal(size=(S, 5, 11, DIM)).astype(np.float32)
    want = np.asarray(jc.transformer_block_stacked(
        blk, jnp.asarray(x).astype(jd), HEADS, causal=True, dtype=jd)).astype(np.float32)
    tblk = tc.params_from_numpy(blk, "cpu")
    got = tc.transformer_block_stacked(tblk, _t(x).to(td), HEADS, causal=True, dtype=td)
    _close(got.float(), want, TOL[dtype])
    one = {"blocks": [tblk]}
    _close(tt._blocks(one, _t(x).to(td), tcfg).float(), want, TOL[dtype])
    fc1 = tblk["mlp"]["fc1"]
    h = _t(x).to(td).reshape(S, 55, DIM)
    prod = torch.bmm(h, fc1["w"].to(td))
    np.testing.assert_array_equal(
        tc.bias_gelu(prod.reshape(S * 55, -1), fc1["b"], 55).float().numpy(),
        tc.gelu(prod + fc1["b"].to(td)[:, None]).reshape(S * 55, -1).float().numpy())


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_score_stacked_matches_reference(dtype, k):
    jcfg, tcfg = _configs(dtype)
    rng = np.random.default_rng(44)
    stacked = _stacked_np(rng)
    wins, nv = _windows(rng)
    js = np.asarray(jm.transformer.score_stacked(stacked, jcfg, jnp.asarray(wins),
                                                 jnp.asarray(nv), k=k))
    tp = tc.params_from_numpy(stacked, "cpu")
    ts = tm.transformer.score_stacked(tp, tcfg, _t(wins), _t(nv), k=k).numpy()
    assert ts.shape == js.shape == (S, B, k)
    _close(ts, js, TOL[dtype])
    np.testing.assert_array_equal(ts == 0.0, js == 0.0)  # same cold-start mask
    assert (ts < 0).any() and (ts > 0).any()  # NLL scores of both signs
    # the kernel path's composition (KE, blocks, KN at their layouts)
    _close(tt._score_stacked(tp, tcfg, _t(wins), _t(nv), k, tt.KERNEL_OPS).numpy(), js,
           TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_score_legacy_matches_reference(dtype):
    jcfg, tcfg = _configs(dtype)
    rng = np.random.default_rng(45)
    one = _params_np(0, rng)
    wins, nv = _windows(rng)
    wins, nv = wins.reshape(S * B, W), nv.reshape(S * B)
    js = np.asarray(jm.transformer.score(one, jcfg, jnp.asarray(wins), jnp.asarray(nv)))
    ts = tm.transformer.score(tc.params_from_numpy(one, "cpu"), tcfg, _t(wins), _t(nv)).numpy()
    _close(ts, js, TOL[dtype])
    assert np.all(ts[:2] == 0.0) and np.any(ts != 0.0)


@pytest.mark.parametrize("param_dtype", ["bf16", "int8"])
def test_quantized_params_match_reference(param_dtype):
    """Weight storage variants through the plain path: the same
    ``quantize_params`` tree (raw ``pos`` and LayerNorm nodes pass
    through) on both sides, f32 compute."""
    jcfg, tcfg = _configs("float32")
    rng = np.random.default_rng(46)
    stacked = _stacked_np(rng)
    jq = jc.quantize_params(jax.tree_util.tree_map(jnp.asarray, stacked), param_dtype)
    tq = tc.quantize_params(tc.params_from_numpy(stacked, "cpu"), param_dtype)
    assert tq["pos"].dtype == torch.float32 and set(tq["blocks"][0]["ln1"]) == {"scale", "bias"}
    if param_dtype == "int8":
        np.testing.assert_array_equal(tq["blocks"][1]["mlp"]["fc1"]["qw"].numpy(),
                                      np.asarray(jq["blocks"][1]["mlp"]["fc1"]["qw"]))
    wins, nv = _windows(rng)
    js = np.asarray(jm.transformer.score_stacked(jq, jcfg, jnp.asarray(wins), jnp.asarray(nv)))
    ts = tm.transformer.score_stacked(tq, tcfg, _t(wins), _t(nv)).numpy()
    _close(ts, js, TOL["float32"])


def _jax_noise(key, n_series):
    keys = jax.random.split(key, HORIZON)
    return np.stack([np.asarray(jax.random.normal(keys[t], (n_series,)))
                     for t in range(HORIZON)]).astype(np.float32)


@pytest.mark.parametrize("length", [20, 10])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forecast_matches_reference_on_its_noise(dtype, length):
    """Raw windows longer than the context (trimmed to its last 16) and
    shorter (left-padded): the plain forecast and the kernel path's
    composition (KE context modes, the blocks, KN forecast mode with its
    ping-pong context) against the reference fed the same noise."""
    jcfg, tcfg = _configs(dtype)
    rng = np.random.default_rng(47)
    one = _params_np(1, rng)
    n = 5
    wins = (2.0 + np.sin(np.arange(length)[None] / 3.0 + np.arange(n)[:, None])
            + 0.1 * rng.normal(size=(n, length))).astype(np.float32)
    key = jax.random.PRNGKey(7)
    j_samples, j_means = (np.asarray(x) for x in jm.transformer.forecast(
        one, jcfg, jnp.asarray(wins), key))
    eps = _t(_jax_noise(key, n))
    tp = tc.params_from_numpy(one, "cpu")
    t_samples, t_means = tm.transformer.forecast(tp, tcfg, _t(wins), eps=eps)
    assert t_samples.shape == j_samples.shape == t_means.shape == (n, HORIZON)
    tol = TOL[dtype]
    _close(t_samples, j_samples, tol)
    _close(t_means, j_means, tol)
    k_samples, k_means = tt._forecast(tp, tcfg, _t(wins), eps, tt.KERNEL_OPS)
    _close(k_samples, j_samples, tol)
    _close(k_means, j_means, tol)
    other, _ = tm.transformer.forecast(tp, tcfg, _t(wins), generator=torch.Generator().manual_seed(0))
    assert other.shape == (n, HORIZON) and not np.allclose(other.numpy(), t_samples.numpy())
    with pytest.raises(ValueError, match="exactly one"):
        tm.transformer.forecast(tp, tcfg, _t(wins))


def test_one_sample_window_normalizes_to_noise_in_the_reference():
    """A stream with one sample has a constant (left-padded) window, so
    ``(x - mean) / (std + 1e-6)`` is the mean's rounding residue over
    1e-6: noise that differs with the summation order. Over 1,000 such
    windows of 32 (values N(0,1)), the reference (XLA's CPU, a running
    sum) leaves 851 rows nonzero (values up to 0.54) and the port's plain
    version (torch's tree sum) 450 (up to 0.24). These rows score 0
    (fewer than 4 samples), so KE's checks hold the other rows' tokens
    (ROADMAP queue 3)."""
    v = np.random.default_rng(48).normal(size=(1000, 1)).astype(np.float32)
    w = np.repeat(v, 32, axis=1)
    ref = np.asarray(jc.normalize_windows(jnp.asarray(w))[0])
    got = tc.normalize_windows(_t(w))[0].numpy()
    assert (np.abs(ref).max(1) > 0).sum() > 100 and (np.abs(got).max(1) > 0).sum() > 100
    assert not np.array_equal(ref != 0, got != 0)
    np.testing.assert_array_equal(ref.std(1), np.zeros(1000, np.float32))  # constant noise


def test_flop_accounting_matches_reference():
    for dim, seq in [(128, 31), (768, 197), (16, 11)]:
        assert tc.transformer_block_flops(dim, seq) == jc.transformer_block_flops(dim, seq)
    cfg, jcfg = tm.make_config("transformer", {}), jm.make_config("transformer", {})
    for w, k, pd in [(32, None, "f32"), (32, 1, "f32"), (32, 3, "int8"), (12, 99, "bf16")]:
        assert tc.transformer_flops_per_row(cfg, w, k=k, param_dtype=pd) == \
            jc.transformer_flops_per_row(jcfg, w, k=k, param_dtype=pd)
    assert tc.transformer_flops_per_row(cfg, 32, k=1) == 50735360.0
    assert tm.get_model("transformer").flops_per_row is tc.transformer_flops_per_row


def test_registry_init_and_param_round_trip():
    spec, jspec = tm.get_model("transformer"), jm.get_model("transformer")
    assert spec.score_stacked is tt.score_stacked and spec.score is tt.score
    assert spec.score_flush is tt.tf_score and spec.score_flush_plain is tt.tf_score_plain
    assert spec.forecast is tt.forecast and spec.score_range == jspec.score_range
    cfg = tm.make_config("transformer", {"context": 128, "bogus": 1})
    assert (cfg.context, cfg.horizon, cfg.dim, cfg.depth, cfg.heads, cfg.dtype) == \
        (128, 24, 128, 4, 4, "bfloat16")
    p = spec.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    jp = _np_tree(jspec.init(jax.random.PRNGKey(0), jm.make_config("transformer", {"context": 128})))
    jleaves, jdef = jax.tree_util.tree_flatten(jp)
    tleaves, tdef = jax.tree_util.tree_flatten(p)
    assert jdef == tdef  # embed, raw pos, blocks[i].{ln1, attn.{wq..wo}, ln2, mlp}, ln_f, head
    for a, b in zip(jleaves, tleaves):
        assert tuple(b.shape) == a.shape and b.dtype == torch.float32
    assert abs(float(p["pos"].std()) - float(jp["pos"].std())) < 0.002  # 0.02 scale
    again = spec.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert torch.equal(again["blocks"][3]["mlp"]["fc2"]["w"], p["blocks"][3]["mlp"]["fc2"]["w"])
    for tree in (jp, jax.tree_util.tree_map(lambda *xs: np.stack(xs), jp, jp)):
        back = tc.params_to_numpy(tc.params_from_numpy(tree, "cpu"))
        for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(back)):
            np.testing.assert_array_equal(a, b)
