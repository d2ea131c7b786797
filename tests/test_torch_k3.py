"""Port parity of the recurrent families at every width and weight format
their tenants use: hidden 8, 16 and 32 (64 is the other files' width) and
f32, bf16 and int8 serving weights, the plain versions of KS, KD, KF, KB
and KR on the CPU against the JAX package on the same numpy inputs.

Bars, each the reference's own or stated here:

- ``score_stacked``: f32 compute 2e-4 (``tests/test_fused_step.py:138``),
  bf16 compute 2e-2; the port quantizes its own tree, held bitwise against
  the reference's ``quantize_params`` of the same masters;
- the scorer at config 8's shape (hidden 16, window 16, int8, one slot of
  1,024 streams): the wire's bar with f32 compute (5e-5), 2e-2 with bf16
  compute; every stream takes the same number of rows a flush (the
  reference's ``_segment_ranks`` fault, ROADMAP queue 3);
- ``loss_stacked`` gradients: f32 per element at rtol 1e-4 / atol 1e-5
  (``tests/test_train_lane.py:119-124``); bf16 by each leaf's relative-norm
  error against the reference's f32 gradient at 2e-2;
- the DeepAR forecast on the reference's own noise: 5e-5 (f32), 2e-2
  (bf16), as ``tests/test_torch_deepar.py`` holds hidden 16;
- Adam's bias corrections: bitwise over counts 1..200,000.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sitewhere_tpu.models as jm
import sitewhere_tpu.models.common as jc
import sitewhere_tpu.parallel.sharded as js
import sitewhere_tpu_torch.models as tm
import sitewhere_tpu_torch.models.common as tc
from sitewhere_tpu.parallel.mesh import MeshManager as JMesh
from sitewhere_tpu_torch.models import flush as tflush
from sitewhere_tpu_torch.models import train as ttrain
from sitewhere_tpu_torch.ops import adam
from sitewhere_tpu_torch.parallel.mesh import MeshManager
from sitewhere_tpu_torch.parallel.sharded import ShardedScorer

FAMILIES = ("lstm_ad", "deepar")
WIDTHS = (8, 16, 32)
PARAM_DTYPES = ("f32", "bf16", "int8")
SCORE_TOL = {"float32": 2e-4, "bfloat16": 2e-2}
S, B, W = 3, 8, 12

# tiny tensors: one intra-op thread, so the suite's parallel workers keep
# their cores
torch.set_num_threads(1)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _configs(family, dtype, hidden, window=W):
    over = {"window": window, "hidden": hidden, "dtype": dtype}
    return jm.make_config(family, over), tm.make_config(family, over)


def _stacked(family, hidden, seed=0, n=S, window=W):
    """n per-slot JAX param trees with non-zero biases, stacked, as numpy
    (DeepAR's sigma bias near -1, so sigma ranges over ~0.1..1)."""
    jcfg, _ = _configs(family, "float32", hidden, window)
    rng = np.random.default_rng(200 + seed)
    trees = []
    for i in range(n):
        p = _np_tree(jm.get_model(family).init(jax.random.PRNGKey(10 * seed + i), jcfg))
        for layer in p.values():
            layer["b"] = rng.normal(scale=0.1, size=layer["b"].shape).astype(np.float32)
        if family == "deepar":
            p["sigma"]["b"] -= 1.0
        trees.append(p)
    return jax.tree_util.tree_map(lambda *xs: np.stack(xs), *trees)


def _windows(seed, n=S, b=B, window=W):
    rng = np.random.default_rng(seed)
    wins = rng.normal(size=(n, b, window)).astype(np.float32)
    wins[-1] = np.cumsum(wins[-1], -1)  # a drifting series too
    nv = np.full((n, b), window, np.int32)
    nv[0, :3] = [0, 3, 5]  # cold starts around the 4-sample gate
    return wins, nv


def _leaves_equal(got, want):
    """A port tree (tensors) bitwise a reference tree (numpy), same keys."""
    assert jax.tree_util.tree_structure(tc.params_to_numpy(got)) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(tc.params_to_numpy(got)),
                    jax.tree_util.tree_leaves(want)):
        b = np.asarray(b)
        if b.dtype.name == "bfloat16":
            b = b.astype(np.float32)
            a = a.astype(np.float32)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@functools.lru_cache(maxsize=None)
def _jit_score(family):
    return jax.jit(jm.get_model(family).score_stacked, static_argnums=(1, 4))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("param_dtype", PARAM_DTYPES)
@pytest.mark.parametrize("hidden", WIDTHS)
@pytest.mark.parametrize("family", FAMILIES)
def test_score_stacked_matches_reference(family, hidden, param_dtype, dtype):
    """KS's and KD's plain version at hidden 8, 16, 32 on the tree the
    scorer serves (``quantize_params`` of the masters): K = 3 against the
    reference's, and K = 1 against its newest column."""
    jcfg, tcfg = _configs(family, dtype, hidden)
    stacked = _stacked(family, hidden)
    jq = jc.quantize_params(jax.tree_util.tree_map(jnp.asarray, stacked), param_dtype)
    tq = tc.quantize_params(tc.params_from_numpy(stacked, "cpu"), param_dtype)
    assert tflush.weight_format(tq) == param_dtype
    wins, nv = _windows(7 + hidden)
    want = np.asarray(_jit_score(family)(jq, jcfg, jnp.asarray(wins), jnp.asarray(nv), 3))
    spec = tm.get_model(family)
    tol = SCORE_TOL[dtype]
    for k in (3, 1):
        got = spec.score_stacked(tq, tcfg, torch.from_numpy(wins), torch.from_numpy(nv), k=k)
        assert tuple(got.shape) == (S, B, k)
        np.testing.assert_allclose(got.numpy(), want[..., 3 - k:], rtol=tol, atol=tol)
        np.testing.assert_array_equal(got.numpy() == 0.0, want[..., 3 - k:] == 0.0)
    assert np.any(want != 0.0)


@pytest.mark.parametrize("hidden", WIDTHS)
@pytest.mark.parametrize("family", FAMILIES)
def test_quantize_params_bitwise_and_carry_across(family, hidden):
    """The port's ``quantize_params`` bitwise the reference's on the same
    masters, in both forms; the reference's quantized tree carries across
    through ``params_from_numpy`` (int8 ``qw``, f32 ``scale``, bf16 ``w``)
    equal to the port's own; ``kernel_weight`` (the dequant) bitwise."""
    stacked = _stacked(family, hidden, seed=1)
    masters = tc.params_from_numpy(stacked, "cpu")
    for pd in ("bf16", "int8"):
        jq = _np_tree(jc.quantize_params(jax.tree_util.tree_map(jnp.asarray, stacked), pd))
        tq = tc.quantize_params(masters, pd)
        _leaves_equal(tq, jq)
        _leaves_equal(tc.params_from_numpy(jq, "cpu"), jq)
        for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
            got = tc.kernel_weight(tq["wh"], dtype).to(torch.float32).numpy()
            want = np.asarray(jc.kernel_weight(jax.tree_util.tree_map(jnp.asarray, jq["wh"]),
                                               jdtype).astype(jnp.float32))
            np.testing.assert_array_equal(got, want)
        assert tc.kernel_shape(tq["wh"]) == tuple(jc.kernel_shape(jq["wh"])) == \
            (S, hidden, (4 if family == "lstm_ad" else 3) * hidden)


def test_quantize_dense_rounding_rules():
    """``quantize_dense``'s three rules against the reference's on chosen
    values: halves round to even (``torch.round`` as ``jnp.round``), an
    all-zero channel takes the 1e-12 scale floor, the clip to +-127."""
    w = np.zeros((2, 4, 3), np.float32)
    w[0, :, 0] = [127.0, 0.5, 1.5, -2.5]    # scale 1: q = 127, 0, 2, -2
    w[0, :, 1] = [63.5, -127.0, 126.5, 0.0]  # scale 1: 64, -127, 126, 0
    w[1, :, 0] = [1e-3, -3e-3, 2e-3, 0.0]
    # column (1, :, 1) stays zero: scale 1e-12, q 0; (1, :, 2) a tiny range
    w[1, :, 2] = [1e-30, 0.0, -1e-30, 0.0]
    p = {"w": w, "b": np.zeros((2, 3), np.float32)}
    jq = _np_tree(jc.quantize_dense(jax.tree_util.tree_map(jnp.asarray, p), "int8"))
    tq = tc.quantize_dense(tc.params_from_numpy(p, "cpu"), "int8")
    _leaves_equal(tq, jq)
    np.testing.assert_array_equal(tq["qw"][0, :, 0].numpy(), [127, 0, 2, -2])
    np.testing.assert_array_equal(tq["qw"][0, :, 1].numpy(), [64, -127, 126, 0])
    assert float(tq["scale"][1, 0, 1]) == np.float32(1e-12)
    assert not tq["qw"][1, :, 1].any()
    assert int(tq["qw"].abs().max()) == 127


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", FAMILIES)
def test_lstm_score_card_route_matches_reference(family, dtype):
    """The legacy per-tenant ``score`` on the card is ``score_stacked`` over
    one slot, column K-1 (KS or KD in windows mode): that composition's
    plain version against the reference's legacy ``score`` at hidden 16,
    f32 5e-5 and bf16 2e-2, and the CPU route beside it."""
    hidden, window = 16, 16
    jcfg, tcfg = _configs(family, dtype, hidden, window)
    one = jax.tree_util.tree_map(lambda x: x[0], _stacked(family, hidden, seed=2,
                                                          window=window))
    wins, nv = _windows(9, n=1, b=12, window=window)
    want = np.asarray(jm.get_model(family).score(one, jcfg, jnp.asarray(wins[0]),
                                                 jnp.asarray(nv[0])))
    spec = tm.get_model(family)
    params = tc.params_from_numpy(one, "cpu")
    stacked = tc.tree_map(lambda x: x[None], params)
    card = spec.score_stacked(stacked, tcfg, torch.from_numpy(wins),
                              torch.from_numpy(nv))[0, :, 0].numpy()
    cpu = spec.score(params, tcfg, torch.from_numpy(wins[0]), torch.from_numpy(nv[0])).numpy()
    tol = {"float32": 5e-5, "bfloat16": 2e-2}[dtype]
    for got in (card, cpu):
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    assert np.all(card[:2] == 0.0) and np.any(card != 0.0)


# -- the scorer at config 8's shape -------------------------------------------

C8_HIDDEN, C8_WINDOW, C8_STREAMS, C8_LANE, C8_POOL = 16, 16, 1024, 256, 128


def _c8_flush(rng, ids_dtype):
    """One full lane: each of 128 streams (of the first 1024) twice, in a
    random order, so every stream's run is 2 rows (equal runs)."""
    streams = rng.choice(C8_STREAMS, C8_POOL, replace=False)
    ids = rng.permutation(np.repeat(streams, 2)).astype(ids_dtype)[None]
    vals = rng.normal(size=(1, C8_LANE)).astype(np.float32)
    return ids, vals, np.full((1, 1), C8_LANE, np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scorer_config8_int8_matches_reference(dtype):
    """Config 8's serving shape (``bench.py:1706-1707``): one LSTM-AD slot
    of 1,024 streams, hidden 16, window 16, int8 serving weights, lanes of
    256 rows. The port's plain scorer against the reference's over 8
    flushes: window state bitwise, scores at the bar, ``flops_per_flush``
    equal (int8 MACs at ``quant_mac_width``). Then the train lane: a step
    leaves the int8 view as it was, ``commit_swap`` re-derives it from the
    trained masters."""
    jcfg, tcfg = _configs("lstm_ad", dtype, C8_HIDDEN, C8_WINDOW)
    jsc = js.ShardedScorer(
        JMesh(tenant=1, data=1, devices=jax.devices()[:1]), jm.get_model("lstm_ad"), jcfg,
        slots_per_shard=1, max_streams=C8_STREAMS, window=C8_WINDOW, param_dtype="int8")
    tsc = ShardedScorer(
        MeshManager(device="cpu"), tm.get_model("lstm_ad"), tcfg, slots_per_shard=1,
        max_streams=C8_STREAMS, window=C8_WINDOW, param_dtype="int8",
        base_params=_np_tree(jsc._base_params))
    for sc in (jsc, tsc):
        sc.activate(0, trainable=True, lr=1e-3)
    # the int8 views: q equal; the scales within one ulp (the reference's
    # jitted derive multiplies by 1/127 where its quantize_params, which
    # the port's is bitwise, divides by 127)
    mine, theirs = tc.params_to_numpy(tsc.kernel_params()), _np_tree(jsc.kernel_params())
    for layer in mine:
        np.testing.assert_array_equal(mine[layer]["qw"], theirs[layer]["qw"])
        np.testing.assert_allclose(mine[layer]["scale"], theirs[layer]["scale"], rtol=1.2e-7,
                                   atol=0)
    tol = {"float32": 5e-5, "bfloat16": 2e-2}[dtype]
    rng = np.random.default_rng(81)
    for _ in range(8):
        ids, vals, counts = _c8_flush(rng, tsc.ids_np_dtype)
        want = np.asarray(jsc.step_counts(*jsc.stage_inputs(ids, vals, counts)))
        got = tsc.step_counts(*tsc.stage_inputs(ids, vals, counts)).numpy_f32()
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
        for a, b in zip(tsc.state, jsc.state):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert np.any(got != 0.0)
    assert tsc.flops_per_flush(C8_LANE) == jsc.flops_per_flush(C8_LANE)
    assert tsc.flops_per_row() == tc.lstm_ad_flops_per_row(tcfg, C8_WINDOW, k=1,
                                                           param_dtype="int8")
    # the train lane on the f32 masters; the view moves at commit_swap
    before = tc.tree_map(torch.clone, tsc.kernel_params())
    tsc.init_optimizer()
    loss = np.asarray(tsc.train_lane_step())
    assert loss[0] > 0.0
    _leaves_equal(tsc.kernel_params(), tc.params_to_numpy(before))
    tsc.commit_swap()
    after = tsc.kernel_params()
    _leaves_equal(after, tc.params_to_numpy(tc.quantize_params(tsc.params, "int8")))
    assert not torch.equal(after["wh"]["scale"], before["wh"]["scale"])


# -- the train form at the new widths ------------------------------------------

GRAD_B, GRAD_W = 48, 16


def _grad_plane(seed):
    rng = np.random.default_rng(seed)
    wins = np.cumsum(rng.normal(size=(S, GRAD_B, GRAD_W)), -1).astype(np.float32)
    mask = (rng.random((S, GRAD_B)) < 0.8).astype(np.float32)
    mask[1] = 0.0
    return wins, mask


@functools.lru_cache(maxsize=None)
def _jax_grad(family, hidden, dtype):
    """The reference's gradient of the masked per-slot mean of its
    ``loss_stacked`` (cached: the bf16 cases reuse the f32 one)."""
    jcfg, _ = _configs(family, dtype, hidden, GRAD_W)
    stacked = _stacked(family, hidden, seed=3, window=GRAD_W)
    wins, mask = _grad_plane(hidden)
    spec = jm.get_model(family)

    def obj(p):
        per_row = spec.loss_stacked(p, jcfg, jnp.asarray(wins))
        m = jnp.asarray(mask)
        return ((per_row * m).sum(-1) / jnp.maximum(m.sum(-1), 1.0)).sum()

    return _np_tree(jax.jit(jax.grad(obj))(jax.tree_util.tree_map(jnp.asarray, stacked)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hidden", WIDTHS)
@pytest.mark.parametrize("family", FAMILIES)
def test_loss_stacked_gradients_at_widths(family, hidden, dtype):
    """KB's and KR's plain version under autograd at hidden 8, 16, 32
    against ``jax.grad`` of the reference's: f32 per element, bf16 by each
    leaf's relative-norm error against the reference's f32 gradient; the
    masked-out slot's gradient exactly zero."""
    _, tcfg = _configs(family, dtype, hidden, GRAD_W)
    stacked = _stacked(family, hidden, seed=3, window=GRAD_W)
    wins, mask = _grad_plane(hidden)
    spec = tm.get_model(family)
    m = torch.from_numpy(mask)

    def obj(p):
        per_row = spec.loss_stacked(p, tcfg, torch.from_numpy(wins))
        return ((per_row * m).sum(-1) / torch.clamp_min(m.sum(-1), 1.0)).sum()

    _, g = tc.value_and_grad(obj, tc.params_from_numpy(stacked, "cpu"))
    got = jax.tree_util.tree_leaves(tc.params_to_numpy(g))
    want = jax.tree_util.tree_leaves(_jax_grad(family, hidden, "float32"))
    for a, b in zip(got, want):
        if dtype == "float32":
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
        else:
            assert np.linalg.norm(a - b) <= 2e-2 * max(np.linalg.norm(b), 1e-30)
        assert not np.any(a[1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hidden", [8, 32])
def test_forecast_at_widths_on_reference_noise(hidden, dtype):
    """KF's plain version at hidden 8 and 32 (16 is
    ``tests/test_torch_deepar.py``'s) against the reference's ``forecast``,
    fed the draws the reference makes from its key."""
    context, horizon, samples = 16, 4, 4
    over = {"hidden": hidden, "dtype": dtype, "context": context, "horizon": horizon,
            "num_samples": samples}
    jcfg, tcfg = jm.make_config("deepar", over), tm.make_config("deepar", over)
    one = jax.tree_util.tree_map(lambda x: x[0], _stacked("deepar", hidden, seed=4))
    rng = np.random.default_rng(34)
    wins = (2.0 + np.sin(np.arange(context)[None] / 3.0 + np.arange(3)[:, None])
            + 0.1 * rng.normal(size=(3, context))).astype(np.float32)
    key = jax.random.PRNGKey(6)
    j_samples, j_mean = (np.asarray(x) for x in jm.deepar.forecast(
        one, jcfg, jnp.asarray(wins), key))
    keys = jax.random.split(key, horizon)
    eps = np.stack([np.asarray(jax.random.normal(k, (samples * 3,))) for k in keys])
    t_samples, t_mean = (x.numpy() for x in tm.deepar.forecast(
        tc.params_from_numpy(one, "cpu"), tcfg, torch.from_numpy(wins),
        eps=torch.from_numpy(eps)))
    tol = {"float32": 5e-5, "bfloat16": 2e-2}[dtype]
    np.testing.assert_allclose(t_samples, j_samples, rtol=tol, atol=tol)
    np.testing.assert_allclose(t_mean, j_mean, rtol=tol, atol=tol)


# -- what the kernels read, and what they refuse ---------------------------------

@pytest.mark.parametrize("param_dtype", PARAM_DTYPES)
@pytest.mark.parametrize("family", FAMILIES)
def test_scan_weights_read_format_and_width(family, param_dtype):
    """``scan_weights`` hands KS/KD the stored leaves in the C argument
    order (weights and f32 biases, then the int8 scales of wx, wh and the
    heads) and names the variant; the train forms and KF take the f32
    masters only; mixed formats raise; widths past 64 are read for the
    serving forms (the wide form takes them) and, since K3'c's training
    half, by the train forms too (their wide form), and since K3'c's last
    part past the widest their wide form holds (their global form), where
    they raised naming K3'c before."""
    spec = tm.get_model(family)
    cfg = tm.make_config(family, {"hidden": 16})
    stacked = tc.tree_map(lambda *xs: torch.stack(xs),
                          *[spec.init(torch.Generator().manual_seed(i), cfg, device="cpu")
                            for i in range(2)])
    q = tc.quantize_params(stacked, param_dtype)
    leaves = tm.lstm_ad.KS_LEAVES if family == "lstm_ad" else tm.deepar.KD_LEAVES
    sw = tflush.scan_weights(q, cfg, leaves, "K")
    n_w = len(leaves) // 2
    assert (sw.fmt, sw.hidden, sw.variant) == (param_dtype, 16, f"h16,{param_dtype}")
    assert len(sw.tensors) == len(leaves) + n_w
    want = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}[param_dtype]
    assert [x.dtype for x in sw.tensors[0:len(leaves):2]] == [want] * n_w
    assert all(x.dtype == torch.float32 for x in sw.tensors[1:len(leaves):2])
    scales = sw.tensors[len(leaves):]
    if param_dtype == "int8":
        assert [tuple(x.shape) for x in scales] == [
            (2, 1, tc.kernel_shape(q[layer])[-1]) for layer, leaf in leaves if leaf == "w"]
    else:
        assert scales == (None,) * n_w
    form = tm.lstm_ad.KB if family == "lstm_ad" else tm.deepar.KR
    if param_dtype != "f32":
        with pytest.raises(NotImplementedError, match="f32 masters"):
            ttrain._check(form, q, cfg, 16)
        with pytest.raises(NotImplementedError, match="master weights"):
            tflush.scan_weights(q, cfg, leaves, "KF", formats=("f32",),
                                why=" (the reference's forecast reads the master weights)")
    else:
        assert len(ttrain._check(form, q, cfg, 16)) == len(leaves)
    wide_masters = tc.tree_map(lambda x: x[None], spec.init(
        torch.Generator().manual_seed(0), tm.make_config(family, {"hidden": 128}), device="cpu"))
    wide = tc.quantize_params(wide_masters, param_dtype)
    assert tflush.scan_weights(wide, cfg, leaves, "K").variant == f"h128,{param_dtype}"
    assert tflush.train_route(form, 128, 16) == ("wide", 32)
    assert len(ttrain._check(form, wide_masters, cfg, 16)) == len(leaves)
    past = {"lstm_ad": 785, "deepar": 1018}[family]  # the wide train form's caps + 1
    past_masters = tc.tree_map(lambda x: x[None], spec.init(
        torch.Generator().manual_seed(0), tm.make_config(family, {"hidden": past}),
        device="cpu"))
    # past the wide form's cap the train form takes its global form (it
    # raised naming K3'c before K3'c's last part)
    assert len(ttrain._check(form, past_masters, cfg, 16)) == len(leaves)
    assert tflush.train_route(form, past, 16) == ("global", 32)
    mixed = dict(q, wx=tc.quantize_dense(stacked["wx"], "bf16" if param_dtype != "bf16"
                                         else "int8"))
    with pytest.raises(NotImplementedError, match="mixed"):
        tflush.scan_weights(mixed, cfg, leaves, "K")


def test_transformer_quantized_tree_raises_naming_k3b():
    """Since K3'b the transformer's serving check admits its bf16 and int8
    trees (KE and KN read every format) and its train form refuses them,
    saying why: training differentiates the f32 masters, as the
    reference's does; KE's and KN's format reads take the tree's format."""
    cfg = tm.make_config("transformer", {"context": 16, "dim": 32, "depth": 1, "heads": 2})
    params = tm.transformer.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    for pd in ("bf16", "int8"):
        q = tc.quantize_params(params, pd)
        tc.check_kernel_params(q, cfg, "the transformer")
        with pytest.raises(NotImplementedError, match="differentiates them"):
            tc.check_kernel_params(q, cfg, "the transformer's train form",
                                   tm.transformer.TRAIN_MASTERS)
        assert tflush.dense_format(q, ("embed", "head"), "KE") == pd
        assert tflush.dense_leaf(q["head"], pd, "KN", "head")[0].dtype == \
            {"bf16": torch.bfloat16, "int8": torch.int8}[pd]
    tc.check_kernel_params(params, cfg, "the transformer's train form",
                           tm.transformer.TRAIN_MASTERS)
    mixed = dict(params, head=tc.quantize_dense(params["head"], "int8"))
    with pytest.raises(NotImplementedError, match="mixed"):
        tflush.dense_format(mixed, ("embed", "head"), "KE")


# -- Adam's bias corrections -----------------------------------------------------

def test_adam_bias_corrections_bitwise_over_200k_counts():
    """``bias_corrections`` (glibc's powf, tabulated) bitwise the
    reference's compiled ``1 - b**count`` for b1 and b2 over counts
    1..200,000, past the table's end (32,768) included."""
    counts = np.arange(1, 200_001, dtype=np.int32)
    got = adam.bias_corrections(torch.from_numpy(counts))
    for g, b in zip(got, (adam.B1, adam.B2)):
        want = np.asarray(jax.jit(lambda c, b=b: 1 - jnp.float32(b) ** c)(jnp.asarray(counts)))
        np.testing.assert_array_equal(g.numpy().view(np.int32), want.view(np.int32))
