"""Port parity of K3'c's last part: KS, KD, KF, KB and KR at hidden widths
past what one block's shared memory holds, where the port's kernels take
their global form (the wide kernels with the block state in global
memory). The plain versions on the CPU against the JAX package on the
same seeded numpy inputs, and the routes that send each shape to its form.

Bars, each the reference's own or stated here:

- ``score_stacked`` at LSTM-AD hidden 1,800 and DeepAR 2,240: f32 compute
  2e-4 (``tests/test_fused_step.py:138``), bf16 compute 2e-2 (``:110``);
- the forecast at DeepAR hidden 2,240 on the reference's own noise: 5e-5
  (f32) and 2e-2 (bf16), as ``tests/test_torch_deepar.py`` holds it;
- ``loss_stacked``'s gradients at LSTM-AD hidden 800 and DeepAR 1,020
  against ``jax.grad``: f32 per element at rtol 1e-4 / atol 1e-5
  (``tests/test_train_lane.py:119-124``), bf16 by each leaf's
  relative-norm error against the reference's f32 gradient at 2e-2
  (ROADMAP queue 3).

The card holds the global forms against these plain versions, and
bitwise against the wide form where both run
(``tests/test_torch_kernels.py``, ``chip_smoke.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sitewhere_tpu.models as jm
import sitewhere_tpu_torch.models as tm
import sitewhere_tpu_torch.models.common as tc
from sitewhere_tpu_torch.models import deepar as tdeepar
from sitewhere_tpu_torch.models import flush as tflush
from sitewhere_tpu_torch.models import train as ttrain

SCORE_TOL = {"float32": 2e-4, "bfloat16": 2e-2}
FORECAST_TOL = {"float32": 5e-5, "bfloat16": 2e-2}
KB, KR = tm.lstm_ad.KB, tm.deepar.KR
# the widest hidden each wide form holds at 8 rows a block (one more takes
# the global form)
CAPS = {"KS": 1757, "KD": 2231, "KF": 2233, "KB": 784, "KR": 1017}

# small tensors: one intra-op thread, so the suite's parallel workers keep
# their cores
torch.set_num_threads(1)


def _route(kernel: str, h: int, w: int = 32, plane=None):
    """The route of ``kernel`` at hidden ``h``, window (KF: context) ``w``."""
    if kernel == "KS":
        return tflush.scan_route("lstm_score", "KS", h, w, plane)
    if kernel == "KD":
        return tflush.scan_route("gru_score", "KD", h, w, plane)
    if kernel == "KF":
        return tdeepar.kf_route(h, 64, 24, w, None if plane is None else plane[0])
    return tflush.train_route(KB if kernel == "KB" else KR, h, w, plane)


# every shape the templated or wide form took before the global form
# (tests/test_torch_k3c.py's lists), with its form
KEPT = {
    "KS": [(h, w, "block") for h in tflush.SCAN_HIDDENS for w in (2, 16, 32, 128)]
    + [(4, 32, "wide"), (40, 192, "wide"), (96, 32, "wide"), (128, 256, "wide"),
       (256, 512, "wide"), (64, 4096, "wide"), (64, 1493, "block"), (64, 1494, "wide"),
       (1024, 32, "wide"), (1757, 32, "wide")],
    "KD": [(h, w, "block") for h in tflush.SCAN_HIDDENS for w in (2, 16, 32, 128)]
    + [(4, 32, "wide"), (40, 192, "wide"), (96, 32, "wide"), (128, 256, "wide"),
       (256, 512, "wide"), (64, 4096, "wide"), (1024, 32, "wide"), (2231, 32, "wide")],
    "KF": [(h, 128, "block") for h in tflush.SCAN_HIDDENS]
    + [(40, 168, "wide"), (2233, 168, "wide")],
    "KB": [(h, w, "block") for h in tflush.SCAN_HIDDENS for w in (2, 32, 128, 256)]
    + [(128, 256, "wide"), (40, 192, "wide"), (12, 140, "wide"), (100, 33, "wide"),
       (4, 2, "wide"), (1, 5, "wide"), (512, 32, "wide"), (784, 32, "wide")],
    "KR": [(h, w, "block") for h in tflush.SCAN_HIDDENS for w in (2, 32, 128, 256)]
    + [(128, 256, "wide"), (40, 192, "wide"), (12, 140, "wide"), (40, 136, "wide"),
       (100, 33, "wide"), (512, 32, "wide"), (1017, 32, "wide")],
}


@pytest.mark.parametrize("kernel", list(CAPS))
def test_routes_keep_old_forms_and_send_wider_hiddens_global(kernel):
    """Every shape the templated or the wide form took keeps its form; each
    wide form's cap + 1, hidden 2,049 (odd; past the caps under it), 2,304
    and 4,096 take the global form (32 rows a block without a plane); no
    hidden raises; a window under 2 still raises."""
    for h, w, form in KEPT[kernel]:
        assert _route(kernel, h, w)[0] == form, (kernel, h, w)
    for h in [CAPS[kernel] + 1, 2304, 4096, 20000] + [2049] * (CAPS[kernel] < 2049):
        assert _route(kernel, h) == ("global", 32), (kernel, h)
    if kernel != "KF":
        with pytest.raises(ValueError):
            _route(kernel, 4096, 1)


def test_global_rows_rule_and_scratch_by_hand():
    """R for the global form: the most of 32, 16, 8 whose grid still gives
    each of the H100's 132 SMs a block, else 8. KS at hidden 2,048 and 16
    rows a block (main path q's plane, 2 slots x 2,048 rows: 128 blocks at
    32 rows, 256 at 16): hT 2 x 2,048 x 20 + c 16 x 2,048 + the head 2,048 =
    116,736 floats a block (a multiple of 32), 256 blocks, 119,537,664
    bytes; a plane past one wave holds 1,056 blocks' worth."""
    assert tflush.scan_route("lstm_score", "KS", 2048, 32, (2, 2048)) == ("global", 16)
    assert [tflush.global_rows(tflush.plane_blocks(p))
            for p in ((4, 2048), (2, 2048), (1, 2048), (1, 8), (132, 32), (131, 32),
                      (1, 1024))] == [32, 16, 8, 8, 32, 16, 8]
    floats = tflush.scan_state_floats("lstm_score", 2048, 16)
    assert floats == 2 * 2048 * 20 + 16 * 2048 + 2048 == 116736
    assert tflush.state_stride(floats) == floats
    assert tflush.state_stride(2 * 41 * 12 + 2 * 41) == 1088  # 1,066 rounded up to 32
    assert tflush.global_scratch(floats, 256, "meta").numel() * 4 == 119537664
    assert tflush.global_scratch(floats, 8192, "meta").numel() == 1056 * floats
    # KD's and KF's state: hT and two heads; the train forms' by mode
    assert tflush.scan_state_floats("gru_score", 2304, 16) == 2 * 2304 * 20 + 2 * 2304
    assert tflush.train_state_floats(KB, 2048, 16, 0) == 2 * 2048 * 20 + 16 * 2048 + 2048
    assert tflush.train_state_floats(KB, 2048, 16, 1) == (
        8192 * 20 + 2 * 16 * 2048 + 2 * (2 * 8192 + 2048) + 2048)
    assert tflush.train_state_floats(KR, 2304, 16, 1) == (
        3 * 2304 * 20 + 16 * 2304 + 2 * (9 * 2304 + 2 * 2304) + 2 * 2304)
    # the wide form's shared memory is the same state plus the small arrays
    assert tflush.wide_smem_bytes("lstm_score", 1757, 8) <= tflush.kernels.SMEM_MAX_BYTES < \
        tflush.wide_smem_bytes("lstm_score", 1758, 8)


def test_forced_route_takes_only_the_wide_and_global_shapes():
    """``forced_route`` (how the card holds the global form against the
    wide form on one shape) moves every wide or global shape of the five
    kernels to the forced form and rows, and leaves the templated forms'
    shapes theirs; it takes only the wide or global form at 8, 16 or 32
    rows."""
    with tflush.forced_route("global", 8):
        assert _route("KS", 128) == _route("KD", 40) == _route("KF", 40, 168) == \
            _route("KB", 128) == _route("KR", 40) == _route("KS", 4096) == ("global", 8)
        assert _route("KS", 64) == ("block", 32) and _route("KF", 64, 128) == ("block", 64)
        with tflush.forced_route("wide", 32):
            assert _route("KR", 2304) == ("wide", 32)
        assert _route("KR", 2304) == ("global", 8)
    assert _route("KS", 128) == ("wide", 32)
    for bad in (("block", 32), ("global", 12)):
        with pytest.raises(ValueError):
            with tflush.forced_route(*bad):
                pass


def _stacked(family, hidden, window, seed, n=2):
    """n per-slot JAX param trees with non-zero biases, stacked, as numpy."""
    jcfg = jm.make_config(family, {"hidden": hidden, "window": window})
    rng = np.random.default_rng(500 + seed)
    trees = []
    for i in range(n):
        p = jax.tree_util.tree_map(
            np.asarray, jm.get_model(family).init(jax.random.PRNGKey(10 * seed + i), jcfg))
        for layer in p.values():
            layer["b"] = rng.normal(scale=0.1, size=layer["b"].shape).astype(np.float32)
        if family == "deepar":
            p["sigma"]["b"] -= 1.0
        trees.append(p)
    return jax.tree_util.tree_map(lambda *xs: np.stack(xs), *trees)


SCORE_HIDDEN = {"lstm_ad": 1800, "deepar": 2240}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", ["lstm_ad", "deepar"])
def test_score_stacked_past_the_wide_cap_matches_reference(family, dtype):
    """``score_stacked`` (K = 2) at LSTM-AD hidden 1,800 and DeepAR 2,240
    (past KS's 1,757 and KD's 2,231: the global form on the card) on 2
    slots x 3 random-walk windows of 8, against the reference's."""
    hidden, window = SCORE_HIDDEN[family], 8
    over = {"hidden": hidden, "window": window, "dtype": dtype}
    jcfg, tcfg = jm.make_config(family, over), tm.make_config(family, over)
    stacked = _stacked(family, hidden, window, seed=1)
    rng = np.random.default_rng(hidden)
    wins = np.cumsum(rng.normal(size=(2, 3, window)), -1).astype(np.float32)
    nv = np.array([[window, 5, 3], [window, window, 6]], np.int32)
    want = np.asarray(jax.jit(jm.get_model(family).score_stacked, static_argnums=(1, 4))(
        stacked, jcfg, jnp.asarray(wins), jnp.asarray(nv), 2))
    got = tm.get_model(family).score_stacked(
        tc.params_from_numpy(stacked, "cpu"), tcfg, torch.from_numpy(wins),
        torch.from_numpy(nv), k=2).numpy()
    tol = SCORE_TOL[dtype]
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    assert np.any(want != 0.0)
    name = "lstm_score" if family == "lstm_ad" else "gru_score"
    assert tflush.scan_route(name, name, hidden, window, (2, 3)) == ("global", 8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forecast_past_the_wide_cap_on_reference_noise(dtype):
    """KF's plain version at DeepAR hidden 2,240 (past KF's wide form's
    2,233: its global form on the card), 2 series, context 8, 4 paths,
    horizon 3, against the reference's ``forecast`` fed the draws the
    reference makes from its key."""
    context, horizon, samples, series, hidden = 8, 3, 4, 2, 2240
    over = {"hidden": hidden, "dtype": dtype, "context": context, "horizon": horizon,
            "num_samples": samples}
    jcfg, tcfg = jm.make_config("deepar", over), tm.make_config("deepar", over)
    one = jax.tree_util.tree_map(lambda x: x[0], _stacked("deepar", hidden, context, 2, n=1))
    rng = np.random.default_rng(36)
    wins = (2.0 + np.sin(np.arange(context)[None] / 3.0 + np.arange(series)[:, None])
            + 0.1 * rng.normal(size=(series, context))).astype(np.float32)
    key = jax.random.PRNGKey(8)
    j_samples, j_mean = (np.asarray(x) for x in jm.deepar.forecast(
        one, jcfg, jnp.asarray(wins), key))
    eps = np.stack([np.asarray(jax.random.normal(kk, (samples * series,)))
                    for kk in jax.random.split(key, horizon)])
    t_samples, t_mean = (x.numpy() for x in tm.deepar.forecast(
        tc.params_from_numpy(one, "cpu"), tcfg, torch.from_numpy(wins),
        eps=torch.from_numpy(eps)))
    tol = FORECAST_TOL[dtype]
    np.testing.assert_allclose(t_samples, j_samples, rtol=tol, atol=tol)
    np.testing.assert_allclose(t_mean, j_mean, rtol=tol, atol=tol)
    assert tdeepar.kf_route(hidden, samples, horizon, context, series) == ("global", 8)


GRAD_HIDDEN = {"lstm_ad": 800, "deepar": 1020}
GRAD_W = 6


def _grad_plane(family):
    """2 slots x 4 random-walk windows of 6, a row mask with slot 1's
    second row out."""
    rng = np.random.default_rng(GRAD_HIDDEN[family])
    wins = np.cumsum(rng.normal(size=(2, 4, GRAD_W)), -1).astype(np.float32)
    mask = np.ones((2, 4), np.float32)
    mask[1, 1] = 0.0
    return wins, mask


@functools.lru_cache(maxsize=None)
def _jax_grad(family):
    """The reference's f32 gradient of the masked per-slot mean of its
    ``loss_stacked`` (cached: the bf16 case reuses it)."""
    hidden = GRAD_HIDDEN[family]
    jcfg = jm.make_config(family, {"hidden": hidden, "window": GRAD_W, "dtype": "float32"})
    stacked = _stacked(family, hidden, GRAD_W, seed=3)
    wins, mask = _grad_plane(family)
    spec = jm.get_model(family)

    def obj(p):
        per_row = spec.loss_stacked(p, jcfg, jnp.asarray(wins))
        m = jnp.asarray(mask)
        return ((per_row * m).sum(-1) / jnp.maximum(m.sum(-1), 1.0)).sum()

    g = jax.jit(jax.grad(obj))(jax.tree_util.tree_map(jnp.asarray, stacked))
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(g)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", ["lstm_ad", "deepar"])
def test_loss_stacked_gradients_past_the_wide_cap(family, dtype):
    """KB's and KR's plain version under autograd at LSTM-AD hidden 800 and
    DeepAR 1,020 (past the wide train forms' 784 and 1,017: their global
    form on the card) against ``jax.grad`` of the reference's: f32 per
    element, bf16 by each leaf's relative-norm error against the
    reference's f32 gradient."""
    hidden = GRAD_HIDDEN[family]
    tcfg = tm.make_config(family, {"hidden": hidden, "window": GRAD_W, "dtype": dtype})
    stacked = _stacked(family, hidden, GRAD_W, seed=3)
    wins, mask = _grad_plane(family)
    spec = tm.get_model(family)
    m = torch.from_numpy(mask)

    def obj(p):
        per_row = spec.loss_stacked(p, tcfg, torch.from_numpy(wins))
        return ((per_row * m).sum(-1) / torch.clamp_min(m.sum(-1), 1.0)).sum()

    _, g = tc.value_and_grad(obj, tc.params_from_numpy(stacked, "cpu"))
    got = jax.tree_util.tree_leaves(tc.params_to_numpy(g))
    want = _jax_grad(family)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if dtype == "float32":
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
        else:
            assert np.linalg.norm(a - b) <= 2e-2 * max(np.linalg.norm(b), 1e-30)
    form = KB if family == "lstm_ad" else KR
    assert tflush.train_route(form, hidden, GRAD_W, (2, 4)) == ("global", 8)


@pytest.mark.parametrize("family, hidden", [("lstm_ad", 800), ("deepar", 1020),
                                            ("lstm_ad", 2048), ("deepar", 2304)])
def test_train_bytes_per_row_counts_the_global_block_state(family, hidden):
    """At a global-form shape ``train_bytes_per_row`` (which sizes the
    train step's chunks) holds what ``TrainLoss`` allocates between its
    forward and its backward (``train_buffers`` on the meta device: the
    saves, the heads' derivatives, the backward's dgates, per-tile partials
    and block-state scratch), on planes at 8 and at 32 rows a block: at 8
    within the rounding to whole bytes a row, at 32 above it (the count is
    the most a row can take). The forward's scratch is smaller than the
    backward's."""
    form = KB if family == "lstm_ad" else KR
    window = 32
    cfg = tm.make_config(family, {"hidden": hidden, "window": window})
    per_row = ttrain.train_bytes_per_row(form, cfg, window)
    for t, b, rows in ((1, 64, 8), (5, 1024, 32)):
        assert tflush.train_route(form, hidden, window, (t, b)) == ("global", rows)
        fwd = ttrain.train_buffers(form, torch.bfloat16, t, b, window, hidden, "meta", 0)
        bwd = ttrain.train_buffers(form, torch.bfloat16, t, b, window, hidden, "meta", 1)
        assert fwd["state"].numel() < bwd["state"].numel()
        held = sum(x.numel() * x.element_size() for k, x in [*fwd.items(), *bwd.items()]
                   if x is not None and k not in ("per_row", "reduced", "wt")) - \
            fwd["state"].numel() * 4
        assert held <= t * b * per_row
        if rows == 8:
            assert t * b * per_row < held + 2 * t * b
        assert tuple(bwd["wt"].shape) == (t, form.gates * hidden, hidden)


def test_train_chunk_slots_at_main_paths_q_and_r():
    """The train step's chunk at main paths q and r (2 slots x 2,048
    streams, window 32, bf16 saves): LSTM-AD at hidden 2,048 holds
    1,354,877 B a row (31 steps of 40,964 B, the partials' and the
    backward block state's shares at 8 rows a block), DeepAR at hidden 2,304
    1,221,369 B (31 steps of 36,872 B and the shares); both train their 2
    slots in one chunk."""
    from types import SimpleNamespace

    from sitewhere_tpu_torch.parallel.sharded import ShardedScorer

    for family, h, per_row in (("lstm_ad", 2048, 1354877), ("deepar", 2304, 1221369)):
        spec = tm.get_model(family)
        cfg = tm.make_config(family, {"hidden": h, "window": 32})
        assert spec.train_bytes_per_row(cfg, 32) == per_row
        scorer = SimpleNamespace(plain=False, spec=spec, cfg=cfg, window=32, n_slots=2,
                                 max_streams=2048,
                                 TRAIN_SAVE_BYTES=ShardedScorer.TRAIN_SAVE_BYTES)
        assert ShardedScorer.train_chunk_slots(scorer) == 2
    assert 31 * (10 * 2048 * 2 + 4) == 31 * 40964 < 1354877
