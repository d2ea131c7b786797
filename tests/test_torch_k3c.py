"""Port parity of the serving shapes past the templated kernels (K3'c's
serving half): config 1's 65,536-row flush on one slot through KW's
multi-block form, KS and KD at any hidden and window through their wide
form, KF at any hidden and sample count. The plain versions on the CPU
against the JAX package on the same seeded numpy inputs, and the routes
that send each shape to its form.

Bars, each the reference's own or stated here:

- KW: bitwise. The port's totals follow the per-stream contract, so the
  scatter is held against the reference's ``_apply_update`` fed the true
  ranks (as ``tests/test_torch_windows.py`` does; the reference's
  ``_segment_ranks`` fault, ROADMAP queue 3); ``later`` against the
  contract oracle; the chunked mirror of the multi-block decomposition
  bitwise the plain version;
- ``score_stacked`` and the flush form at hidden 4, 40, 128 and windows 192,
  256: f32 compute 2e-4 (``tests/test_fused_step.py:138``), bf16 compute
  2e-2 (``:110``);
- the forecast at hidden 40 and 256 samples on the reference's own noise:
  5e-5 (f32) and 2e-2 (bf16), as ``tests/test_torch_deepar.py`` holds it.

K3'c's training half (KB's and KR's wide forms) is held against the
reference in ``tests/test_torch_train.py`` (its wide shapes); here are its
route, its shared-memory caps and the bytes its chunks are sized by.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sitewhere_tpu.models as jm
import sitewhere_tpu.models.common as jc
import sitewhere_tpu.ops.windows as jw
import sitewhere_tpu_torch.models as tm
import sitewhere_tpu_torch.models.common as tc
import sitewhere_tpu_torch.ops.windows as tw
from sitewhere_tpu_torch.models import deepar as tdeepar
from sitewhere_tpu_torch.models import flush as tflush
from sitewhere_tpu_torch.models import train as ttrain

SCORE_TOL = {"float32": 2e-4, "bfloat16": 2e-2}
FORECAST_TOL = {"float32": 5e-5, "bfloat16": 2e-2}
# config 1's flush (bench.py:2033, :2038, :797; runtime/config.py:212): one
# slot, 4,096 streams, window 32, a full 65,536-row bucket
C1_STREAMS, C1_WINDOW, C1_ROWS = 4096, 32, 65536

# small tensors: one intra-op thread, so the suite's parallel workers keep
# their cores
torch.set_num_threads(1)


def _true_ranks_totals(keys):
    """Contract oracle: arrival rank among equal keys, and the key count."""
    _, inv, cnt = np.unique(keys, return_inverse=True, return_counts=True)
    order = np.argsort(inv, kind="stable")
    starts = np.concatenate([[0], np.cumsum(cnt)[:-1]])
    ranks = np.empty(len(keys), np.int64)
    ranks[order] = np.arange(len(keys)) - np.repeat(starts, cnt)
    return ranks.astype(np.int32), cnt[inv].astype(np.int32)


def _c1_flush(rng, n_streams=C1_STREAMS, rows=C1_ROWS, w=C1_WINDOW):
    """One config-1 bucket: Zipf-like repeats (hot streams burst past W),
    a tail of invalid rows with stale ids, a few out-of-range ids."""
    perm = rng.permutation(n_streams)
    ids = perm[(rng.zipf(1.3, rows) - 1) % n_streams].astype(np.int64)
    ids[:3 * w] = perm[0]                  # one stream far past the window
    ids[rng.integers(0, rows, 5)] = n_streams + 7  # valid, out of range
    valid = np.ones(rows, bool)
    valid[rows - 1000:] = False
    ids[~valid] = rng.integers(0, n_streams + 8, int((~valid).sum()))
    vals = rng.normal(size=rows).astype(np.float32)
    return ids.astype(np.int32), vals, valid


def test_config1_flush_bitwise_reference_and_contract():
    """One slot x 65,536 rows, two flushes: ``update_windows`` and KW's
    plain version (the stacked in-place form, mask and counts mode) bitwise
    the reference's ``_apply_update`` fed true ranks, ``later`` the
    contract's, the multi-block mirror at its kernel's chunk bitwise."""
    rng = np.random.default_rng(0)
    jst = jw.init_window_state(C1_STREAMS, C1_WINDOW)
    st = tw.init_window_state(C1_STREAMS, C1_WINDOW, device="cpu", n_slots=1)
    st_c = tw.init_window_state(C1_STREAMS, C1_WINDOW, device="cpu", n_slots=1)
    for f in range(2):
        ids, vals, valid = _c1_flush(rng)
        want_r, want_t = _true_ranks_totals(np.where(valid, ids, -1))
        jst = jw._apply_update(jst, jnp.asarray(ids), jnp.asarray(vals), jnp.asarray(valid),
                               jnp.asarray(want_r), jnp.asarray(want_t))
        t_ids, t_vals = torch.from_numpy(ids)[None], torch.from_numpy(vals)[None]
        one = tw.WindowState(*(x[0].clone() for x in st))
        fn = tw.update_windows(one, t_ids[0], t_vals[0], torch.from_numpy(valid))
        if f == 0:
            kw = dict(mask=torch.from_numpy(valid)[None])
        else:
            kw = dict(counts=torch.tensor([[int(valid.sum())]], dtype=torch.int32))
        later = tw.window_update_plain(st, t_ids, t_vals, **kw)
        later_c = tw.window_update_chunked_plain(st_c, t_ids, t_vals, chunk=tw.KW_CHUNK, **kw)
        for a, b, c, j in zip(st, fn, st_c, jst):
            np.testing.assert_array_equal(a[0].numpy(), np.asarray(j))
            np.testing.assert_array_equal(b.numpy(), np.asarray(j))
            assert torch.equal(a, c)
        np.testing.assert_array_equal(later[0].numpy(), np.where(valid, want_t - 1 - want_r, 0))
        assert torch.equal(later, later_c)
    assert tw.kw_route(C1_ROWS) == "multi"


@pytest.mark.parametrize("mode", ["counts", "mask"])
def test_chunked_mirror_bitwise_plain_over_many_chunks(mode):
    """The multi-block KW's decomposition (chunk sorts, merge passes, ranks
    and writes from the sorted runs, the advance) at chunks of 64 rows over
    5,000 (79 chunks, 7 merge passes) and 8 over 37, three slots, chained
    flushes with bursts past W, invalid and out-of-range ids, u16 and i32
    ids: state and ``later`` bitwise ``window_update_plain``'s."""
    rng = np.random.default_rng(1)
    for t, s, w, b, chunk, id_dtype in ((3, 64, 5, 5000, 64, np.uint16),
                                        (2, 16, 4, 37, 8, np.int32)):
        st = tw.init_window_state(s, w, device="cpu", n_slots=t)
        st.values.copy_(torch.from_numpy(rng.normal(size=(t, s, w)).astype(np.float32)))
        st.pos.copy_(torch.from_numpy(rng.integers(0, w, (t, s)).astype(np.int32)))
        st.count.copy_(torch.from_numpy(rng.integers(0, 3 * w, (t, s)).astype(np.int32)))
        st_c = tw.WindowState(*(x.clone() for x in st))
        for _ in range(3):
            ids = rng.integers(0, s + 3, (t, b))
            ids[0, :3 * w] = 2
            ids = ids.astype(id_dtype)
            t_ids = (torch.from_numpy(ids.view(np.int16)).view(torch.uint16)
                     if id_dtype == np.uint16 else torch.from_numpy(ids))
            vals = torch.from_numpy(rng.normal(size=(t, b)).astype(np.float32))
            if mode == "mask":
                kw = dict(mask=torch.from_numpy(rng.random((t, b)) > 0.3))
            else:
                kw = dict(counts=torch.from_numpy(rng.integers(0, b + 1, (t, 1)).astype(np.int32)))
            later = tw.window_update_plain(st, t_ids, vals, **kw)
            later_c = tw.window_update_chunked_plain(st_c, t_ids, vals, chunk=chunk, **kw)
            assert torch.equal(later, later_c)
            for a, c in zip(st, st_c):
                assert torch.equal(a, c)


# -- KS and KD at any hidden and window ------------------------------------------

def _stacked(family, hidden, window, seed, n=2):
    """n per-slot JAX param trees with non-zero biases, stacked, as numpy."""
    jcfg = jm.make_config(family, {"hidden": hidden, "window": window})
    rng = np.random.default_rng(300 + seed)
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


@functools.lru_cache(maxsize=None)
def _jit_score(family):
    return jax.jit(jm.get_model(family).score_stacked, static_argnums=(1, 4))


# (hidden, window, compute dtype, the served tree's format)
WIDE_CASES = [(4, 192, "float32", "f32"), (4, 256, "bfloat16", "int8"),
              (40, 192, "bfloat16", "bf16"), (40, 256, "float32", "f32"),
              (128, 192, "bfloat16", "int8"), (128, 256, "float32", "f32")]


@pytest.mark.parametrize("hidden, window, dtype, param_dtype", WIDE_CASES)
@pytest.mark.parametrize("family", ["lstm_ad", "deepar"])
def test_wide_flush_matches_reference(family, hidden, window, dtype, param_dtype):
    """The scorer's plain flush at a wide shape: ``score_stacked`` (K = 2)
    against the reference's on the quantized tree, and the flush form
    (gather from the rings, column by ``later``, inactive slot and invalid
    rows zeroed) against the reference's ``gather_windows`` +
    ``score_stacked`` + the fused step's select."""
    over = {"hidden": hidden, "window": window, "dtype": dtype}
    jcfg, tcfg = jm.make_config(family, over), tm.make_config(family, over)
    stacked = _stacked(family, hidden, window, seed=hidden + window)
    jq = jc.quantize_params(jax.tree_util.tree_map(jnp.asarray, stacked), param_dtype)
    tq = tc.quantize_params(tc.params_from_numpy(stacked, "cpu"), param_dtype)
    spec = tm.get_model(family)
    rng = np.random.default_rng(hidden * 7 + window)
    n_slots, streams, rows, k = 2, 5, 6, 2
    ring = rng.normal(size=(n_slots, streams, window)).astype(np.float32)
    ring[1] = np.cumsum(ring[1], -1)  # a drifting series too
    pos = rng.integers(0, window, (n_slots, streams)).astype(np.int32)
    count = np.array([[0, 3, window + 5, 9, 2 * window], [window] * streams], np.int32)
    ids = rng.integers(0, streams, (n_slots, rows)).astype(np.int32)
    later = rng.integers(0, 3, (n_slots, rows)).astype(np.int32)
    counts = np.array([[rows], [4]], np.int32)
    active = np.array([True, True])
    # the reference: gather, score all K columns, select as the fused step
    wins, nv = [], []
    for t in range(n_slots):
        w_t, n_t = jw.gather_windows(
            jw.WindowState(jnp.asarray(ring[t]), jnp.asarray(pos[t]), jnp.asarray(count[t])),
            jnp.asarray(ids[t]))
        wins.append(np.asarray(w_t))
        nv.append(np.asarray(n_t))
    wins, nv = np.stack(wins), np.stack(nv)
    want_k = np.asarray(_jit_score(family)(jq, jcfg, jnp.asarray(wins), jnp.asarray(nv), k))
    tol = SCORE_TOL[dtype]
    got_k = spec.score_stacked(tq, tcfg, torch.from_numpy(wins), torch.from_numpy(nv), k=k)
    np.testing.assert_allclose(got_k.numpy(), want_k, rtol=tol, atol=tol)
    col = np.clip(k - 1 - later, 0, k - 1)
    want = np.take_along_axis(want_k, col[..., None], -1)[..., 0]
    want = np.where(np.arange(rows)[None] < counts, want, 0.0)
    state = tw.WindowState(*(torch.from_numpy(x) for x in (ring, pos, count)))
    got = spec.score_flush(tq, tcfg, state, torch.from_numpy(ids), torch.from_numpy(later),
                           torch.from_numpy(active), counts=torch.from_numpy(counts), k=k)
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
    assert np.any(want != 0.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forecast_at_hidden_40_and_256_samples_on_reference_noise(dtype):
    """KF's plain version at GluonTS DeepAR's width (hidden 40) and 256
    sample paths, context 168 (the DeepAR paper's conditioning range),
    against the reference's ``forecast`` fed the draws the reference makes
    from its key."""
    context, horizon, samples, series = 168, 4, 256, 2
    over = {"hidden": 40, "dtype": dtype, "context": context, "horizon": horizon,
            "num_samples": samples}
    jcfg, tcfg = jm.make_config("deepar", over), tm.make_config("deepar", over)
    one = jax.tree_util.tree_map(lambda x: x[0], _stacked("deepar", 40, context, seed=5, n=1))
    rng = np.random.default_rng(35)
    wins = (2.0 + np.sin(np.arange(context)[None] / 6.0 + np.arange(series)[:, None])
            + 0.1 * rng.normal(size=(series, context))).astype(np.float32)
    key = jax.random.PRNGKey(7)
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


def test_routes_keep_built_shapes_and_send_new_ones_to_the_new_forms():
    """Every shape the templated kernels took keeps its form; the new shapes
    reach the wide or multi-block form; since K3'c's training half the
    train forms take the new shapes too (their wide form, or the templated
    one where its tiles hold a longer window); since K3'c's last part a
    hidden past the widest their wide form holds takes the global form
    (the block state in global memory) where it raised before."""
    assert tw.kw_block_max_rows() == 16384
    assert [tw.kw_route(b) for b in (1, 2048, 16384, 16385, 65536, 262144)] == \
        ["block"] * 3 + ["multi"] * 3
    for name, label in (("lstm_score", "KS"), ("gru_score", "KD")):
        for h in tflush.SCAN_HIDDENS:
            for w in (2, 16, 32, 128):
                assert tflush.scan_route(name, label, h, w) == ("block", 32)
        for h, w in ((4, 32), (40, 192), (96, 32), (128, 256), (256, 512), (64, 4096)):
            assert tflush.scan_route(name, label, h, w)[0] == "wide"
        # the templated tile's cap is its shared memory: 1,493 samples at hidden 64
        assert tflush.scan_route(name, label, 64, 1493)[0] == "block"
        assert tflush.scan_route(name, label, 64, 1494)[0] == "wide"
        assert tflush.scan_route(name, label, 1024, 32) == \
            ("wide", 8 if name == "lstm_score" else 16)
        assert tflush.scan_route(name, label, 4096, 32) == ("global", 32)
        with pytest.raises(ValueError):
            tflush.scan_route(name, label, 64, 1)
    for h in tflush.SCAN_HIDDENS:
        for ns in (1, 64, 128):
            assert tdeepar.kf_route(h, ns, 24, 128)[0] == "block"
    assert tdeepar.kf_route(64, 100, 24, 168) == ("block", 100)
    assert tdeepar.kf_route(64, 256, 24, 168) == ("wide", 32)
    assert tdeepar.kf_route(40, 100, 24, 168) == ("wide", 32)
    for family, form in (("lstm_ad", tm.lstm_ad.KB), ("deepar", tm.deepar.KR)):
        spec = tm.get_model(family)
        for h, w, route in ((128, 32, "wide"), (40, 32, "wide"), (64, 192, "block"),
                            (64, 128, "block")):
            cfg = tm.make_config(family, {"hidden": h, "window": w})
            masters = tc.tree_map(lambda x: x[None], spec.init(
                torch.Generator().manual_seed(0), cfg, device="cpu"))
            assert len(ttrain._check(form, masters, cfg, w)) == len(form.leaves)
            assert tflush.train_route(form, h, w)[0] == route
        past = {"lstm_ad": 785, "deepar": 1018}[family]
        cfg = tm.make_config(family, {"hidden": past, "window": 32})
        masters = tc.tree_map(lambda x: x[None], spec.init(
            torch.Generator().manual_seed(0), cfg, device="cpu"))
        assert len(ttrain._check(form, masters, cfg, 32)) == len(form.leaves)
        assert tflush.train_route(form, past, 32) == ("global", 32)


# -- K3'c's training half: the train forms' routes and their memory ----------------

TRAIN_FORMS = (tm.lstm_ad.KB, tm.deepar.KR)


@pytest.mark.parametrize("form", TRAIN_FORMS, ids=lambda f: f.name)
def test_train_route_keeps_templated_shapes_and_sends_the_rest_wide(form):
    """The train route by shape, before any launch: every shape the
    templated form took (hidden 8/16/32/64, windows 2..128) keeps it, and
    a longer window while both modes' tiles fit (H 64 / W 256 needs
    73,728 B forward and 139,392 B backward for KB); any other hidden, or
    a window past the tiles, takes the wide form at the most rows a block
    whose state fits; a window under 2 is refused."""
    for h in tflush.SCAN_HIDDENS:
        for w in range(2, 129):
            assert tflush.train_route(form, h, w) == ("block", 32)
        assert tflush.train_route(form, h, 256) == ("block", 32)
    if form.cell:
        assert tflush.train_smem_bytes(form, 64, 256) == 139392
        assert 32 * (64 + 4 * 64 + 256) * 4 == 73728  # the forward's share
    cap = {"lstm_train": 983, "gru_train": 1174}[form.name]  # hidden 64's longest tile
    assert tflush.train_route(form, 64, cap) == ("block", 32)
    assert tflush.train_route(form, 64, cap + 1) == ("wide", 32)
    for h, w in ((128, 256), (40, 192), (12, 140), (40, 136), (100, 33), (4, 2), (1, 5)):
        assert tflush.train_route(form, h, w) == ("wide", 32)
    assert tflush.train_route(form, 512, 32)[0] == "wide"
    assert tflush.train_route(form, 512, 32)[1] < 32
    with pytest.raises(ValueError):
        tflush.train_route(form, 64, 1)


@pytest.mark.parametrize("form", TRAIN_FORMS, ids=lambda f: f.name)
def test_train_route_raises_past_the_wide_cap_naming_k3c(form):
    """The widest hidden the wide train form holds at 8 rows a block (the
    backward's dgates [4H or 3H][12], dh, dc and partial sums in shared
    memory): 784 for KB, 1,017 for KR; one more raised naming K3'c before
    K3'c's last part and now takes the global form (the block state in
    global memory), at the rows its plane gives."""
    cap = {"lstm_train": 784, "gru_train": 1017}[form.name]
    assert tflush.train_route(form, cap, 32) == ("wide", 8)
    assert tflush.train_wide_smem_bytes(form, cap, 8) <= tflush.kernels.SMEM_MAX_BYTES
    assert tflush.train_wide_smem_bytes(form, cap + 1, 8) > tflush.kernels.SMEM_MAX_BYTES
    assert tflush.train_route(form, cap + 1, 32) == ("global", 32)
    assert tflush.train_route(form, cap + 1, 32, (2, 2048)) == ("global", 16)


@pytest.mark.parametrize("family, hidden, window, dtype", [
    (f, h, w, d) for f in ("lstm_ad", "deepar")
    for h, w, d in ((128, 256, "bfloat16"), (40, 192, "bfloat16"), (64, 32, "bfloat16"),
                    (12, 140, "float32"), ({"lstm_ad": 784, "deepar": 1017}[f], 16, "float32"))])
def test_train_bytes_per_row_is_what_the_train_form_allocates(family, hidden, window, dtype):
    """``train_bytes_per_row`` (which sizes the train step's chunks) against
    the buffers ``TrainLoss`` allocates (``train_buffers`` on the meta
    device), over a plane whose rows are a whole number of tiles: the
    saves, the heads' derivatives, the backward's dgates and per-tile
    partials, to within the rounding of the partials to whole bytes a row.
    The per-row loss and the per-slot ``reduced`` and wh^T are not
    counted."""
    form = tm.lstm_ad.KB if family == "lstm_ad" else tm.deepar.KR
    save = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    cfg = tm.make_config(family, {"hidden": hidden, "window": window, "dtype": dtype})
    _, rows = tflush.train_route(form, hidden, window)
    t, b = 3, 4 * rows
    fwd = ttrain.train_buffers(form, save, t, b, window, hidden, "meta", 0)
    bwd = ttrain.train_buffers(form, save, t, b, window, hidden, "meta", 1)
    held = sum(x.numel() * x.element_size() for k, x in {**fwd, **bwd}.items()
               if x is not None and k not in ("per_row", "reduced", "wt"))
    per_row = ttrain.train_bytes_per_row(form, cfg, window)
    assert held <= t * b * per_row < held + t * b
    assert (bwd["wt"] is None) == (tflush.train_route(form, hidden, window)[0] == "block")
    assert tuple(bwd["partials"].shape) == (t, 4, form.n_partials(hidden))


def test_train_chunk_slots_at_main_path_m():
    """The train step's chunk at main path m's planes (32 slots x 8,192
    streams, bf16 saves): LSTM-AD at hidden 128 / window 256 holds 653,965 B
    a row (2,564 B a step x 255 and its share of the partials), 5.36 GB a
    slot, so 7 slots a chunk under the 40 GB budget (5 chunks a step);
    DeepAR at hidden 40 / window 192, 123,824 B a row, 1.01 GB a slot, one
    chunk of 32 slots."""
    from types import SimpleNamespace

    from sitewhere_tpu_torch.parallel.sharded import ShardedScorer

    for family, h, w, per_row, chunk in (("lstm_ad", 128, 256, 653965, 7),
                                         ("deepar", 40, 192, 123824, 32)):
        spec = tm.get_model(family)
        cfg = tm.make_config(family, {"hidden": h, "window": w})
        assert spec.train_bytes_per_row(cfg, w) == per_row
        assert 2564 * 255 < 653965 < 2564 * 255 + 200
        scorer = SimpleNamespace(plain=False, spec=spec, cfg=cfg, window=w, n_slots=32,
                                 max_streams=8192,
                                 TRAIN_SAVE_BYTES=ShardedScorer.TRAIN_SAVE_BYTES)
        assert ShardedScorer.train_chunk_slots(scorer) == chunk
