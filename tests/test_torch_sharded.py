"""Port parity of the scoring flush as a whole: ``ShardedScorer`` of
``sitewhere_tpu_torch`` (plain versions of KW, KS or KD, KH, KG on the CPU)
against the JAX package's ``ShardedScorer`` on one CPU device, fed the same
flushes through ``step_counts`` + ``gather_rows`` and ``step``, for the
LSTM-AD and DeepAR families, plus the host feed path (registry, lane rings,
staging sets).

Window state, ladder sizes and NaN padding are bitwise equal. Scores are
held to the reference's bars (``tests/test_fused_step.py:110``): f32 wire
5e-5, f16 wire 5e-3, bf16 wire 2e-2, and 2e-2 with bf16 compute. The sketch
equals the ``np.histogram`` oracle of ``tests/test_scorehealth.py:84-97``
on the port's own scores. A stream holds at most 3 rows per flush here: the
reference's ``_segment_ranks`` totals (ROADMAP queue 3) mis-scatter bursts
longer than the window, which ``tests/test_torch_windows.py`` covers."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import sitewhere_tpu.models as jm
import sitewhere_tpu.ops.windows as jw
import sitewhere_tpu.parallel.sharded as js
import sitewhere_tpu_torch.models as tm
from sitewhere_tpu.parallel.mesh import MeshManager as JMesh
from sitewhere_tpu_torch.models.common import params_to_numpy
from sitewhere_tpu_torch.parallel.mesh import MeshManager
from sitewhere_tpu_torch.parallel.sharded import (
    ShardedScorer,
    f32_to_bf16_bits,
)
from sitewhere_tpu_torch.pipeline.inference import (
    StreamRegistry,
    _LaneRing,
    _StagingSet,
)

T, B, W, H, STREAMS = 3, 64, 12, 8, 256
# the transformer at a small size: 11 tokens a window
TF_SMALL = {"context": 16, "dim": 32, "depth": 2, "heads": 2}
WIRE_TOL = {"f32": 5e-5, "bf16": 2e-2, "f16": 5e-3}

# tiny tensors: one intra-op thread, so the suite's parallel workers keep
# their cores
torch.set_num_threads(1)


def _pair(wire="f32", dtype="float32", fuse_k=1, family="lstm_ad"):
    """A JAX scorer of model ``family`` on one CPU device and the port's on
    the CPU, sharing the JAX base params (every slot starts from them)."""
    over = {"window": W, "hidden": H, "dtype": dtype}
    if family == "transformer":
        over.update(TF_SMALL)
    jsc = js.ShardedScorer(
        JMesh(tenant=1, data=1, devices=jax.devices()[:1]),
        jm.get_model(family), jm.make_config(family, over),
        slots_per_shard=T, max_streams=STREAMS, window=W,
        wire_dtype=wire, fuse_k=fuse_k,
    )
    base = jax.tree_util.tree_map(np.asarray, jsc._base_params)
    tsc = ShardedScorer(
        MeshManager(device="cpu"), tm.get_model(family),
        tm.make_config(family, over), slots_per_shard=T,
        max_streams=STREAMS, window=W, wire_dtype=wire, fuse_k=fuse_k,
        base_params=base,
    )
    return jsc, tsc


def _fill(rng, ids, vals, counts, pool=STREAMS):
    """Overwrite the front of each lane with rows of 22 streams drawn from
    the first ``pool`` (the rest stays as stale padding from earlier
    flushes, as in reused staging buffers)."""
    for t in range(T):
        k = int(rng.integers(0, B + 1))
        streams = rng.choice(pool, 22, replace=False)
        ids[t, :k] = rng.permutation(np.repeat(streams, 3))[:k]
        vals[t, :k] = rng.normal(size=k)
        counts[t, 0] = k


def _jax_wire(vals, wire):
    return vals.astype({"f32": np.float32, "bf16": ml_dtypes.bfloat16,
                        "f16": np.float16}[wire])


def _port_wire(vals, wire):
    if wire == "bf16":
        return f32_to_bf16_bits(vals)
    return vals.astype({"f32": np.float32, "f16": np.float16}[wire])


def _expected_hist(scorer, s_np, counts):
    bins = np.r_[-np.inf, scorer.sketch_edges, np.inf]
    out = np.zeros((T, 1, len(bins) - 1), np.int64)
    for t in range(T):
        if bool(scorer.active[t]):
            out[t, 0], _ = np.histogram(s_np[t, : counts[t, 0]], bins=bins)
    return out


def _assert_state_equal(tsc, jsc):
    for a, b in zip(tsc.state, jsc.state):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _drive_counts(jsc, tsc, wire, tol, flushes, rng, reset_at=None, pool=STREAMS,
                  expected=None):
    """Feed the same flushes to both scorers and hold them together;
    returns the lowest score seen. ``expected(jsc, ids, counts, fused)``,
    when given, makes the reference's scores of a flush another way than
    its fused step (whose scores are ``fused``; it still runs, and holds
    the window state)."""
    ids = np.zeros((T, B), np.int32)
    vals = np.zeros((T, B), np.float32)
    counts = np.zeros((T, 1), np.int32)
    scored = False
    lowest = np.inf
    for f in range(flushes):
        if f == reset_at:
            jsc.reset_slot(2)
            tsc.reset_slot(2)
            _assert_state_equal(tsc, jsc)
            assert not bool(tsc.active[2])
            got = jax.tree_util.tree_leaves(params_to_numpy(tsc.slot_params(2)))
            want = jax.tree_util.tree_leaves(jsc.slot_params(2))
            assert len(got) == len(want)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, np.asarray(b))
        _fill(rng, ids, vals, counts, pool)
        jst = jsc.stage_inputs(ids.astype(jsc.ids_np_dtype), _jax_wire(vals, wire), counts)
        tst = tsc.stage_inputs(ids.astype(tsc.ids_np_dtype), _port_wire(vals, wire), counts)
        js_s = jsc.step_counts(*jst)
        ts_s = tsc.step_counts(*tst)
        j_np = np.asarray(js_s).astype(np.float32)
        if expected is not None:
            j_np = expected(jsc, ids, counts, j_np)
        t_np = ts_s.numpy_f32()
        assert ts_s.dtype == {"f32": torch.float32, "bf16": torch.bfloat16,
                              "f16": torch.float16}[wire]
        np.testing.assert_allclose(t_np, j_np, rtol=tol, atol=tol)
        _assert_state_equal(tsc, jsc)
        np.testing.assert_array_equal(
            np.asarray(tsc.last_sketch), _expected_hist(tsc, t_np, counts)
        )
        n_rows = int(counts.sum())
        jg = np.asarray(jsc.gather_rows(js_s, jst[2], n_rows)).astype(np.float32)
        tg_h = tsc.gather_rows(ts_s, tst[2], n_rows)
        tg_h.copy_to_host_async()
        tg = tg_h.numpy_f32()
        assert tg.shape == jg.shape
        np.testing.assert_array_equal(np.isnan(tg), np.isnan(jg))
        assert not np.isnan(tg[:n_rows]).any() and np.isnan(tg[n_rows:]).all()
        want = jg[:n_rows] if expected is None else np.concatenate(
            [j_np[t, : counts[t, 0]] for t in range(T)])
        np.testing.assert_allclose(tg[:n_rows], want, rtol=tol, atol=tol)
        scored |= bool(np.any(t_np != 0.0))
        lowest = min(lowest, float(t_np.min()))
    assert scored
    return lowest


@pytest.mark.parametrize("wire", ["f32", "bf16", "f16"])
def test_step_counts_and_gather_match_reference(wire):
    """Chained flushes on partly active slots (slot 1 stays inactive),
    slot 2 recycled by reset_slot half way."""
    jsc, tsc = _pair(wire)
    for s in (0, 2):
        jsc.activate(s)
        tsc.activate(s)
    _drive_counts(jsc, tsc, wire, WIRE_TOL[wire], flushes=6,
                  rng=np.random.default_rng(20), reset_at=3)


@pytest.mark.parametrize(
    "wire, dtype", [("f32", "float32"), ("bf16", "bfloat16"), ("f16", "float32")]
)
def test_deepar_step_counts_and_gather_match_reference(wire, dtype):
    """The DeepAR family (the ``forecasting`` tenant template) through the
    same flush: KW, KD's plain version, KH and KG against the JAX scorer,
    slot 2 recycled half way. Slot 1 takes params whose sigma head bias sits
    near -2, so its NLL scores go negative and the sketch must bin them in
    bin 0 (``searchsorted(side="right")`` below the first edge)."""
    jsc, tsc = _pair(wire, dtype=dtype, family="deepar")
    own = jax.tree_util.tree_map(lambda x: np.array(x, np.float32), jsc._base_params)
    own["sigma"]["b"] -= 2.0
    for s in range(T):
        jsc.activate(s, params=own if s == 1 else None)
        tsc.activate(s, params=own if s == 1 else None)
    tol = max(WIRE_TOL[wire], 2e-2 if dtype == "bfloat16" else 0.0)
    lowest = _drive_counts(jsc, tsc, wire, tol, flushes=5,
                           rng=np.random.default_rng(27), reset_at=3, pool=24)
    assert lowest < 0.0
    assert tsc.flops_per_flush(B) == jsc.flops_per_flush(B)


class _EagerTransformerScores:
    """The reference's transformer scores of a flush, op by op: its
    ``gather_windows`` on its post-update state, its ``score_stacked``
    called eagerly, the flush epilogue (K=1) and the wire cast. Keeps the
    largest gap between them and the fused step's scores of the same
    flush (``gap``)."""

    def __init__(self):
        self.gap = 0.0

    def __call__(self, jsc, ids, counts, fused):
        wins, nvs = [], []
        for t in range(T):
            one = jw.WindowState(*(x[t] for x in jsc.state))
            w, n = jw.gather_windows(one, jnp.asarray(ids[t]))
            wins.append(np.asarray(w))
            nvs.append(np.asarray(n))
        sk = jm.transformer.score_stacked(
            jsc.kernel_params(), jsc.cfg, jnp.asarray(np.stack(wins)),
            jnp.asarray(np.stack(nvs)))[..., 0]
        live = np.asarray(jsc.active)[:, None] & (np.arange(B)[None] < counts)
        wire = _jax_wire(np.zeros(1), jsc.wire_dtype).dtype
        s = np.asarray(jnp.where(jnp.asarray(live), sk, 0.0).astype(wire)).astype(np.float32)
        self.gap = max(self.gap, float(np.abs(s - fused).max()))
        return s


@pytest.mark.parametrize("wire, dtype", [("f32", "float32"), ("bf16", "float32"),
                                         ("bf16", "bfloat16")])
def test_transformer_step_counts_and_gather_match_reference(wire, dtype):
    """The transformer family through the same flush: KW, the plain
    versions of KE/KL/KA/KU/KN (the port's flush form on the CPU), KH and
    KG against the JAX scorer, slot 1 with its own params (written through
    ``activate`` into the nested tree: a raw ``pos`` table and a ``blocks``
    list), slot 2 recycled half way. With f32 compute the scores are held
    to the reference's fused step. With bf16 compute they are held to the
    reference's ``score_stacked`` run op by op on the fused step's own
    windows (``_EagerTransformerScores``): the reference's jitted step and
    its op-by-op ``score_stacked`` differ from each other past the bar
    (ROADMAP queue 3; measured here: up to 1.5 over these five
    flushes), while the port holds to the op-by-op form within it."""
    jsc, tsc = _pair(wire, dtype=dtype, family="transformer")
    rng = np.random.default_rng(28)
    own = jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + rng.normal(scale=0.05, size=x.shape)).astype(np.float32),
        jsc._base_params,
    )
    for s in range(T):
        jsc.activate(s, params=own if s == 1 else None)
        tsc.activate(s, params=own if s == 1 else None)
    got = jax.tree_util.tree_leaves(params_to_numpy(tsc.slot_params(1)))
    for a, b in zip(got, jax.tree_util.tree_leaves(own)):
        np.testing.assert_array_equal(a, b)
    tol = max(WIRE_TOL[wire], 2e-2 if dtype == "bfloat16" else 2e-4)
    eager = _EagerTransformerScores() if dtype == "bfloat16" else None
    _drive_counts(jsc, tsc, wire, tol, flushes=5, rng=np.random.default_rng(29),
                  reset_at=3, pool=24, expected=eager)
    if eager is not None:  # the reference's own jit vs op-by-op gap (queue 3)
        print(f"reference jit vs op-by-op gap, {wire} wire: {eager.gap}")
    assert tsc.flops_per_flush(B) == jsc.flops_per_flush(B)


def test_transformer_slot_round_trip_and_recycled_slot_scores_fresh():
    """``activate(slot, params=tree)``, ``slot_params`` and ``reset_slot`` on
    the transformer's nested tree (dicts, a list of blocks, raw leaves):
    the tree written comes back unchanged, and a recycled slot scores
    bitwise as the same slot of a scorer that never served the old
    tenant."""
    over = {"window": W, "dtype": "float32", **TF_SMALL}
    spec, cfg = tm.get_model("transformer"), tm.make_config("transformer", over)
    mk = lambda: ShardedScorer(  # noqa: E731
        MeshManager(device="cpu"), spec, cfg, slots_per_shard=T,
        max_streams=STREAMS, window=W, seed=3,
    )
    used, fresh = mk(), mk()
    tree = spec.init(torch.Generator().manual_seed(9), cfg, device="cpu")
    used.activate(0, params=params_to_numpy(tree))
    back = used.slot_params(0)
    for a, b in zip(jax.tree_util.tree_leaves(params_to_numpy(back)),
                    jax.tree_util.tree_leaves(params_to_numpy(tree))):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(30)
    ids = np.zeros((T, B), np.int32)
    vals = np.zeros((T, B), np.float32)
    counts = np.zeros((T, 1), np.int32)
    for _ in range(3):
        _fill(rng, ids, vals, counts, pool=24)
        used.step_counts(ids, vals, counts)
    used.reset_slot(0)
    assert torch.equal(used.slot_params(0)["blocks"][1]["mlp"]["fc2"]["w"],
                       fresh.slot_params(0)["blocks"][1]["mlp"]["fc2"]["w"])
    for sc in (used, fresh):
        sc.activate(0)
    for _ in range(4):
        _fill(rng, ids, vals, counts, pool=24)
        su = np.asarray(used.step_counts(ids, vals, counts))
        sf = np.asarray(fresh.step_counts(ids, vals, counts))
        np.testing.assert_array_equal(su[0], sf[0])
    assert np.any(su[0] != 0.0)
    for a, b in zip(used.state, fresh.state):
        assert torch.equal(a[0], b[0])


def test_bf16_compute_and_per_slot_params_match_reference():
    jsc, tsc = _pair("f32", dtype="bfloat16")
    rng = np.random.default_rng(21)
    own = jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + rng.normal(scale=0.05, size=x.shape)).astype(np.float32),
        jsc._base_params,
    )
    for s in range(T):
        jsc.activate(s, params=own if s == 1 else None)
        tsc.activate(s, params=own if s == 1 else None)
    np.testing.assert_array_equal(tsc.slot_params(1)["wh"]["w"].numpy(), own["wh"]["w"])
    _drive_counts(jsc, tsc, "f32", 2e-2, flushes=4, rng=np.random.default_rng(22))
    assert tsc.flops_per_flush(B) == jsc.flops_per_flush(B)
    assert tsc.gather_ladder(B) == jsc.gather_ladder(B)


def test_step_mask_mode_matches_reference():
    jsc, tsc = _pair("bf16")  # mask mode scores stay f32 whatever the wire
    for s in range(T):
        jsc.activate(s)
        tsc.activate(s)
    rng = np.random.default_rng(23)
    for _ in range(4):
        ids = rng.integers(0, 40, (T, B)).astype(np.int32)
        vals = rng.normal(size=(T, B)).astype(np.float32)
        valid = rng.random((T, B)) > 0.3
        j = np.asarray(jsc.step(ids, vals, valid))
        t = tsc.step(ids, vals, valid)
        assert t.dtype == torch.float32
        np.testing.assert_allclose(np.asarray(t), j, rtol=5e-5, atol=5e-5)
        _assert_state_equal(tsc, jsc)


def test_fuse_k_resolves_each_row_at_its_own_position():
    """fuse_k=3: a row with ``later`` same-stream rows after it in the
    flush takes column K-1-later of score_stacked over its window."""
    _, tsc = _pair("f32", fuse_k=3)
    tsc.activate(0)
    rng = np.random.default_rng(24)
    ids = np.zeros((T, B), np.int32)
    vals = np.zeros((T, B), np.float32)
    counts = np.zeros((T, 1), np.int32)
    for _ in range(3):
        _fill(rng, ids, vals, counts)
        s = np.asarray(tsc.step_counts(ids, vals, counts))
    k = int(counts[0, 0])
    row_ids = ids[0, :k]
    from sitewhere_tpu_torch.ops.windows import WindowState, gather_windows
    one = WindowState(tsc.state.values[0], tsc.state.pos[0], tsc.state.count[0])
    wins, n = gather_windows(one, torch.from_numpy(row_ids))
    params = {l: {x: v[:1] for x, v in node.items()} for l, node in tsc.params.items()}
    sk = tm.lstm_ad.score_stacked(params, tsc.cfg, wins[None], n[None], k=3)[0].numpy()
    for b in range(k):
        later = int(np.sum(row_ids[b + 1:] == row_ids[b]))
        assert s[0, b] == sk[b, max(0, 2 - later)]


def test_feed_path_resolves_every_row_once():
    """Registry -> lane rings -> rotating staging sets -> stage ->
    step_counts -> gather_rows -> async copy: every fed row resolves
    exactly once, in pack order, with the scores a direct step of the same
    buffers gives; the bf16 slice write equals ml_dtypes' cast."""
    over = {"window": W, "hidden": H, "dtype": "float32"}
    mk = lambda: ShardedScorer(  # noqa: E731
        MeshManager(device="cpu"), tm.get_model("lstm_ad"),
        tm.make_config("lstm_ad", over), slots_per_shard=T,
        max_streams=STREAMS, window=W, wire_dtype="bf16",
    )
    scorer, twin = mk(), mk()
    for s in range(T):
        scorer.activate(s)
        twin.activate(s)
    regs = [StreamRegistry(1, STREAMS) for _ in range(T)]
    lanes = {(t, 0): _LaneRing(64) for t in range(T)}
    sets = [_StagingSet(scorer, B), _StagingSet(scorer, B)]
    rng = np.random.default_rng(25)
    fed, resolved = set(), []
    for flush in range(5):
        for t in range(T):
            n = int(rng.integers(1, 90))
            devs = rng.zipf(1.5, n) % 60
            ids = np.array([regs[t].lookup_or_assign(f"d{d}", "temp")[1] for d in devs], np.int32)
            vals = rng.normal(size=n).astype(np.float32)
            lanes[(t, 0)].push(ids, vals, flush * 10 + t, np.arange(n, dtype=np.int32))
            fed.update((flush * 10 + t, r) for r in range(n))
        st = sets[flush % 2]
        st.ensure_reusable()
        st.counts[:] = 0
        take = sum(min(l.count, B) for l in lanes.values())
        seqs = np.empty((take,), np.int64)
        rows = np.empty((take,), np.int32)
        moved = 0
        for (slot, d), lane in sorted(lanes.items()):
            k = min(lane.count, B)
            vals_before = lane.vals[lane.head:lane.head + k].copy() if lane.head + k <= lane.capacity else None
            lane.pop_into(k, st.ids[slot], st.vals[slot], 0, seqs, rows, moved)
            if vals_before is not None:
                np.testing.assert_array_equal(
                    st.vals[slot, :k], vals_before.astype(ml_dtypes.bfloat16).view(np.uint16)
                )
            st.counts[slot, d] = k
            moved += k
        st.staged = scorer.stage_inputs(st.ids, st.vals, st.counts)
        scores = scorer.step_counts(*st.staged)
        g = scorer.gather_rows(scores, st.staged[2], moved)
        g.copy_to_host_async()
        direct = twin.step_counts(st.ids.copy(), st.vals.copy(), st.counts.copy())
        want = np.concatenate([direct.numpy_f32()[t, : st.counts[t, 0]] for t in range(T)])
        got = g.numpy_f32()
        np.testing.assert_array_equal(got[:moved], want)
        assert np.isnan(got[moved:]).all()
        resolved.extend(zip(seqs.tolist(), rows.tolist()))
    while any(l.count for l in lanes.values()):
        for lane in lanes.values():
            _i, _v, seqs, rows = lane.pop(lane.count)
            resolved.extend(zip(seqs.tolist(), rows.tolist()))
    assert len(resolved) == len(set(resolved)) == len(fed)
    assert set(resolved) == fed
    assert regs[0].n_streams <= 60


def test_prewarm_and_construction_rules():
    _, tsc = _pair("f16")
    before = [x.clone() for x in tsc.state]
    tsc.prewarm([B, 16])
    assert all(torch.equal(a, b) for a, b in zip(before, tsc.state))
    assert tsc.ids_np_dtype == np.uint16 and tsc.vals_np_dtype == np.float16
    assert tsc.device_label == "cpu:0"
    spec, cfg = tm.get_model("lstm_ad"), tm.make_config("lstm_ad", {})
    cpu = MeshManager(device="cpu")
    for bad in ({"wire_dtype": "f8"}, {"param_dtype": "f64"}, {"fuse_k": 0}):
        with pytest.raises(ValueError):
            ShardedScorer(cpu, spec, cfg, **bad)
